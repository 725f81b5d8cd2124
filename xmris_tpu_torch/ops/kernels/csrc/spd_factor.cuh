// Pieces of the damped SPD solve (K3, K6a) shared with the whole-loop LM
// kernel K8, so that all of them run the same arithmetic in the same order:
// packed-lower indexing, the LM damping of a diagonal entry, and the two
// triangular substitutions.  Every product and sum is rounded on its own
// (no fused multiply-add), as in the plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// The LM damping of a diagonal entry: a + lam*max(a, 1e-12) + 1e-12.
__device__ __forceinline__ float damp(float a, float lam) {
    return __fadd_rn(__fadd_rn(a, __fmul_rn(lam, fmaxf(a, 1e-12f))), 1e-12f);
}

// Forward substitution L y = g (`rhs(i)` reads g_i), then back substitution
// L^T x = y; x overwrites y from the end.
template <typename Rhs>
__device__ __forceinline__ void solve_with_factor(const float* L, int f,
                                                  Rhs rhs, float* y) {
    for (int i = 0; i < f; ++i) {
        float acc = rhs(i);
        for (int j = 0; j < i; ++j)
            acc = __fsub_rn(acc, __fmul_rn(L[tri(i, j)], y[j]));
        y[i] = __fdiv_rn(acc, L[tri(i, i)]);
    }
    for (int i = f - 1; i >= 0; --i) {
        float acc = y[i];
        for (int j = i + 1; j < f; ++j)
            acc = __fsub_rn(acc, __fmul_rn(L[tri(j, i)], y[j]));
        y[i] = __fdiv_rn(acc, L[tri(i, i)]);
    }
}

}  // namespace
