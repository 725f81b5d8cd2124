// Pieces of the damped SPD solve shared by K3, K4, K6a, K6b and the
// whole-loop LM kernel K8, so that all of them run the same arithmetic in
// the same order: the LM damping of a diagonal entry, and the warp factor
// and substitutions (one warp per matrix, the factor in registers).  Every
// product and sum is rounded on its own (no fused multiply-add), as in the
// plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The LM damping of a diagonal entry: a + lam*max(a, 1e-12) + 1e-12.
__device__ __forceinline__ float damp(float a, float lam) {
    return __fadd_rn(__fadd_rn(a, __fmul_rn(lam, fmaxf(a, 1e-12f))), 1e-12f);
}

// ---------------------------------------------------------------------------
// The warp factor: one warp per matrix, lane i holds row i of the Cholesky
// factor in registers, a[j] = L(i, j) for j <= i.  Every loop runs kF trips,
// the row count n (<= 32) rounded up to a multiple of 4, with no branch, so
// the independent shuffles of a column issue together.  Rows n..kF-1 are
// padding, the identity with a zero right-hand side: no lane of a real row
// ever reads a padding lane's value except through a product that is an
// exact +0 (warp_back), so every operation on the first n rows is the
// plain version's, in its order (the factor column by column, each
// substitution in the serial order of a single thread).  Call them through
// XMT_WARP_ROWS.
// ---------------------------------------------------------------------------

// Runs STMT with `constexpr int kF` = n rounded up to a multiple of 4, for
// 1 <= n <= 32.
#define XMT_WARP_ROWS(n, ...)                                   \
    switch (((n) + 3) / 4) {                                    \
        case 1: { constexpr int kF = 4; __VA_ARGS__; } break;   \
        case 2: { constexpr int kF = 8; __VA_ARGS__; } break;   \
        case 3: { constexpr int kF = 12; __VA_ARGS__; } break;  \
        case 4: { constexpr int kF = 16; __VA_ARGS__; } break;  \
        case 5: { constexpr int kF = 20; __VA_ARGS__; } break;  \
        case 6: { constexpr int kF = 24; __VA_ARGS__; } break;  \
        case 7: { constexpr int kF = 28; __VA_ARGS__; } break;  \
        case 8: { constexpr int kF = 32; __VA_ARGS__; } break;  \
    }

// Loads row `lane` of the symmetric n x n matrix (`load(j, i)` reads A[j][i],
// j <= i: the upper triangle, column i by symmetry), maps its diagonal entry
// by `diag`, and factors in place: column k scaled by 1/sqrt(pivot) (both
// steps correctly rounded; a non-positive pivot gives NaN), then the
// outer-product update of the trailing columns.
template <int kF, typename Load, typename Diag>
__device__ __forceinline__ void warp_factor(int n, Load load, Diag diag,
                                            float (&a)[kF]) {
    const int lane = threadIdx.x & 31;
    const bool real = lane < n;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        const float x = (j <= lane && real) ? load(j, lane) : 0.f;
        a[j] = (j == lane) ? (real ? diag(x) : 1.f) : x;
    }
#pragma unroll
    for (int k = 0; k < kF; ++k) {
        float dk = __shfl_sync(kFull, a[k], k);
        dk = dk > 0.f ? dk : NAN;
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(dk));
        if (lane >= k) a[k] = __fmul_rn(a[k], inv);
#pragma unroll
        for (int j = k + 1; j < kF; ++j) {
            const float ljk = __shfl_sync(kFull, a[k], j);
            if (lane >= j) a[j] = __fsub_rn(a[j], __fmul_rn(a[k], ljk));
        }
    }
}

// Forward substitution L y = b by columns (`b` is lane i's b_i, 0 on a
// padding lane): y_i takes its subtractions j = 0..i-1 in order.  Returns
// lane i's y_i.
template <int kF>
__device__ __forceinline__ float warp_forward(const float (&a)[kF], float b) {
    const int lane = threadIdx.x & 31;
    float acc = b, y = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        if (lane == j) y = __fdiv_rn(acc, a[j]);
        const float yj = __shfl_sync(kFull, y, j);
        if (lane > j) acc = __fsub_rn(acc, __fmul_rn(a[j], yj));
    }
    return y;
}

// Back substitution L^T x = y in the serial order: lane j > i forms
// L(j, i) x_j, lane i subtracts them for j = i+1, i+2, ...  A padding lane
// forms +0, which leaves every difference as it is (also -0, inf and NaN).
// Returns lane i's x_i.
template <int kF>
__device__ __forceinline__ float warp_back(const float (&a)[kF], float y,
                                           int n) {
    const int lane = threadIdx.x & 31;
    const bool real = lane < n;
    float x = 0.f;
#pragma unroll
    for (int i = kF - 1; i >= 0; --i) {
        const float p = real ? __fmul_rn(a[i], x) : 0.f;
        float acc = y;
#pragma unroll
        for (int j = i + 1; j < kF; ++j)
            acc = __fsub_rn(acc, __shfl_sync(kFull, p, j));
        if (lane == i) x = __fdiv_rn(acc, a[i]);
    }
    return x;
}

}  // namespace
