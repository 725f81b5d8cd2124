// K3 and K4: per-voxel damped SPD solve and inverse diagonal on the slab.
//
// K3 replaces xmris_tpu/ops/kernels/spd.py::spd_solve_damped_pallas_slab
// (_spd_solve_kernel, _chol_cols_slab): A_kk += lam*max(A_kk, 1e-12) + 1e-12
// on the diagonal only, Cholesky-Crout in outer-product form, then forward
// and back substitution.  K4 replaces spd_inverse_diag_pallas_slab
// (_spd_inv_diag_kernel): a Tikhonov term on the diagonal, Cholesky, and
// diag(A^-1)_c = sum_i (L^-1)_ic^2 by one forward substitution per column.
// A non-positive pivot makes it NaN, which spreads to the whole output row,
// as in the reference (the LM reads a NaN step as a rejected one).
//
// What bounds it on the H100: each reads the (F*F, B) Hessian slab once
// (26 MB per bench grid, ~8 us at 3.35 TB/s) and does ~F^3/3 = 2.7 kFLOP
// per voxel, sequentially dependent.  Design: one thread per voxel; the
// voxel-minor slab makes every load coalesced across a warp; the packed
// lower triangle (F(F+1)/2 floats) lives in thread-local memory (it spills
// out of registers at F = 20; L1 keeps it close).
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn, no fused multiply-add) in the order of the plain PyTorch
// version, so the two agree to the last bits on the card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxF = 32;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Loads A (upper triangle, row-major rows A[k][i] for i >= k, which is
// column k by symmetry) into packed-lower L, adds `diag_add(a)` to the
// diagonal, and factors in place.  L(i, j), i >= j, ends as the Cholesky
// factor.
template <typename DiagAdd>
__device__ __forceinline__ void load_and_factor(
    const float* __restrict__ h, int b, int v, int f, float* L,
    DiagAdd diag_add) {
    for (int j = 0; j < f; ++j) {
        for (int i = j; i < f; ++i) {
            float a = h[(long long)(j * f + i) * b + v];
            if (i == j) a = diag_add(a);
            L[tri(i, j)] = a;
        }
    }
    for (int k = 0; k < f; ++k) {
        float dk = L[tri(k, k)];
        dk = dk > 0.f ? dk : NAN;
        // 1/sqrt with both steps correctly rounded (rsqrtf is approximate).
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(dk));
        for (int i = k; i < f; ++i) L[tri(i, k)] = __fmul_rn(L[tri(i, k)], inv);
        for (int j = k + 1; j < f; ++j) {
            const float ljk = L[tri(j, k)];
            for (int i = j; i < f; ++i)
                L[tri(i, j)] =
                    __fsub_rn(L[tri(i, j)], __fmul_rn(L[tri(i, k)], ljk));
        }
    }
}

__global__ void __launch_bounds__(kThreads) spd_solve_damped_kernel(
    const float* __restrict__ h, const float* __restrict__ g,
    const float* __restrict__ lam, float* __restrict__ out, int b, int f) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= b) return;
    float L[kMaxF * (kMaxF + 1) / 2];
    float y[kMaxF];
    const float lv = lam[v];
    load_and_factor(h, b, v, f, L, [lv](float a) {
        return __fadd_rn(__fadd_rn(a, __fmul_rn(lv, fmaxf(a, 1e-12f))),
                         1e-12f);
    });
    // Forward substitution L y = g.
    for (int i = 0; i < f; ++i) {
        float acc = g[(long long)v * f + i];
        for (int j = 0; j < i; ++j)
            acc = __fsub_rn(acc, __fmul_rn(L[tri(i, j)], y[j]));
        y[i] = __fdiv_rn(acc, L[tri(i, i)]);
    }
    // Back substitution L^T x = y (x overwrites y from the end).
    for (int i = f - 1; i >= 0; --i) {
        float acc = y[i];
        for (int j = i + 1; j < f; ++j)
            acc = __fsub_rn(acc, __fmul_rn(L[tri(j, i)], y[j]));
        y[i] = __fdiv_rn(acc, L[tri(i, i)]);
    }
    for (int i = 0; i < f; ++i) out[(long long)v * f + i] = y[i];
}

__global__ void __launch_bounds__(kThreads) spd_inverse_diag_kernel(
    const float* __restrict__ h, float* __restrict__ out, int b, int f,
    float tikhonov) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= b) return;
    float L[kMaxF * (kMaxF + 1) / 2];
    float x[kMaxF];
    load_and_factor(h, b, v, f, L,
                    [tikhonov](float a) { return __fadd_rn(a, tikhonov); });
    // Column c of L^-1: x_i = (delta_ic - sum_{c<=j<i} L_ij x_j) / L_ii.
    for (int c = 0; c < f; ++c) {
        float acc_sq = 0.f;
        for (int i = c; i < f; ++i) {
            float acc = (i == c) ? 1.f : 0.f;
            for (int j = c; j < i; ++j)
                acc = __fsub_rn(acc, __fmul_rn(L[tri(i, j)], x[j]));
            x[i] = __fdiv_rn(acc, L[tri(i, i)]);
            acc_sq = __fadd_rn(acc_sq, __fmul_rn(x[i], x[i]));
        }
        out[(long long)v * f + c] = acc_sq;
    }
}

}  // namespace

extern "C" int xmt_spd_solve_damped(const float* h, const float* g,
                                    const float* lam, float* out, int b, int f,
                                    void* stream) {
    if (b > 0) {
        const int blocks = (b + kThreads - 1) / kThreads;
        spd_solve_damped_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            h, g, lam, out, b, f);
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_inverse_diag(const float* h, float* out, int b, int f,
                                    float tikhonov, void* stream) {
    if (b > 0) {
        const int blocks = (b + kThreads - 1) / kThreads;
        spd_inverse_diag_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            h, out, b, f, tikhonov);
    }
    return (int)cudaGetLastError();
}
