// K3, K4, K6a and K6b: per-voxel damped SPD solve and inverse diagonal.
//
// K3 replaces xmris_tpu/ops/kernels/spd.py::spd_solve_damped_pallas_slab
// (_spd_solve_kernel, _chol_cols_slab): A_kk += lam*max(A_kk, 1e-12) + 1e-12
// on the diagonal only, Cholesky-Crout in outer-product form, then forward
// and back substitution.  K4 replaces spd_inverse_diag_pallas_slab
// (_spd_inv_diag_kernel): a Tikhonov term on the diagonal, Cholesky, and
// diag(A^-1)_c = sum_i (L^-1)_ic^2 by one forward substitution per column.
// K6a replaces spd_solve_damped_pallas and K6b spd_inverse_diag_pallas: the
// K3 and K4 bodies on dense row-major (B, F, F) input (the non-slab LM's
// step; fit_amares's CRLB adds its 1e-12 ridge before the K6b call).
// A non-positive pivot makes it NaN, which spreads to the whole output row,
// as in the reference (the LM reads a NaN step as a rejected one).
//
// What bounds them on the H100: each reads the Hessians once (26 MB per
// bench grid of 16 384 voxels at F = 20, ~8 us at 3.35 TB/s) and does
// ~F^3/3 = 2.7 kFLOP per voxel, sequentially dependent.  Design: one thread
// per voxel.  K3/K4 read the voxel-minor (F*F, B) slab, so every load is
// coalesced across a warp.  K6a/K6b's row-major matrices are 1.6 KB apart,
// so a block of 32 voxels first copies its contiguous 51 KB tile into shared
// memory with coalesced loads (row pitch F*F | 1, an odd number of words,
// so the per-thread reads hit 32 distinct banks), then factors from there.
// Every kernel reads A[j][i] for i >= j through the same `load_and_factor`
// and solves through the same `solve_with_factor`, so K6a equals K3, and
// K6b K4, bit for bit on the same matrices.
// The packed lower triangle (F(F+1)/2 floats) lives in thread-local memory
// (it spills out of registers at F = 20; L1 keeps it close).
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn, no fused multiply-add) in the order of the plain PyTorch
// version, so the two agree to the last bits on the card.

#include <cuda_runtime.h>
#include <math.h>

#include "spd_factor.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxF = 32;
constexpr int kDenseVoxels = 32;  // K6a/K6b voxels (threads) per block

// Loads A (upper triangle, row-major rows A[k][i] for i >= k, which is
// column k by symmetry; `load(k * f + i)` reads it) into packed-lower L,
// adds `diag_add(a)` to the diagonal, and factors in place.  L(i, j),
// i >= j, ends as the Cholesky factor.
template <typename Load, typename DiagAdd>
__device__ __forceinline__ void load_and_factor(int f, float* L, Load load,
                                                DiagAdd diag_add) {
    for (int j = 0; j < f; ++j) {
        for (int i = j; i < f; ++i) {
            float a = load(j * f + i);
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

// diag(A^-1) from the factor: column c of L^-1 is x_i = (delta_ic -
// sum_{c<=j<i} L_ij x_j) / L_ii, and out_c = sum_i x_i^2.
__device__ __forceinline__ void inverse_diag_from_factor(const float* L, int f,
                                                         float* out) {
    float x[kMaxF];
    for (int c = 0; c < f; ++c) {
        float acc_sq = 0.f;
        for (int i = c; i < f; ++i) {
            float acc = (i == c) ? 1.f : 0.f;
            for (int j = c; j < i; ++j)
                acc = __fsub_rn(acc, __fmul_rn(L[tri(i, j)], x[j]));
            x[i] = __fdiv_rn(acc, L[tri(i, i)]);
            acc_sq = __fadd_rn(acc_sq, __fmul_rn(x[i], x[i]));
        }
        out[c] = acc_sq;
    }
}

// Coalesced copy of a block's contiguous (n_vox, F, F) tile of dense
// row-major matrices into shared memory at row pitch F*F | 1; returns the
// block's voxel count.
__device__ __forceinline__ int stage_dense_tile(const float* __restrict__ h,
                                                float* tile, long long v0,
                                                int b, int f) {
    const int ff = f * f;
    const int pitch = ff | 1;
    const int n_vox = min(kDenseVoxels, (int)(b - v0));
    for (int k = threadIdx.x; k < n_vox * ff; k += blockDim.x)
        tile[(k / ff) * pitch + k % ff] = h[v0 * ff + k];
    __syncthreads();
    return n_vox;
}

__global__ void __launch_bounds__(kThreads) spd_solve_damped_kernel(
    const float* __restrict__ h, const float* __restrict__ g,
    const float* __restrict__ lam, float* __restrict__ out, int b, int f) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= b) return;
    float L[kMaxF * (kMaxF + 1) / 2];
    float y[kMaxF];
    const float lv = lam[v];
    auto load = [h, b, v](int k) { return h[(long long)k * b + v]; };
    load_and_factor(f, L, load, [lv](float a) { return damp(a, lv); });
    solve_with_factor(
        L, f, [g, v, f](int i) { return g[(long long)v * f + i]; }, y);
    for (int i = 0; i < f; ++i) out[(long long)v * f + i] = y[i];
}

__global__ void __launch_bounds__(kDenseVoxels) spd_solve_damped_dense_kernel(
    const float* __restrict__ h, const float* __restrict__ g,
    const float* __restrict__ lam, float* __restrict__ out, int b, int f) {
    extern __shared__ float tile[];
    const long long v0 = (long long)blockIdx.x * kDenseVoxels;
    const int n_vox = stage_dense_tile(h, tile, v0, b, f);
    if ((int)threadIdx.x >= n_vox) return;
    const long long v = v0 + threadIdx.x;
    const float* a = tile + threadIdx.x * ((f * f) | 1);
    float L[kMaxF * (kMaxF + 1) / 2];
    float y[kMaxF];
    const float lv = lam[v];
    load_and_factor(f, L, [a](int k) { return a[k]; },
                    [lv](float x) { return damp(x, lv); });
    solve_with_factor(L, f, [g, v, f](int i) { return g[v * f + i]; }, y);
    for (int i = 0; i < f; ++i) out[v * f + i] = y[i];
}

__global__ void __launch_bounds__(kThreads) spd_inverse_diag_kernel(
    const float* __restrict__ h, float* __restrict__ out, int b, int f,
    float tikhonov) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= b) return;
    float L[kMaxF * (kMaxF + 1) / 2];
    auto load = [h, b, v](int k) { return h[(long long)k * b + v]; };
    load_and_factor(f, L, load,
                    [tikhonov](float a) { return __fadd_rn(a, tikhonov); });
    inverse_diag_from_factor(L, f, out + (long long)v * f);
}

__global__ void __launch_bounds__(kDenseVoxels) spd_inverse_diag_dense_kernel(
    const float* __restrict__ h, float* __restrict__ out, int b, int f) {
    extern __shared__ float tile[];
    const long long v0 = (long long)blockIdx.x * kDenseVoxels;
    const int n_vox = stage_dense_tile(h, tile, v0, b, f);
    if ((int)threadIdx.x >= n_vox) return;
    const float* a = tile + threadIdx.x * ((f * f) | 1);
    float L[kMaxF * (kMaxF + 1) / 2];
    load_and_factor(f, L, [a](int k) { return a[k]; },
                    [](float x) { return x; });
    inverse_diag_from_factor(L, f, out + (v0 + threadIdx.x) * f);
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

// Dynamic shared memory of a dense kernel's tile; raises the kernel's limit
// above the 48 KB default where needed.
template <typename Kernel>
static cudaError_t dense_tile_smem(Kernel kernel, int f, int* smem) {
    *smem = kDenseVoxels * ((f * f) | 1) * (int)sizeof(float);
    if (*smem > 48 * 1024)
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    return cudaSuccess;
}

extern "C" int xmt_spd_solve_damped_dense(const float* h, const float* g,
                                          const float* lam, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        int smem = 0;
        const cudaError_t e =
            dense_tile_smem(spd_solve_damped_dense_kernel, f, &smem);
        if (e != cudaSuccess) return (int)e;
        const int blocks = (b + kDenseVoxels - 1) / kDenseVoxels;
        spd_solve_damped_dense_kernel<<<blocks, kDenseVoxels, smem,
                                        (cudaStream_t)stream>>>(h, g, lam, out,
                                                                b, f);
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_inverse_diag_dense(const float* h, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        int smem = 0;
        const cudaError_t e =
            dense_tile_smem(spd_inverse_diag_dense_kernel, f, &smem);
        if (e != cudaSuccess) return (int)e;
        const int blocks = (b + kDenseVoxels - 1) / kDenseVoxels;
        spd_inverse_diag_dense_kernel<<<blocks, kDenseVoxels, smem,
                                        (cudaStream_t)stream>>>(h, out, b, f);
    }
    return (int)cudaGetLastError();
}
