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
// ~F^3/3 = 2.7 kFLOP per voxel, sequentially dependent.
// K3/K4: one thread per voxel on the voxel-minor (F*F, B) slab, so every
// load is coalesced across a warp; the packed lower triangle (F(F+1)/2
// floats) lives in thread-local memory (it spills out of registers at
// F = 20; L1 keeps it close).
// K6a/K6b: one warp per voxel, 8 voxels a block, no shared memory.  A
// thread per voxel gave 16 384 threads, 512 warps: ~4 an SM, each thread's
// factor serial in local memory (the design this replaced also staged a
// block's 51 KB tile in shared memory, which likely took most of L1 from
// that local memory: K6a/K6b 0.45 / 0.53 ms on an H100 against 0.14 / 0.17
// without the tile, scripts/ablate_spd.py).  Here lane i loads column i of row j (the upper
// triangle, j <= i), contiguous across the lanes, and holds row i of the
// Cholesky factor in registers (spd_factor.cuh's warp factor and
// substitutions, as K8 runs them, unrolled over F rounded up to a multiple
// of 4); each column step is a few shuffles, and 16 384 warps fill the
// card.  K6b then forms column c of L^-1 in lane c (warp_inverse_diag):
// every lane divides at once, where a lane per row of L^-1 left each
// row's divisions to one lane (2.2x slower, and 72 registers with spills).
// Every kernel reads A[j][i] for i >= j and factors, substitutes and forms
// the inverse diagonal in the same sequence of correctly rounded operations
// (K3's and K4's order), so K6a equals K3, and K6b K4, bit for bit on the
// same matrices.
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
constexpr int kWarpVoxels = 8;  // K6a/K6b voxels (warps) per block

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

// diag(A^-1) from the warp factor in K4's order (inverse_diag_from_factor):
// lane c forms column c of X = L^-1, x[i] = X(i, c) = (delta_ic -
// sum_{j=c}^{i-1} L(i, j) X(j, c)) / L(i, i), each L(i, j) and L(i, i)
// broadcast from lane i, and adds X(i, c)^2 to its sum for i = c..n-1 in
// ascending i from 0.  Every lane divides at once (kF divisions a lane).
// Rows n..kF-1 are padding: they come after every real row and are not
// summed, so they add nothing to a real column.  Returns lane c's out_c.
template <int kF>
__device__ __forceinline__ float warp_inverse_diag(const float (&a)[kF],
                                                   int n) {
    const int lane = threadIdx.x & 31;
    float x[kF];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
        float acc = (i == lane) ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < i; ++j) {
            const float lij = __shfl_sync(kFull, a[j], i);
            if (j >= lane) acc = __fsub_rn(acc, __fmul_rn(lij, x[j]));
        }
        x[i] = __fdiv_rn(acc, __shfl_sync(kFull, a[i], i));
        if (i >= lane && i < n) sum = __fadd_rn(sum, __fmul_rn(x[i], x[i]));
    }
    return sum;
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

// K6a: one warp per voxel, the damped factor and both substitutions; a
// warp past the last voxel returns.
template <int kF>
__global__ void __launch_bounds__(32 * kWarpVoxels)
    spd_solve_damped_dense_kernel(const float* __restrict__ h,
                                  const float* __restrict__ g,
                                  const float* __restrict__ lam,
                                  float* __restrict__ out, int b, int f) {
    const long long v = (long long)blockIdx.x * kWarpVoxels + threadIdx.x / 32;
    if (v >= b) return;
    const int lane = threadIdx.x & 31;
    const float* hv = h + v * f * f;
    const float lv = lam[v];
    float a[kF];
    warp_factor<kF>(f, [hv, f](int j, int i) { return hv[j * f + i]; },
                    [lv](float x) { return damp(x, lv); }, a);
    const float rhs = lane < f ? g[v * f + lane] : 0.f;
    const float x = warp_back<kF>(a, warp_forward<kF>(a, rhs), f);
    if (lane < f) out[v * f + lane] = x;
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

// K6b: one warp per voxel, the factor without damping, then the inverse
// diagonal; a warp past the last voxel returns.
template <int kF>
__global__ void __launch_bounds__(32 * kWarpVoxels)
    spd_inverse_diag_dense_kernel(const float* __restrict__ h,
                                  float* __restrict__ out, int b, int f) {
    const long long v = (long long)blockIdx.x * kWarpVoxels + threadIdx.x / 32;
    if (v >= b) return;
    const int lane = threadIdx.x & 31;
    const float* hv = h + v * f * f;
    float a[kF];
    warp_factor<kF>(f, [hv, f](int j, int i) { return hv[j * f + i]; },
                    [](float x) { return x; }, a);
    const float d = warp_inverse_diag<kF>(a, f);
    if (lane < f) out[v * f + lane] = d;
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

extern "C" int xmt_spd_solve_damped_dense(const float* h, const float* g,
                                          const float* lam, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        const int blocks = (b + kWarpVoxels - 1) / kWarpVoxels;
        XMT_WARP_ROWS(f, spd_solve_damped_dense_kernel<kF>
                      <<<blocks, 32 * kWarpVoxels, 0, (cudaStream_t)stream>>>(
                          h, g, lam, out, b, f))
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_inverse_diag_dense(const float* h, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        const int blocks = (b + kWarpVoxels - 1) / kWarpVoxels;
        XMT_WARP_ROWS(f, spd_inverse_diag_dense_kernel<kF>
                      <<<blocks, 32 * kWarpVoxels, 0, (cudaStream_t)stream>>>(
                          h, out, b, f))
    }
    return (int)cudaGetLastError();
}
