// K8: the whole bounded Levenberg-Marquardt fit of a voxel in one launch.
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::lm_loop_pallas_v10
// (_lm_loop_kernel_v10).  Per voxel, max_iter + 1 trips of: the damped
// Cholesky solve of the carried (accepted) H/g (K3's arithmetic in K3's
// order), the predicted-decrease exit, the bound transform of the trial
// point and its expansion to the physical grid, the v9 evaluation of the
// trial (the block evaluation `v9_eval`, bit for bit K2's warp evaluation),
// and the accept/reject, lambda, plateau-streak and done rules of the
// reference.  Trip 0 is the initial evaluation: the
// accepted cost starts at +inf with H = 0 and g = 0, so its step is exactly
// zero and the trial at the seed is always taken; lambda is pinned to lam0
// on that trip and the accepted-step count starts after it.
//
// What bounds it on the H100: it reads each voxel's FID once (8 KB) and
// writes u, cost, the counts and the dense H (1.7 KB at F = 20); the work is
// one v9 evaluation (a few hundred kFLOP) and one F^3/3 factorization per
// trip, and most voxels retire after a few trips: fp32 issue-bound.
// Design: one block of 256 threads per voxel, the whole LM state in shared
// memory for the life of the fit.  The damped factorization and both
// substitutions run in warp 0 alone, in registers (lane i holds row i of
// the factor; `warp_factor_solve`, its loops unrolled over the free count
// rounded up to a multiple of 4, so that no branch separates the
// independent shuffles of a column), synchronised by shuffles: no block
// barrier inside, where the block-wide design it replaced took 3 block
// barriers a column and left both substitutions to one thread while 255
// waited (half of the time of a trip, scripts/ablate_lm_v10.py; about a
// third now, the v9 evaluation most of the rest).  Every entry still sees K3's
// sequence of correctly rounded operations in K3's order: the outer-product
// updates of column k, the forward substitution by columns (each y_i takes
// its subtractions j = 0..i-1 in order), and the back substitution in K3's
// serial order (x_i = (y_i - L_{i+1,i} x_{i+1} - ...) / L_ii, the products
// formed by their lanes, the differences by lane i), so the factor, the
// step and the whole fit are K3's, and the v9 loop's, bit for bit.  The
// scalar state (cost, lambda, streak, counts, done) is computed identically
// by every thread from shared values, so the trip loop and the early exit
// of a done voxel are uniform across the block.  A done voxel stops at
// once: the reference keeps stepping a tile until all of its voxels are
// done, but a done voxel's outputs no longer change.

#include <cuda_runtime.h>
#include <math.h>

#include "lm_v9_eval.cuh"
#include "spd_factor.cuh"

namespace {

constexpr int kBoth = 0, kLower = 1, kUpper = 2;  // bound kinds; 3 is free
constexpr float kEps64 = 64.f * 1.1920928955078125e-07f;  // 64 * FLT_EPSILON

// The damped Cholesky solve of the carried system by one warp (K3's
// arithmetic in K3's order: spd_factor.cuh's warp factor and
// substitutions, rows padded to kF), then the step to s_delta, whether it
// is finite to *s_ok, and the predicted decrease sum_i g_i delta_i (in
// order; 0 terms for a failed solve) to *s_pred.
template <int kF>
__device__ __forceinline__ void warp_factor_solve(
    const float* s_h, const float* s_g, float lam, int n_free, float* s_delta,
    int* s_ok, float* s_pred) {
    const int lane = threadIdx.x & 31;
    const bool real = lane < n_free;
    float a[kF];
    warp_factor<kF>(
        n_free, [s_h, n_free](int j, int i) { return s_h[j * n_free + i]; },
        [lam](float x) { return damp(x, lam); }, a);
    const float g_own = real ? s_g[lane] : 0.f;
    const float x = warp_back<kF>(a, warp_forward<kF>(a, g_own), n_free);
    const int ok = __all_sync(kFull, !real || isfinite(x)) ? 1 : 0;
    const float pg = __fmul_rn(g_own, ok ? x : 0.f);
    float pred = 0.f;
#pragma unroll
    for (int i = 0; i < kF; ++i)
        pred = __fadd_rn(pred, __shfl_sync(kFull, pg, i));
    if (real) s_delta[lane] = x;
    if (lane == 0) {
        *s_ok = ok;
        *s_pred = pred;
    }
}

// warp_factor_solve on n_free rows padded to a multiple of 4.
__device__ __forceinline__ void warp_factor_solve_any(
    const float* s_h, const float* s_g, float lam, int n_free, float* s_delta,
    int* s_ok, float* s_pred) {
    XMT_WARP_ROWS(n_free, warp_factor_solve<kF>(s_h, s_g, lam, n_free,
                                                s_delta, s_ok, s_pred))
}

// External value and dx/du of internal u (ops.bounds.internal_to_external
// with every product and sum rounded on its own, in the torch version's
// order; lo/hi are the finite-substituted bounds).
__device__ __forceinline__ void to_external(float u, float lo, float hi,
                                            int kind, float* x, float* d) {
    if (kind == kBoth) {
        const float span = __fsub_rn(hi, lo);
        *x = __fadd_rn(lo, __fmul_rn(__fmul_rn(__fadd_rn(sinf(u), 1.f), 0.5f),
                                     span));
        *d = __fmul_rn(__fmul_rn(0.5f, span), cosf(u));
    } else if (kind == kLower || kind == kUpper) {
        const float root = __fsqrt_rn(__fadd_rn(__fmul_rn(u, u), 1.f));
        if (kind == kLower) {
            *x = __fadd_rn(__fsub_rn(lo, 1.f), root);
            *d = __fdiv_rn(u, root);
        } else {
            *x = __fsub_rn(__fadd_rn(hi, 1.f), root);
            *d = __fdiv_rn(-u, root);
        }
    } else {
        *x = u;
        *d = 1.f;
    }
}

__global__ void __launch_bounds__(kThreads, 4) lm_loop_v10_kernel(
    const float* __restrict__ u0,       // (B, F) internal seed
    const float* __restrict__ y_re,     // (B, n_t)
    const float* __restrict__ y_im,
    const float* __restrict__ t,        // (n_t,)
    const float* __restrict__ lo,       // (F,) finite-substituted bounds
    const float* __restrict__ hi,
    const int* __restrict__ kind,       // (F,)
    const int* __restrict__ pmap_idx,   // (K*5,) free slot or -1
    const float* __restrict__ pmap_scale,
    const float* __restrict__ pmap_offset,
    Structure st,
    const float* __restrict__ row_scale,  // (A,)
    float* __restrict__ u_out,           // (B, F)
    float* __restrict__ cost_out,        // (B,)
    int* __restrict__ n_acc_out,         // (B,)
    unsigned char* __restrict__ done_out,  // (B,)
    float* __restrict__ h_out,           // (B, F, F)
    int* __restrict__ trips_out,         // (B,) evaluations, or null
    int n_t, int n_peaks, int n_free, int n_rows, int q_n, int factored,
    float w_cs_unit, float lam0, float ftol, int max_iter,
    int plateau_streak) {
    const long long v = blockIdx.x;
    const int tid = threadIdx.x;
    const int ff = n_free * n_free;

    extern __shared__ float smem[];
    float* s_t = smem;  // n_t, then v9_eval's work area
    __shared__ float s_par[kMaxPeaks * 5];
    __shared__ float s_dx[kMaxFree];
    __shared__ float s_x[kMaxFree];
    __shared__ float s_u[kMaxFree];
    __shared__ float s_ut[kMaxFree];
    __shared__ float s_g[kMaxFree];
    __shared__ float s_gt[kMaxFree];
    __shared__ float s_delta[kMaxFree];
    __shared__ float s_h[kMaxFree * kMaxFree];   // accepted H, row-major
    __shared__ float s_ht[kMaxFree * kMaxFree];  // trial H
    __shared__ float s_cost_t;
    __shared__ float s_pred;
    __shared__ int s_solve_ok;

    for (int i = tid; i < n_t; i += kThreads) s_t[i] = t[i];
    for (int i = tid; i < n_free; i += kThreads) {
        s_u[i] = u0[v * n_free + i];
        s_g[i] = 0.f;
    }
    for (int i = tid; i < ff; i += kThreads) s_h[i] = 0.f;
    __syncthreads();

    float cost = INFINITY;
    float lam = lam0;
    int n_acc = 0, streak = 0, trips = 0;
    bool done = false;

    for (int it = 0; it <= max_iter; ++it) {
        // ---- damped Cholesky solve of the carried H/g (warp 0) ----
        if (tid < 32)
            warp_factor_solve_any(s_h, s_g, lam, n_free, s_delta,
                                  &s_solve_ok, &s_pred);
        __syncthreads();

        // ---- predicted-decrease exit, before the trial is paid for ----
        const bool solve_ok = s_solve_ok != 0;
        const float pred_rel = __fdiv_rn(s_pred, fmaxf(cost, 1e-30f));
        if (pred_rel >= 0.f && pred_rel <= kEps64 && lam < lam0 && solve_ok) {
            done = true;
            break;  // the trial could not be accepted: the state is final
        }

        // ---- trial point, bound transform, physical grid ----
        for (int f = tid; f < n_free; f += kThreads) {
            const float ut =
                __fadd_rn(s_u[f], solve_ok ? s_delta[f] : 0.f);
            s_ut[f] = ut;
            to_external(ut, lo[f], hi[f], kind[f], &s_x[f], &s_dx[f]);
        }
        __syncthreads();
        for (int j = tid; j < n_peaks * 5; j += kThreads) {
            const int slot = pmap_idx[j];
            s_par[j] = slot < 0 ? pmap_offset[j]
                                : __fadd_rn(pmap_offset[j],
                                            __fmul_rn(pmap_scale[j], s_x[slot]));
        }
        __syncthreads();

        // ---- the trial's cost, g and H (K2's evaluation) ----
        v9_eval(s_par, s_dx, smem, y_re + v * n_t, y_im + v * n_t, st,
                row_scale, &s_cost_t, s_gt, s_ht, 1, n_t, n_peaks, n_free,
                n_rows, q_n, factored, w_cs_unit, nullptr);
        __syncthreads();
        ++trips;

        // ---- accept / reject ----
        const float cost_t = s_cost_t;
        const bool ok = isfinite(cost_t) && cost_t < cost;
        const float rel_drop =
            __fdiv_rn(__fsub_rn(cost, cost_t), fmaxf(cost, 1e-30f));
        if (ok) {
            for (int f = tid; f < n_free; f += kThreads) {
                s_u[f] = s_ut[f];
                s_g[f] = s_gt[f];
            }
            for (int e = tid; e < ff; e += kThreads) s_h[e] = s_ht[e];
            cost = cost_t;
        }
        const float lam_new =
            it == 0 ? lam0
                    : fminf(fmaxf(ok ? __fmul_rn(lam, 0.33f)
                                     : __fmul_rn(lam, 2.5f),
                                  1e-12f),
                            1e12f);
        if (ok && it > 0) ++n_acc;
        const bool plateau = !ok && fabsf(rel_drop) <= kEps64;
        streak = plateau ? streak + 1 : 0;
        done = (ok && rel_drop < ftol && lam_new < lam0) ||
               streak >= plateau_streak;
        lam = lam_new;
        __syncthreads();
        if (done) break;
    }

    for (int f = tid; f < n_free; f += kThreads) u_out[v * n_free + f] = s_u[f];
    for (int e = tid; e < ff; e += kThreads) h_out[v * ff + e] = s_h[e];
    if (tid == 0) {
        cost_out[v] = cost;
        n_acc_out[v] = n_acc;
        done_out[v] = done ? 1 : 0;
        if (trips_out != nullptr) trips_out[v] = trips;
    }
}

}  // namespace

extern "C" int xmt_lm_loop_v10(
    const float* u0, const float* y_re, const float* y_im, const float* t,
    const float* lo, const float* hi, const int* kind, const int* pmap_idx,
    const float* pmap_scale, const float* pmap_offset, const int* ints,
    const float* row_scale, float* u_out, float* cost, int* n_acc,
    unsigned char* done, float* h, int* trips, int b, int n_t, int n_peaks,
    int n_free, int n_rows, int q_n, int factored, float w_cs_unit,
    float lam0, float ftol, int max_iter, int plateau_streak, void* stream) {
    if (n_free < 1 || n_free > kMaxFree || n_peaks > kMaxPeaks ||
        n_rows > kMaxRows || q_n > kMaxQn)
        return (int)cudaErrorInvalidValue;
    const Structure st = unpack_structure(ints, n_rows, n_free);
    const size_t smem = v9_smem_floats(n_t, n_peaks, q_n) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lm_loop_v10_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (b > 0) {
        lm_loop_v10_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            u0, y_re, y_im, t, lo, hi, kind, pmap_idx, pmap_scale, pmap_offset,
            st, row_scale, u_out, cost, n_acc, done, h, trips, n_t, n_peaks,
            n_free, n_rows, q_n, factored, w_cs_unit, lam0, ftol, max_iter,
            plateau_streak);
    }
    return (int)cudaGetLastError();
}
