// K5: the whole backtracking-gradient-descent ACME phase polish, one launch.
//
// Replaces xmris_tpu/ops/kernels/acme_pallas.py::acme_polish_pallas
// (_polish_kernel, _acme_value_grad, _wrap_params).  For each voxel row
// (re, im) of n_f points with coordinates c and pivot c0 (u = (c - c0) /
// x_range), starting from p = (p0, p1) degrees:
//
//   d     = re cos(phi) - im sin(phi),  phi = pi/180 (p0 + p1 u)
//   score = (H(|diff d| / 2) + 1000 P(d)) / (n_f max d),  +inf if max d <= 0
//
// with H the entropy of the normalized first-difference magnitudes (zero
// bins skipped) and P the negative-area penalty; the analytic gradient
// (tie-averaged at the maximum, zero where the score is +inf, non-finite
// entries zeroed before a step) drives n_iter backtracking steps in unit
// space (span 360 / 8000): trial = wrap(p - lr g span^2), accepted only if
// the score strictly falls (lr x1.2, else x0.5); the first trial spans
// half a mesh cell.  One value-and-gradient evaluation per iteration, at
// the trial point; the accepted gradient is carried.
//
// What bounds it on the H100: the rows are read once (2 x 134 MB at the
// bench grid of 16 384 x 2048, ~80 us at 3.35 TB/s), then every iteration
// is ~40 floating-point operations per point including a sincos and a log:
// 41 evaluations x 33.5 M points is ~55 GFLOP, ~0.8 ms at 67 TFLOP/s fp32.
// It is compute bound: the accurate sincosf and logf (|phi| reaches ~75
// rad at |p1| = 4000, and the entropy's logs feed a 1e-5 score check, so
// no fast-math intrinsics) and the block reductions set its pace.
//
// Design:
// * one block per voxel; each thread owns kPer = 8 consecutive points,
//   loaded 16 B at a time; d stays in registers, and re, im, u, q and the
//   entropy's log terms in the thread's own shared-memory slots (40 KB a
//   256-thread block), so four such blocks share an SM;
// * one sincosf per point and evaluation; each per-voxel divisor's
//   reciprocal is taken once an evaluation, and every per-point division
//   is the product with it plus one Markstein correction (an fma), which
//   keeps the division correctly rounded;
// * the first difference reads its neighbour from registers, from the
//   next lane by __shfl_down_sync, and across warps from one shared float
//   per warp (the backward difference of the gradient likewise), so d
//   never round-trips through shared memory;
// * each of the three reductions of an evaluation takes one barrier: a
//   warp shuffle tree, then every warp runs the same tree over the warp
//   partials (so all threads hold the same values), the scratch double
//   buffered; the cross-warp terms of the first difference ride on the
//   same barriers.
// * Every per-point product and sum is rounded on its own (__fmul_rn etc.,
//   no fused multiply-add) in the order of the plain twin
//   (acme_cuda.acme_polish_plain), and the sums accumulate the float32
//   terms in float64, rounded once, as the twin's do.  A backtracking
//   accept test turns any last-bit difference of the score into another
//   trajectory along the ACME valley's flat floor: with float32 sums and
//   reciprocals for the per-voxel divisors, only 58 % of the bench voxels'
//   polished phases stayed within 0.01 deg of the twin's (PERF.md).
// * The evaluation and the step are acme_eval.cuh's, which K5s shares.
//
// K5s: the whole single-pivot grid search of one row, one launch.
//
// Replaces a CUDA graph of the eager torch search (~5 700 kernels) on the
// single-pivot path; it ports no TPU kernel (the reference runs this search
// as XLA ops).  One block of 512 threads reads the pivot row straight from
// the spectra at the device-side (voxel_idx, freq_idx) of K1's peak search
// (no gather, no host read; the row is 8-16 KiB), then:
// * the scan of ops/phasing.py::_grid_phase_search on the row decimated by
//   dec = n_f // 512: 36 p0 candidates, then for p0 + p1 41 p1 candidates
//   given p0 and 7 p0 refinements, each scored by value_grad's score
//   arithmetic, one warp a candidate (16 warps: a chunk of the eager search's
//   cand_chunk 16 at a time, the scores in shared memory), the winner by
//   scan_axis's rule: a chunk's first minimum (its first NaN, if any)
//   replaces the running best only if strictly lower, so an all-inf stage
//   keeps 0;
// * the polish: K5's evaluation and step (acme_eval.cuh), 40 steps at full
//   resolution, or for p0 only the first n_coarse of them on the decimated
//   row, as the "fused" branch of _grid_phase_search runs them;
// and writes (p0, p1) degrees.  Plain twin: acme_cuda.acme_search_plain.
//
// What bounds it: 84 scores of ~512 points and 41 evaluations of 2048, each
// ~40 operations a point with an accurate sincosf and logf: ~5 MFLOP, a few
// microseconds of the card's fp32 rate, but one block on one SM, so its
// pace is one SM's latency through 7 scan rounds and 41 evaluations of three
// block reductions each (~0.2 ms); launching the same work as separate
// kernels costs a launch each.

#include <cuda_runtime.h>

#include "acme_eval.cuh"

namespace {

constexpr int kPer = 8;  // K5: n_f <= kPer * kMaxThreads = 4096

__global__ void __launch_bounds__(kMaxThreads, 2) acme_polish_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ coords, const float* __restrict__ pivots,
    const float* __restrict__ p_init, float* __restrict__ p_out,
    float* __restrict__ f_out, float* __restrict__ g_out, int n,
    float x_range, int n_iter, int p0_only, float half_cell, float span0,
    float span1, int vec_load) {
    extern __shared__ float sdyn[];
    __shared__ Scratch scr;
    const long long v = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    float* sq = sdyn;
    float* slp = sdyn + kPer * nt;
    float* sre = slp + kPer * nt;
    float* sim = sre + kPer * nt;
    float* su = sim + kPer * nt;
    const float piv = pivots[v];
    const int i0 = tid * kPer;

    float re_k[kPer], im_k[kPer], c_k[kPer];
    if (vec_load && i0 + kPer <= n) {
        const float4* re4 = reinterpret_cast<const float4*>(re + v * n + i0);
        const float4* im4 = reinterpret_cast<const float4*>(im + v * n + i0);
        const float4* c4 = reinterpret_cast<const float4*>(coords + i0);
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h) {
            const float4 a = __ldg(re4 + h), b = __ldg(im4 + h), c = __ldg(c4 + h);
            re_k[4 * h] = a.x; re_k[4 * h + 1] = a.y;
            re_k[4 * h + 2] = a.z; re_k[4 * h + 3] = a.w;
            im_k[4 * h] = b.x; im_k[4 * h + 1] = b.y;
            im_k[4 * h + 2] = b.z; im_k[4 * h + 3] = b.w;
            c_k[4 * h] = c.x; c_k[4 * h + 1] = c.y;
            c_k[4 * h + 2] = c.z; c_k[4 * h + 3] = c.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const bool in = i0 + k < n;
            re_k[k] = in ? re[v * n + i0 + k] : 0.f;
            im_k[k] = in ? im[v * n + i0 + k] : 0.f;
            c_k[k] = in ? coords[i0 + k] : piv;
        }
    }
    // Each thread's own slots: read back by the same thread only.
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        sre[k * nt + tid] = re_k[k];
        sim[k * nt + tid] = im_k[k];
        su[k * nt + tid] = __fdiv_rn(__fsub_rn(c_k[k], piv), x_range);
    }
    const Row r{sre, sim, su};

    const bool p0o = p0_only != 0;
    int red = 0;
    float p0 = p_init[2 * v], p1 = p_init[2 * v + 1];
    float f, g0, g1;
    polish<kPer>(r, n, p0, p1, p0o, n_iter, half_cell, span0, span1, sq, slp,
                 scr, red, f, g0, g1);
    if (tid == 0) {
        if (g_out != nullptr) {
            g_out[2 * v] = g0;
            g_out[2 * v + 1] = g1;
        }
        p_out[2 * v] = p0;
        p_out[2 * v + 1] = p1;
        f_out[v] = f;
    }
}

// ---------------------------------------------------------------------------
// K5s
// ---------------------------------------------------------------------------

constexpr int kScanMax = 1024;  // points of a decimated row: ceil(n / dec) < 1024
constexpr int kScanIters = kScanMax / 32;
constexpr int kChunk = kMaxWarps;  // candidates scored at once: cand_chunk 16

__device__ __forceinline__ acc_t warp_all_sum(acc_t x) {
    return __shfl_sync(0xffffffffu, warp_sum(x), 0);
}

// The score of (p0, p1) on the decimated row (n points in point order in
// shared memory) by one warp, every lane returning it: value_grad's score,
// operation for operation, lane l taking the points l, l + 32, ...
__device__ float warp_score(const float* re, const float* im, const float* u,
                            int n, float p0, float p1) {
    const int lane = threadIdx.x & 31;
    auto d_at = [&](int j) {
        if (j >= n) return 0.f;
        float sn, cs;
        sincosf(__fmul_rn(kD2R, __fadd_rn(p0, __fmul_rn(p1, u[j]))), &sn, &cs);
        return __fsub_rn(__fmul_rn(re[j], cs), __fmul_rn(im[j], sn));
    };
    float ds[kScanIters];
    acc_t acc[3] = {0, 0, 0};
    float m = -INFINITY;
    float d = d_at(lane);
#pragma unroll
    for (int it = 0; it < kScanIters; ++it) {
        ds[it] = 0.f;
        if (it * 32 < n) {
            const int j = it * 32 + lane;
            const float d_next = d_at(j + 32);
            float nb = __shfl_down_sync(0xffffffffu, d, 1);
            const float wrap = __shfl_sync(0xffffffffu, d_next, 0);
            if (lane == 31) nb = wrap;
            ds[it] = __fmul_rn(fabsf(j < n - 1 ? __fsub_rn(nb, d) : 0.f), 0.5f);
            if (j < n) {
                const float mind = d >= 0.f ? 0.f : d;  // NaN kept
                acc[0] += (acc_t)ds[it];
                acc[1] += (acc_t)__fmul_rn(2.f, mind);
                acc[2] += (acc_t)__fmul_rn(mind, mind);
                m = nan_max(m, d);
            }
            d = d_next;
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = warp_all_sum(acc[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        m = nan_max(m, __shfl_down_sync(0xffffffffu, m, o));
    m = __shfl_sync(0xffffffffu, m, 0);
    const float s1 = (float)acc[0];
    const bool neg = (float)acc[1] < 0.f;
    const float pen = neg ? (float)acc[2] : 0.f;
    const float log_s1 = logf(s1);
    const float rcp_s1 = __frcp_rn(s1);
    acc_t hs = 0;
#pragma unroll
    for (int it = 0; it < kScanIters; ++it) {
        if (it * 32 < n && ds[it] > 0.f) {
            const float logp = __fsub_rn(logf(ds[it]), log_s1);
            hs += (acc_t)__fmul_rn(div_rn(ds[it], s1, rcp_s1), logp);
        }
    }
    const float h = -(float)warp_all_sum(hs);
    const float num = __fadd_rn(h, __fmul_rn(1000.f, pen));
    const float denom = __fmul_rn((float)n, m);
    return m > 0.f ? __fdiv_rn(num, denom) : INFINITY;
}

// One stage of the scan: the candidates c_i = first + step i (i < count)
// added along ``axis`` to the base (b0, b1), a chunk of kChunk at a time,
// one warp a candidate; every thread returns the stage's winner, base +
// c_i, or 0 if no chunk's winner was finite.
__device__ float scan_axis(const float* re, const float* im, const float* u,
                           int n, float b0, float b1, int axis, float first,
                           float step, int count, float* s_score) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float base = axis == 0 ? b0 : b1;
    float best_e = INFINITY, best_v = 0.f;
    for (int c0 = 0; c0 < count; c0 += kChunk) {
        const int m = count - c0 < kChunk ? count - c0 : kChunk;
        if (warp < m) {
            const float c = __fadd_rn(first, __fmul_rn(step, (float)(c0 + warp)));
            const float e = warp_score(re, im, u, n,
                                       axis == 0 ? __fadd_rn(b0, c) : b0,
                                       axis == 1 ? __fadd_rn(b1, c) : b1);
            if (lane == 0) s_score[warp] = e;
        }
        __syncthreads();
        // torch.argmin over the chunk: the first NaN, else the first minimum.
        int w = 0;
        for (int k = 1; k < m && s_score[w] == s_score[w]; ++k) {
            const float e = s_score[k];
            if (e != e || e < s_score[w]) w = k;
        }
        const float e_min = s_score[w];
        if (e_min < best_e) {
            best_e = e_min;
            best_v = __fadd_rn(base, __fadd_rn(first, __fmul_rn(step, (float)(c0 + w))));
        }
        __syncthreads();  // every thread has read the scores
    }
    return best_v;
}

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads, 1) acme_search_kernel(
    const float* __restrict__ re, const float* __restrict__ im, int stride_re,
    int stride_im, const float* __restrict__ freqs,
    const long long* __restrict__ voxel_idx,
    const long long* __restrict__ freq_idx, float* __restrict__ p_out, int n,
    int dec, int p0_only, int n_coarse, int n_fine, float half_cell,
    float span0, float span1) {
    extern __shared__ float sdyn[];
    __shared__ Scratch scr;
    __shared__ float s_score[kChunk];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    float* sq = sdyn;
    float* slp = sq + kPer * nt;
    float* sre = slp + kPer * nt;
    float* sim = sre + kPer * nt;
    float* su = sim + kPer * nt;
    float* dre = su + kPer * nt;  // the decimated row, in point order
    float* dim = dre + kScanMax;
    float* du = dim + kScanMax;

    const long long v = *voxel_idx;
    const float* row_re = re + v * stride_re;
    const float* row_im = im + v * stride_im;
    const float piv = freqs[*freq_idx];
    const float x_range = __fsub_rn(freqs[n - 1], freqs[0]);
    const int n_d = (n + dec - 1) / dec;
    for (int j = tid; j < n_d; j += nt) {
        const int i = j * dec;
        dre[j] = row_re[i];
        dim[j] = row_im[i];
        du[j] = __fdiv_rn(__fsub_rn(freqs[i], piv), x_range);
    }
    __syncthreads();

    const bool p0o = p0_only != 0;
    float p0 = scan_axis(dre, dim, du, n_d, 0.f, 0.f, 0, -180.f, 10.f, 36, s_score);
    float p1 = 0.f;
    if (!p0o) {
        p1 = scan_axis(dre, dim, du, n_d, p0, 0.f, 1, -4000.f, 200.f, 41, s_score);
        p0 = scan_axis(dre, dim, du, n_d, p0, p1, 0, -15.f, 5.f, 7, s_score);
    }

    // The polish: each thread stages its own points (i0 + k of the row the
    // polish runs on) at [k * nt + tid], zeros past the end.
    const Row r{sre, sim, su};
    int red = 0;
    float f, g0, g1;
    const int i0 = tid * kPer;
    if (n_coarse > 0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const bool in = i0 + k < n_d;
            sre[k * nt + tid] = in ? dre[i0 + k] : 0.f;
            sim[k * nt + tid] = in ? dim[i0 + k] : 0.f;
            su[k * nt + tid] = in ? du[i0 + k] : 0.f;
        }
        polish<kPer>(r, n_d, p0, p1, p0o, n_coarse, half_cell, span0, span1,
                     sq, slp, scr, red, f, g0, g1);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const bool in = i0 + k < n;
        sre[k * nt + tid] = in ? row_re[i0 + k] : 0.f;
        sim[k * nt + tid] = in ? row_im[i0 + k] : 0.f;
        su[k * nt + tid] =
            in ? __fdiv_rn(__fsub_rn(freqs[i0 + k], piv), x_range) : 0.f;
    }
    polish<kPer>(r, n, p0, p1, p0o, n_fine, half_cell, span0, span1, sq, slp,
                 scr, red, f, g0, g1);
    if (tid == 0) {
        p_out[0] = p0;
        p_out[1] = p1;
    }
}

template <int kPer>
int launch_search(const float* re, const float* im, int stride_re,
                  int stride_im, const float* freqs, const long long* voxel_idx,
                  const long long* freq_idx, float* p_out, int n, int dec,
                  int p0_only, int n_coarse, int n_fine, float half_cell,
                  float span0, float span1, cudaStream_t stream) {
    const size_t smem =
        ((size_t)5 * kPer * kMaxThreads + 3 * kScanMax) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        acme_search_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    acme_search_kernel<kPer><<<1, kMaxThreads, smem, stream>>>(
        re, im, stride_re, stride_im, freqs, voxel_idx, freq_idx, p_out, n,
        dec, p0_only, n_coarse, n_fine, half_cell, span0, span1);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xmt_acme_polish(const float* re, const float* im,
                               const float* coords, const float* pivots,
                               const float* p_init, float* p_out, float* f_out,
                               float* g_out, int b, int n, float x_range,
                               int n_iter, int p0_only, float half_cell,
                               float span0, float span1, void* stream) {
    int threads = (n + kPer - 1) / kPer;
    threads = ((threads + 31) / 32) * 32;
    if (n < 2 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
    // 16-byte loads need every row and the coordinates 16-byte aligned.
    const int vec_load =
        n % 4 == 0 &&
        ((reinterpret_cast<size_t>(re) | reinterpret_cast<size_t>(im) |
          reinterpret_cast<size_t>(coords)) & 15) == 0;
    if (b > 0) {
        const size_t smem = (size_t)5 * kPer * threads * sizeof(float);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                acme_polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        acme_polish_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
            re, im, coords, pivots, p_init, p_out, f_out, g_out, n, x_range,
            n_iter, p0_only, half_cell, span0, span1, vec_load);
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_acme_search(const float* re, const float* im,
                               int stride_re, int stride_im,
                               const float* freqs, const long long* voxel_idx,
                               const long long* freq_idx, float* p_out, int n,
                               int dec, int p0_only, int n_coarse, int n_fine,
                               float half_cell, float span0, float span1,
                               void* stream) {
    if (n < 2 || n > 8 * kMaxThreads || dec < 1 ||
        (n + dec - 1) / dec > kScanMax)
        return (int)cudaErrorInvalidValue;
    // The polish's points a thread: the fewest that cover the row.
    const auto launch = n <= kMaxThreads       ? &launch_search<1>
                        : n <= 2 * kMaxThreads ? &launch_search<2>
                        : n <= 4 * kMaxThreads ? &launch_search<4>
                                               : &launch_search<8>;
    return launch(re, im, stride_re, stride_im, freqs, voxel_idx, freq_idx,
                  p_out, n, dec, p0_only, n_coarse, n_fine, half_cell, span0,
                  span1, (cudaStream_t)stream);
}
