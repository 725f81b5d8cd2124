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

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kPer = 8;
constexpr int kMaxThreads = 512;  // n_f <= kPer * kMaxThreads = 4096
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kD2R = 0.017453292519943295f;
// The sums' type: float64, as the twin's (see the design notes above).
using acc_t = double;

__device__ __forceinline__ float nan_max(float a, float b) {
    // jnp.max / torch.amax propagate NaN.
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float finite_or_zero(float g) {
    return isfinite(g) ? g : 0.f;
}

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

struct Scratch {
    acc_t part[2][3][kMaxWarps];   // warp partial sums, double buffered
    float part_max[kMaxWarps];     // warp maxima of d
    float first_d[kMaxWarps];      // d at each warp's first point
    float last_d[kMaxWarps];       // d at each warp's last point
    float last_a[kMaxWarps];       // -(logp + 1) (or 0) there
    float last_sg[kMaxWarps];      // sign of its first difference
};

__device__ __forceinline__ acc_t warp_sum(acc_t x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;  // lane 0 holds the sum
}

// Block sums of N values (and with kMax one NaN-propagating float max) in
// a fixed order: a warp tree, then every warp runs the same tree over the
// warp partials, so all threads end with the same values.  One barrier;
// ``part`` alternates between the two scratch buffers.
template <int N, bool kMax>
__device__ __forceinline__ void block_reduce(acc_t (&v)[N], float& mx,
                                             acc_t (*part)[kMaxWarps],
                                             float* part_max) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
    if (kMax) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) part[k][warp] = v[k];
        if (kMax) part_max[warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const acc_t x = warp_sum(lane < n_warps ? part[k][lane] : acc_t(0));
        v[k] = __shfl_sync(0xffffffffu, x, 0);
    }
    if (kMax) {
        float m = lane < n_warps ? part_max[lane] : -INFINITY;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            m = nan_max(m, __shfl_down_sync(0xffffffffu, m, o));
        mx = __shfl_sync(0xffffffffu, m, 0);
    }
}

// x / y correctly rounded from r = 1/y correctly rounded: the quotient
// x r and one Markstein correction (its residual is exact in an fma).
__device__ __forceinline__ float div_rn(float x, float y, float r) {
    const float q = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// A thread's points: re, im and u at [k * nt + tid] of shared memory.
struct Row {
    const float *re, *im, *u;
};

// Score and gradient (degrees) at (p0, p1); every thread returns the same.
// ``sq``/``slp`` hold this thread's q and log terms at [k * nt + tid];
// ``red`` counts the reductions, so each takes the other scratch buffer
// (the maximum's scratch is read before the next write to it, two
// barriers later).
__device__ void value_grad(Row r, int n, float p0, float p1,
                           bool p0_only, float* sq, float* slp, Scratch& s,
                           int& red, float& score, float& g0, float& g1) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int i0 = tid * kPer;  // this thread's first point
    // The warp's last point: its first difference reaches into the next
    // warp when it is not the row's last point.
    const int warp_last = (warp + 1) * 32 * kPer - 1;
    float d[kPer];

#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        float sn, cs;
        const int e = k * nt + tid;
        const float re = r.re[e], im = r.im[e];
        sincosf(__fmul_rn(kD2R, __fadd_rn(p0, __fmul_rn(p1, r.u[e]))), &sn, &cs);
        d[k] = i0 + k < n ? __fsub_rn(__fmul_rn(re, cs), __fmul_rn(im, sn)) : 0.f;
        sq[e] = -__fadd_rn(__fmul_rn(re, sn), __fmul_rn(im, cs));
    }
    if (lane == 0) s.first_d[warp] = d[0];
    if (lane == 31) s.last_d[warp] = d[kPer - 1];

    // Round 1: s1 = sum |delta|/2, sa = sum 2 min(d, 0), sum min^2, max d.
    // The first difference of a lane's last point reads the next lane's
    // first d; that of the warp's last point is added after the barrier,
    // from the warp floats.  delta is recomputed where used (registers).
    float d_nb = __shfl_down_sync(0xffffffffu, d[0], 1);
    auto delta = [&](int k) {
        const float nb = k + 1 < kPer ? d[k + 1] : d_nb;
        return i0 + k < n - 1 ? __fsub_rn(nb, d[k]) : 0.f;
    };
    acc_t acc1[3] = {0, 0, 0};
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        if (i0 + k < n) {
            const float mind = d[k] >= 0.f ? 0.f : d[k];  // NaN kept
            if (lane != 31 || k + 1 < kPer)
                acc1[0] += (acc_t)__fmul_rn(fabsf(delta(k)), 0.5f);
            acc1[1] += (acc_t)__fmul_rn(2.f, mind);
            acc1[2] += (acc_t)__fmul_rn(mind, mind);
            m = nan_max(m, d[k]);
        }
    }
    block_reduce<3, true>(acc1, m, s.part[red++ & 1], s.part_max);
    for (int w = 0; (w + 1) * 32 * kPer - 1 < n - 1; ++w)
        acc1[0] += (acc_t)__fmul_rn(
            fabsf(__fsub_rn(s.first_d[w + 1], s.last_d[w])), 0.5f);
    if (lane == 31 && warp_last < n - 1) d_nb = s.first_d[warp + 1];
    const float s1 = (float)acc1[0];
    const bool neg = (float)acc1[1] < 0.f;
    const float pen = neg ? (float)acc1[2] : 0.f;
    const float log_s1 = logf(s1);
    const float rcp_s1 = __frcp_rn(s1);

    // Round 2: the entropy sum and the number of points at the maximum.
    acc_t acc2[2] = {0, 0};
    float a_last = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const float ds1 = __fmul_rn(fabsf(delta(k)), 0.5f);
        float a = 0.f;
        if (ds1 > 0.f) {
            const float logp = __fsub_rn(logf(ds1), log_s1);
            acc2[0] += (acc_t)__fmul_rn(div_rn(ds1, s1, rcp_s1), logp);
            a = -__fadd_rn(logp, 1.f);
        }
        slp[k * nt + tid] = a;
        a_last = a;
        if (i0 + k < n && d[k] == m) acc2[1] += 1;
    }
    if (lane == 31) {
        s.last_a[warp] = a_last;
        s.last_sg[warp] = sign_of(delta(kPer - 1));
    }
    float unused = 0.f;
    block_reduce<2, false>(acc2, unused, s.part[red++ & 1], nullptr);
    const float h = -(float)acc2[0];
    const float num = __fadd_rn(h, __fmul_rn(1000.f, pen));
    const float denom = __fmul_rn((float)n, m);
    score = m > 0.f ? __fdiv_rn(num, denom) : INFINITY;
    // 1 / ties is the twin's is_max / ties where the point is at the max.
    const float inv_ties = __fdiv_rn(1.f, (float)acc2[1]);
    const float scale_m = __fdiv_rn(num, __fmul_rn(denom, m));
    const float rcp_denom = __frcp_rn(denom);

    // Round 3: d(score)/d(d_i), chained to the phases.  ck_i = dh_i
    // sign(delta_i) / 2 (0 at the last point); gh_i = ck_(i-1) - ck_i.
    const float omh = __fsub_rn(1.f, h);
    auto ck = [&](int k, float a, float sg) {
        return i0 + k < n - 1
                   ? __fmul_rn(__fmul_rn(div_rn(__fadd_rn(a, omh), s1, rcp_s1), sg),
                               0.5f)
                   : 0.f;
    };
    float ck_prev = __shfl_up_sync(
        0xffffffffu, ck(kPer - 1, slp[(kPer - 1) * nt + tid],
                        sign_of(delta(kPer - 1))), 1);
    if (lane == 0)
        ck_prev = warp == 0 ? 0.f
                            : ck(-1, s.last_a[warp - 1], s.last_sg[warp - 1]);
    acc_t acc3[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const float ck_k = ck(k, slp[k * nt + tid], sign_of(delta(k)));
        if (i0 + k < n) {
            const float gh = __fsub_rn(ck_prev, ck_k);
            const float gp = neg ? __fmul_rn(2.f, d[k] >= 0.f ? 0.f : d[k]) : 0.f;
            const float gm = d[k] == m ? inv_ties : 0.f;
            const float gd = __fsub_rn(
                div_rn(__fadd_rn(gh, __fmul_rn(1000.f, gp)), denom, rcp_denom),
                __fmul_rn(scale_m, gm));
            const float t0 = __fmul_rn(gd, sq[k * nt + tid]);
            acc3[0] += (acc_t)t0;
            acc3[1] += (acc_t)__fmul_rn(t0, r.u[k * nt + tid]);
        }
        ck_prev = ck_k;
    }
    block_reduce<2, false>(acc3, unused, s.part[red++ & 1], nullptr);
    const bool live = m > 0.f;
    g0 = live ? __fmul_rn((float)acc3[0], kD2R) : 0.f;
    g1 = (live && !p0_only) ? __fmul_rn((float)acc3[1], kD2R) : 0.f;
}

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
    float f, gc0, gc1;
    value_grad(r, n, p0, p0o ? 0.f : p1, p0o, sq, slp, scr, red, f, gc0, gc1);

    // Gradient-normalized initial rate: the first trial spans half a cell.
    const float a0 = fabsf(__fmul_rn(finite_or_zero(gc0), span0));
    const float a1 = fabsf(__fmul_rn(finite_or_zero(gc1), span1));
    const float gmax = a0 > a1 ? a0 : a1;
    float lr = gmax > 0.f ? __fdiv_rn(half_cell, fmaxf(gmax, FLT_MIN)) : 1e-2f;
    if (g_out != nullptr && tid == 0) {
        g_out[2 * v] = gc0;
        g_out[2 * v + 1] = gc1;
    }

    for (int it = 0; it < n_iter; ++it) {
        const float ga = __fmul_rn(finite_or_zero(gc0), span0);
        const float gb = __fmul_rn(finite_or_zero(gc1), span1);
        float q0 = __fsub_rn(p0, __fmul_rn(__fmul_rn(lr, ga), span0));
        float q1 = __fsub_rn(p1, __fmul_rn(__fmul_rn(lr, gb), span1));
        // p0 wrapped into [-180, 180); p1 clipped to the search box.
        q0 = __fsub_rn(q0, __fmul_rn(360.f, floorf(__fdiv_rn(__fadd_rn(q0, 180.f), 360.f))));
        if (!p0o) q1 = q1 < -4000.f ? -4000.f : (q1 > 4000.f ? 4000.f : q1);
        float fn, gn0, gn1;
        value_grad(r, n, q0, p0o ? 0.f : q1, p0o, sq, slp, scr, red, fn, gn0,
                   gn1);
        if (fn < f) {
            p0 = q0;
            p1 = q1;
            f = fn;
            gc0 = gn0;
            gc1 = gn1;
            lr = __fmul_rn(lr, 1.2f);
        } else {
            lr = __fmul_rn(lr, 0.5f);
        }
    }
    if (tid == 0) {
        p_out[2 * v] = p0;
        p_out[2 * v + 1] = p1;
        f_out[v] = f;
    }
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
