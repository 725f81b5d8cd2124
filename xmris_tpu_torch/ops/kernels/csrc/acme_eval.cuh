// The ACME score's value and analytic gradient on one row, and the
// backtracking-gradient-descent polish built on it: K5's evaluation, shared
// by K5 (acme_polish_kernel, one block a voxel) and K5s (acme_search_kernel,
// the one-row grid search) in acme.cu.  csrc/acme.cu's header comment gives
// the formulas, the bound and the design; the plain twin of every line here
// is acme_cuda._value_grad / acme_cuda._polish.
//
// A thread owns kPer consecutive points, i0 = threadIdx.x * kPer, kept in
// shared memory at [k * blockDim.x + threadIdx.x] (each thread reads back
// its own slots only); threads past the row's end take part in the
// barriers with no points.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kD2R = 0.017453292519943295f;
// The sums' type: float64, as the twin's (see acme.cu's design notes).
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
template <int kPer>
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

// n_iter backtracking steps from (p0, p1) on the row ``r`` of n points, in
// unit space (span0, span1): the first trial spans ``half_cell``; a trial
// wrap(p - lr g span^2) is taken only if the score strictly falls (lr
// x1.2, else x0.5).  Leaves the accepted point in (p0, p1), its score in
// ``f``, and the gradient at the start in (g0_start, g1_start).
template <int kPer>
__device__ void polish(Row r, int n, float& p0, float& p1, bool p0o,
                       int n_iter, float half_cell, float span0, float span1,
                       float* sq, float* slp, Scratch& s, int& red, float& f,
                       float& g0_start, float& g1_start) {
    float gc0, gc1;
    value_grad<kPer>(r, n, p0, p0o ? 0.f : p1, p0o, sq, slp, s, red, f, gc0,
                     gc1);
    g0_start = gc0;
    g1_start = gc1;

    // Gradient-normalized initial rate: the first trial spans half a cell.
    const float a0 = fabsf(__fmul_rn(finite_or_zero(gc0), span0));
    const float a1 = fabsf(__fmul_rn(finite_or_zero(gc1), span1));
    const float gmax = a0 > a1 ? a0 : a1;
    float lr = gmax > 0.f ? __fdiv_rn(half_cell, fmaxf(gmax, FLT_MIN)) : 1e-2f;

    for (int it = 0; it < n_iter; ++it) {
        const float ga = __fmul_rn(finite_or_zero(gc0), span0);
        const float gb = __fmul_rn(finite_or_zero(gc1), span1);
        float q0 = __fsub_rn(p0, __fmul_rn(__fmul_rn(lr, ga), span0));
        float q1 = __fsub_rn(p1, __fmul_rn(__fmul_rn(lr, gb), span1));
        // p0 wrapped into [-180, 180); p1 clipped to the search box.
        q0 = __fsub_rn(q0, __fmul_rn(360.f, floorf(__fdiv_rn(__fadd_rn(q0, 180.f), 360.f))));
        if (!p0o) q1 = q1 < -4000.f ? -4000.f : (q1 > 4000.f ? 4000.f : q1);
        float fn, gn0, gn1;
        value_grad<kPer>(r, n, q0, p0o ? 0.f : q1, p0o, sq, slp, s, red, fn,
                         gn0, gn1);
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
}

}  // namespace
