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
// It is compute bound, and the transcendentals (accurate sinf/cosf/logf, no
// fast-math intrinsics) dominate.
//
// Design: one block per voxel, kPer points per thread (point i = j*blockDim
// + tid, so the loads coalesce); re, im, u and the per-point terms stay in
// registers for the whole loop; d goes through shared memory once per
// evaluation for the neighbour reads of the first difference (and the
// backward difference of the gradient reuses the same buffer).  Each
// evaluation takes three block reductions (s1, sum 2 min(d,0), sum min^2,
// max; then the entropy sum and the tie count; then the two gradient
// sums).  Sums accumulate in double and are rounded to float once, and
// every per-point product and sum is rounded on its own (__fmul_rn etc.,
// no fused multiply-add) in the order of the plain PyTorch twin
// (acme_cuda.acme_polish_plain), so the two agree to the last bits up to
// the rounding of sinf/cosf/logf against torch's sin/cos/log.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kPer = 8;
constexpr int kMaxThreads = 512;  // n_f <= kPer * kMaxThreads = 4096
constexpr float kD2R = 0.017453292519943295f;

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

// Block sums of N doubles (and optionally one NaN-propagating float max):
// warp tree, then every thread adds the warp partials in warp order, so all
// threads end with the same values.
template <int N, bool kMax>
__device__ __forceinline__ void block_reduce(double (&v)[N], float& mx,
                                             double (*scr)[kMaxThreads / 32],
                                             float* scr_max) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    }
    if (kMax) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) scr[k][warp] = v[k];
        if (kMax) scr_max[warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
        double s = 0.0;
        for (int w = 0; w < n_warps; ++w) s += scr[k][w];
        v[k] = s;
    }
    if (kMax) {
        float m = scr_max[0];
        for (int w = 1; w < n_warps; ++w) m = nan_max(m, scr_max[w]);
        mx = m;
    }
    __syncthreads();  // the scratch is free again
}

struct Row {
    float re[kPer], im[kPer], u[kPer];
};

// Score and gradient (degrees) at (p0, p1); every thread returns the same.
__device__ void value_grad(const Row& r, int n, float p0, float p1,
                           bool p0_only, float* sd,
                           double (*scr)[kMaxThreads / 32], float* scr_max,
                           float& score, float& g0, float& g1) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    float d[kPer], q[kPer], delta[kPer];

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        if (i < n) {
            const float phi =
                __fmul_rn(kD2R, __fadd_rn(p0, __fmul_rn(p1, r.u[j])));
            // sinf/cosf, as torch.sin/torch.cos compute them on the card.
            const float s = sinf(phi);
            const float c = cosf(phi);
            d[j] = __fsub_rn(__fmul_rn(r.re[j], c), __fmul_rn(r.im[j], s));
            q[j] = -__fadd_rn(__fmul_rn(r.re[j], s), __fmul_rn(r.im[j], c));
            sd[i] = d[j];
        }
    }
    __syncthreads();

    // Round 1: s1 = sum |delta|/2, sa = sum 2 min(d, 0), sum min^2, max d.
    double acc1[3] = {0.0, 0.0, 0.0};
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        if (i < n) {
            delta[j] = (i < n - 1) ? __fsub_rn(sd[i + 1], d[j]) : 0.f;
            const float ds1 = __fmul_rn(fabsf(delta[j]), 0.5f);
            const float mind = d[j] >= 0.f ? 0.f : d[j];
            acc1[0] += (double)ds1;
            acc1[1] += (double)__fmul_rn(2.f, mind);
            acc1[2] += (double)__fmul_rn(mind, mind);
            m = nan_max(m, d[j]);
        }
    }
    block_reduce<3, true>(acc1, m, scr, scr_max);
    const float s1 = (float)acc1[0];
    const bool neg = (float)acc1[1] < 0.f;
    const float pen = neg ? (float)acc1[2] : 0.f;
    const float log_s1 = logf(s1);

    // Round 2: the entropy sum and the number of points at the maximum.
    double acc2[2] = {0.0, 0.0};
    float logp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        logp[j] = 0.f;
        if (i < n) {
            const float ds1 = __fmul_rn(fabsf(delta[j]), 0.5f);
            if (ds1 > 0.f) {
                logp[j] = __fsub_rn(logf(ds1), log_s1);
                acc2[0] += (double)__fmul_rn(__fdiv_rn(ds1, s1), logp[j]);
            }
            if (d[j] == m) acc2[1] += 1.0;
        }
    }
    float unused = 0.f;
    block_reduce<2, false>(acc2, unused, scr, scr_max);
    const float h = -(float)acc2[0];
    const float ties = (float)acc2[1];
    const float num = __fadd_rn(h, __fmul_rn(1000.f, pen));
    const float denom = __fmul_rn((float)n, m);
    score = m > 0.f ? __fdiv_rn(num, denom) : INFINITY;

    // Round 3: d(score)/d(d_i), chained to the phases.  ck goes through
    // the shared buffer for the backward difference (all reads of d in it
    // ended at round 1's barriers).
    const float one_minus_h = __fsub_rn(1.f, h);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        if (i < n) {
            const float ds1 = __fmul_rn(fabsf(delta[j]), 0.5f);
            const float a = ds1 > 0.f ? -__fadd_rn(logp[j], 1.f) : 0.f;
            const float dh = __fdiv_rn(__fadd_rn(a, one_minus_h), s1);
            sd[i] = (i < n - 1)
                        ? __fmul_rn(__fmul_rn(dh, sign_of(delta[j])), 0.5f)
                        : 0.f;
        }
    }
    __syncthreads();
    const float scale_m = __fdiv_rn(num, __fmul_rn(denom, m));
    double acc3[2] = {0.0, 0.0};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        if (i < n) {
            const float gh = __fsub_rn(i > 0 ? sd[i - 1] : 0.f, sd[i]);
            const float mind = d[j] >= 0.f ? 0.f : d[j];
            const float gp = neg ? __fmul_rn(2.f, mind) : 0.f;
            const float gm = __fdiv_rn(d[j] == m ? 1.f : 0.f, ties);
            const float gd =
                __fsub_rn(__fdiv_rn(__fadd_rn(gh, __fmul_rn(1000.f, gp)), denom),
                          __fmul_rn(scale_m, gm));
            const float t0 = __fmul_rn(gd, q[j]);
            acc3[0] += (double)t0;
            acc3[1] += (double)__fmul_rn(t0, r.u[j]);
        }
    }
    block_reduce<2, false>(acc3, unused, scr, scr_max);
    const bool live = m > 0.f;
    g0 = live ? __fmul_rn((float)acc3[0], kD2R) : 0.f;
    g1 = (live && !p0_only) ? __fmul_rn((float)acc3[1], kD2R) : 0.f;
}

__global__ void __launch_bounds__(kMaxThreads) acme_polish_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ coords, const float* __restrict__ pivots,
    const float* __restrict__ p_init, float* __restrict__ p_out,
    float* __restrict__ f_out, float* __restrict__ g_out, int n,
    float x_range, int n_iter, int p0_only, float half_cell, float span0,
    float span1) {
    extern __shared__ float sd[];
    __shared__ double scr[3][kMaxThreads / 32];
    __shared__ float scr_max[kMaxThreads / 32];
    const long long v = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const float piv = pivots[v];

    Row r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = j * nt + tid;
        r.re[j] = r.im[j] = r.u[j] = 0.f;
        if (i < n) {
            r.re[j] = re[v * n + i];
            r.im[j] = im[v * n + i];
            r.u[j] = __fdiv_rn(__fsub_rn(coords[i], piv), x_range);
        }
    }
    const bool p0o = p0_only != 0;
    float p0 = p_init[2 * v], p1 = p_init[2 * v + 1];
    float f, gc0, gc1;
    value_grad(r, n, p0, p0o ? 0.f : p1, p0o, sd, scr, scr_max, f, gc0, gc1);

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
        value_grad(r, n, q0, p0o ? 0.f : q1, p0o, sd, scr, scr_max, fn, gn0, gn1);
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
    if (b > 0) {
        const size_t smem = (size_t)n * sizeof(float);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                acme_polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        acme_polish_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
            re, im, coords, pivots, p_init, p_out, f_out, g_out, n, x_range,
            n_iter, p0_only, half_cell, span0, span1);
    }
    return (int)cudaGetLastError();
}
