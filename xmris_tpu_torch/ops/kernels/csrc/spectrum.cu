// K1: window -> zero-fill -> ortho DFT -> fftshift, plus each voxel's peak.
//
// Replaces xmris_tpu/ops/kernels/dft_pallas.py::spectrum_pallas
// (_spectrum_kernel with with_maxmag and stacked_out).  Two kernels, one
// function; dft_cuda.route(n_in, n_out) names which one a shape takes.
//
// spectrum_fft_kernel, n_out a power of two in [256, 8192] (the bench's
// 1024 -> 2048): a mixed-radix Stockham FFT in shared memory.
//
// What bounds it on the H100: the planes are read once and the spectrum
// written once, 16384 x (8 x 1024 + 8 x 2048) B = 403 MB at the bench
// shape, ~0.120 ms at 3.35 TB/s; an FFT's 5 n log2 n is 113 kFLOP a
// voxel, ~0.03 ms at 67 TFLOP/s.  It is bound by bytes, so everything
// between the load and the store stays on the SM.  Design:
// * n_out / 8 threads per voxel, each holding 8 complex points in
//   registers; the passes are radix 8 (then one radix-4 or radix-2 pass
//   when log2 n_out is not a multiple of 3: dft_cuda.fft_plan), and shared
//   memory only swaps the points between passes, two buffers a voxel so
//   that a pass takes one barrier;
// * blocks of 256 threads hold 256 / (n_out / 8) voxels when n_out < 2048,
//   one voxel otherwise, so several blocks share an SM at every length;
// * the load reads the planes and the window 16 B a thread, coalesced,
//   with the window and 1/sqrt(n_out) folded in; the zero-fill is written
//   to shared memory and never read from device memory;
// * twiddles come from a table e^(-2 pi i k / n_out) that the host computes
//   in float64 and stores as interleaved float32 pairs (one 8-byte load
//   through L1 each);
// * the last pass stores straight to device memory at the fftshifted index
//   (k + n_out/2) mod n_out, coalesced, and reduces each voxel's max |X|^2
//   and its first flat index while the points are in registers.
// The stacked (n2, n1) layout is the flat spectrum in memory, so both
// layouts are one store; the wrapper views it.
//
// spectrum_kernel, the other lengths pallas_split_ok accepts (e.g. 768 ->
// 1536): the reference's Cooley-Tukey split n_out = n1 * n2 with input
// index j = j1*n2 + j2 and output index k = k1 + n1*k2:
//
//   Y[k1, j2]  = sum_{j1 < n_in/n2} F1[k1, j1] * w[j] x[j]     stage 1
//   Y'[k1, j2] = Y[k1, j2] * TW[k1, j2]                        twiddle
//   X[k2, k1]  = sum_{j2} F2[k2, j2] * Y'[k1, j2]              stage 2
//
// Zero-fill is free (only j1 < n_in/n2 rows of stage 1 exist) and the
// fftshift is folded into F2's k2 rows by the host tables.
//
// It does two dense contractions, ~1 MFLOP of fp32 FMA per voxel at n_out
// = 2048 (9x an FFT), each multiply-add pairing an L1 read of a factor
// table with a shared-memory read, so the SM's L1/shared path sets its
// pace (1.725 ms at the bench shape on the H100, PERF.md).  Design: one
// block per voxel; the windowed input (8 KB) and the twiddled stage-1
// result (16 KB) stay in shared memory, so each voxel touches device
// memory once to read and once to write.  The factor tables (40 KB) are
// read from L2/L1, laid out so a warp reads them coalesced or as a
// broadcast, and shared-memory reads walk consecutive addresses (no bank
// conflicts).  The per-voxel max |X|^2 and its FIRST flat index (the
// reference's tie-break) are reduced in-block while the spectrum is in
// registers, so no full-grid magnitude pass runs afterwards.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

__global__ void __launch_bounds__(kThreads) spectrum_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ w,
    const float* __restrict__ f1t_re, const float* __restrict__ f1t_im,
    const float* __restrict__ twt_re, const float* __restrict__ twt_im,
    const float* __restrict__ f2_re, const float* __restrict__ f2_im,
    float* __restrict__ out_re, float* __restrict__ out_im,
    float* __restrict__ maxmag, int* __restrict__ maxidx,
    int n_in, int n_out, int n2, int with_maxmag) {
    extern __shared__ float smem[];
    const int n1 = n_out / n2;
    const int n1_in = n_in / n2;
    float* s_xr = smem;            // (n_in)   windowed input, index j
    float* s_xi = s_xr + n_in;
    float* s_yr = s_xi + n_in;     // (n_out)  Y' at j2*n1 + k1
    float* s_yi = s_yr + n_out;

    const long long v = blockIdx.x;
    const float* xr_v = xr + v * n_in;
    const float* xi_v = xi + v * n_in;
    for (int j = threadIdx.x; j < n_in; j += blockDim.x) {
        const float wj = w[j];
        s_xr[j] = xr_v[j] * wj;
        s_xi[j] = xi_v[j] * wj;
    }
    __syncthreads();

    // Stage 1 + twiddle.  Consecutive threads take consecutive k1 (same
    // j2): the x reads are a shared-memory broadcast, the F1^T and TW^T
    // reads are coalesced.
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
        const int k1 = o % n1;
        const int j2 = o / n1;
        float ar = 0.f, ai = 0.f;
        for (int j1 = 0; j1 < n1_in; ++j1) {
            const float fr = __ldg(f1t_re + j1 * n1 + k1);
            const float fi = __ldg(f1t_im + j1 * n1 + k1);
            const float a = s_xr[j1 * n2 + j2];
            const float b = s_xi[j1 * n2 + j2];
            ar += fr * a - fi * b;
            ai += fr * b + fi * a;
        }
        const float tr = __ldg(twt_re + o);
        const float ti = __ldg(twt_im + o);
        s_yr[o] = ar * tr - ai * ti;
        s_yi[o] = ar * ti + ai * tr;
    }
    __syncthreads();

    // Stage 2: output o = k2*n1 + k1 (the stacked (n2, n1) layout, which
    // is the flat spectrum in memory).  F2 reads are a broadcast, Y' reads
    // consecutive, the output stores coalesced.
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    float* ore = out_re + v * n_out;
    float* oim = out_im + v * n_out;
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
        const int k1 = o % n1;
        const int k2 = o / n1;
        float zr = 0.f, zi = 0.f;
        for (int j2 = 0; j2 < n2; ++j2) {
            const float fr = __ldg(f2_re + k2 * n2 + j2);
            const float fi = __ldg(f2_im + k2 * n2 + j2);
            const float a = s_yr[j2 * n1 + k1];
            const float b = s_yi[j2 * n1 + k1];
            zr += fr * a - fi * b;
            zi += fr * b + fi * a;
        }
        ore[o] = zr;
        oim[o] = zi;
        if (with_maxmag) {
            // o grows within a thread, so strict > keeps the first index.
            const float m2 = zr * zr + zi * zi;
            if (m2 > best) {
                best = m2;
                best_i = o;
            }
        }
    }
    if (!with_maxmag) return;

    // Block arg-max with the first-occurrence tie-break.
    __shared__ float s_bv[kThreads / 32];
    __shared__ int s_bi[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        better(best, best_i, ov, oi);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_bv[warp] = best;
        s_bi[warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float bv = s_bv[0];
        int bi = s_bi[0];
        for (int wi = 1; wi < (int)(blockDim.x >> 5); ++wi)
            better(bv, bi, s_bv[wi], s_bi[wi]);
        maxmag[v] = bv;
        maxidx[v] = bi;
    }
}

// ---- the shared-memory FFT (power-of-two n_out) ----

constexpr int kFftBlock = 256;      // threads a block takes when n_out < 2048
constexpr int kFftMaxThreads = 1024;  // n_out = 8192

// Shared-memory index: one pad word per 32 and bits 3-4 swizzled by bits
// 6-7, so the strided writes of the first two passes spread over the banks
// (at most 2-way conflicts; 4 consecutive words stay consecutive).
__device__ __forceinline__ int pad(int i) {
    return (i ^ (((i >> 6) & 3) << 3)) + (i >> 5);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
    return make_float2(a.y, -a.x);
}

// In-place DFT of R points, X[k] = sum_r v[r] e^(-2 pi i r k / R), natural
// order in and out.
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
    const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
    const float2 a2 = cadd(v[1], v[3]), a3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(a0, a2);
    v[2] = csub(a0, a2);
    v[1] = cadd(a1, a3);
    v[3] = csub(a1, a3);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
    constexpr float c = 0.70710678118654752f;
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e);
    dft<4>(o);
    // o[k] *= e^(-2 pi i k / 8)
    o[1] = make_float2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = cadd(e[k], o[k]);
        v[k + 4] = csub(e[k], o[k]);
    }
}

// One Stockham pass of radix R over the n points of a voxel: butterfly jb
// reads points jb + r n/R, twiddles them by e^(-2 pi i r (jb mod ns) /
// (ns R)) (table entry r (jb mod ns) n / (ns R)) and transforms them; its
// outputs go to (jb / ns) ns R + jb mod ns + r ns.  A thread owns the 8/R
// butterflies j + q n/8.
template <int R>
__device__ __forceinline__ void load_pass(float2 (&x)[8], const float* sr,
                                          const float* si,
                                          const float2* __restrict__ tw, int n,
                                          int ns, int j) {
    const int t_per = n >> 3;
#pragma unroll
    for (int q = 0; q < 8 / R; ++q) {
        const int jb = j + q * t_per;
        const int k = jb % ns;
        const int step = k * (n / (ns * R));
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = pad(jb + r * (n / R));
            float2 a = make_float2(sr[i], si[i]);
            if (ns > 1 && r > 0) {
                a = cmul(a, __ldg(tw + r * step));
            }
            x[q * R + r] = a;
        }
        dft<R>(x + q * R);
    }
}

template <int R>
__device__ __forceinline__ void store_pass(const float2 (&x)[8], float* sr,
                                           float* si, int n, int ns, int j) {
    const int t_per = n >> 3;
#pragma unroll
    for (int q = 0; q < 8 / R; ++q) {
        const int jb = j + q * t_per;
        const int d = (jb / ns) * ns * R + jb % ns;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = pad(d + r * ns);
            sr[i] = x[q * R + r].x;
            si[i] = x[q * R + r].y;
        }
    }
}

// The last pass (ns = n / R, so butterfly jb's outputs are jb + r ns):
// fftshifted coalesced stores and the thread's max |X|^2 with its first
// stored index.
template <int R>
__device__ __forceinline__ void store_last(const float2 (&x)[8], float* ore,
                                           float* oim, int n, int j, bool live,
                                           float& best, int& best_i) {
    const int t_per = n >> 3;
    const int ns = n / R;
#pragma unroll
    for (int q = 0; q < 8 / R; ++q) {
        const int jb = j + q * t_per;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int s = (jb + r * ns + (n >> 1)) & (n - 1);
            const float2 a = x[q * R + r];
            if (live) {
                ore[s] = a.x;
                oim[s] = a.y;
            }
            // |X|^2 rounded as the plain version's separate products.
            better(best, best_i, __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)),
                   s);
        }
    }
}

// A pass from one shared buffer to the other: one barrier.
template <int R>
__device__ __forceinline__ void pass(float2 (&x)[8], const float* sr,
                                     const float* si, float* dr, float* di,
                                     const float2* __restrict__ tw, int n,
                                     int ns, int j) {
    load_pass<R>(x, sr, si, tw, n, ns, j);
    store_pass<R>(x, dr, di, n, ns, j);
    __syncthreads();
}

__global__ void __launch_bounds__(kFftMaxThreads) spectrum_fft_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ w, const float2* __restrict__ tw,
    float* __restrict__ out_re,
    float* __restrict__ out_im, float* __restrict__ maxmag,
    int* __restrict__ maxidx, int b, int n_in, int log2n, float scale,
    int with_maxmag, int vec_load) {
    extern __shared__ float smem[];
    const int n = 1 << log2n;
    const int t_per = n >> 3;  // threads per voxel, a multiple of 32
    const int vib = threadIdx.x / t_per;
    const int j = threadIdx.x - vib * t_per;
    const int vpb = blockDim.x / t_per;
    const long long v = (long long)blockIdx.x * vpb + vib;
    const bool live = v < b;  // a ragged last block keeps its barriers
    const int pitch = n + (n >> 5);
    // Two (re, im) buffers a voxel: each pass reads one, writes the other.
    float* sr = smem + 4 * vib * pitch;
    float* si = sr + pitch;
    float* dr = si + pitch;
    float* di = dr + pitch;

    // Load: window and scale folded in, the zero-fill written, not read.
    const float* xr_v = xr + (live ? v : 0) * n_in;
    const float* xi_v = xi + (live ? v : 0) * n_in;
    if (vec_load) {
        for (int q = j; q < (n >> 2); q += t_per) {
            const int i = 4 * q;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
            if (live && i < n_in) {
                const float4 wq = __ldg(reinterpret_cast<const float4*>(w) + q);
                a = __ldg(reinterpret_cast<const float4*>(xr_v) + q);
                c = __ldg(reinterpret_cast<const float4*>(xi_v) + q);
                a = make_float4(a.x * wq.x * scale, a.y * wq.y * scale,
                                a.z * wq.z * scale, a.w * wq.w * scale);
                c = make_float4(c.x * wq.x * scale, c.y * wq.y * scale,
                                c.z * wq.z * scale, c.w * wq.w * scale);
            }
            const int p = pad(i);  // i % 4 == 0: the 4 words share one pad
            sr[p] = a.x; sr[p + 1] = a.y; sr[p + 2] = a.z; sr[p + 3] = a.w;
            si[p] = c.x; si[p + 1] = c.y; si[p + 2] = c.z; si[p + 3] = c.w;
        }
    } else {
        for (int i = j; i < n; i += t_per) {
            float a = 0.f, c = 0.f;
            if (live && i < n_in) {
                const float wi = __ldg(w + i) * scale;
                a = __ldg(xr_v + i) * wi;
                c = __ldg(xi_v + i) * wi;
            }
            sr[pad(i)] = a;
            si[pad(i)] = c;
        }
    }
    __syncthreads();

    // Radix-8 passes, then the remainder (dft_cuda.fft_plan).
    const int n8 = log2n / 3;
    const int rem = log2n % 3;
    float2 x[8];
    int ns = 1;
    const int full8 = rem == 0 ? n8 - 1 : n8;
    for (int p = 0; p < full8; ++p) {
        pass<8>(x, sr, si, dr, di, tw, n, ns, j);
        float* t = sr; sr = dr; dr = t;
        t = si; si = di; di = t;
        ns *= 8;
    }
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    float* ore = out_re + (live ? v : 0) * n;
    float* oim = out_im + (live ? v : 0) * n;
    if (rem == 0) {
        load_pass<8>(x, sr, si, tw, n, ns, j);
        store_last<8>(x, ore, oim, n, j, live, best, best_i);
    } else if (rem == 1) {
        load_pass<2>(x, sr, si, tw, n, ns, j);
        store_last<2>(x, ore, oim, n, j, live, best, best_i);
    } else {
        load_pass<4>(x, sr, si, tw, n, ns, j);
        store_last<4>(x, ore, oim, n, j, live, best, best_i);
    }
    if (!with_maxmag) return;

    // Each voxel's arg-max, first-occurrence tie-break: warp tree, then
    // the voxel's warps in order.
    __shared__ float s_bv[kFftMaxThreads / 32];
    __shared__ int s_bi[kFftMaxThreads / 32];
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        better(best, best_i, ov, oi);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_bv[warp] = best;
        s_bi[warp] = best_i;
    }
    __syncthreads();
    if (j == 0 && live) {
        const int w0 = (vib * t_per) >> 5;
        float bv = s_bv[w0];
        int bi = s_bi[w0];
        for (int wi = 1; wi < (t_per >> 5); ++wi)
            better(bv, bi, s_bv[w0 + wi], s_bi[w0 + wi]);
        maxmag[v] = bv;
        maxidx[v] = bi;
    }
}

}  // namespace

extern "C" int xmt_spectrum(
    const float* xr, const float* xi, const float* w,
    const float* f1t_re, const float* f1t_im,
    const float* twt_re, const float* twt_im,
    const float* f2_re, const float* f2_im,
    float* out_re, float* out_im, float* maxmag, int* maxidx,
    int b, int n_in, int n_out, int n2, int with_maxmag, void* stream) {
    const size_t smem = sizeof(float) * (2 * (size_t)n_in + 2 * (size_t)n_out);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(spectrum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    if (b > 0) {
        spectrum_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            xr, xi, w, f1t_re, f1t_im, twt_re, twt_im, f2_re, f2_im,
            out_re, out_im, maxmag, maxidx, n_in, n_out, n2, with_maxmag);
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spectrum_fft(
    const float* xr, const float* xi, const float* w, const float* tw,
    float* out_re, float* out_im, float* maxmag,
    int* maxidx, int b, int n_in, int log2n, float scale, int with_maxmag,
    int vec_load, void* stream) {
    const int n = 1 << log2n;
    const int t_per = n >> 3;
    if (log2n < 8 || t_per > kFftMaxThreads || n_in > n)
        return (int)cudaErrorInvalidValue;
    const int threads = t_per < kFftBlock ? kFftBlock : t_per;
    const int vpb = threads / t_per;
    const size_t smem = sizeof(float) * 4 * (size_t)vpb * (n + (n >> 5));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            spectrum_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (b > 0) {
        spectrum_fft_kernel<<<(b + vpb - 1) / vpb, threads, smem,
                              (cudaStream_t)stream>>>(
            xr, xi, w, reinterpret_cast<const float2*>(tw), out_re, out_im,
            maxmag, maxidx, b, n_in,
            log2n, scale, with_maxmag, vec_load);
    }
    return (int)cudaGetLastError();
}
