// K1: window -> zero-fill -> ortho DFT -> fftshift, plus each voxel's peak.
//
// Replaces xmris_tpu/ops/kernels/dft_pallas.py::spectrum_pallas
// (_spectrum_kernel with with_maxmag and stacked_out).  Same Cooley-Tukey
// split n_out = n1 * n2 with input index j = j1*n2 + j2 and output index
// k = k1 + n1*k2:
//
//   Y[k1, j2]  = sum_{j1 < n_in/n2} F1[k1, j1] * w[j] x[j]     stage 1
//   Y'[k1, j2] = Y[k1, j2] * TW[k1, j2]                        twiddle
//   X[k2, k1]  = sum_{j2} F2[k2, j2] * Y'[k1, j2]              stage 2
//
// Zero-fill is free (only j1 < n_in/n2 rows of stage 1 exist) and the
// fftshift is folded into F2's k2 rows by the host tables.
//
// What bounds it on the H100: at the bench shape (16384 voxels, 1024 ->
// 2048, n2 = 32) it reads 134 MB and writes 268 MB (~0.12 ms at 3.35 TB/s)
// and does ~1 MFLOP of fp32 FMA per voxel (~17 GFLOP, ~0.26 ms at the
// 67 TFLOP/s non-tensor fp32 peak): both bounds are close.  Design: one
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
