// K9: Eq.6 cost, gradient and Gauss-Newton Hessian per voxel over the
// prior's active physical rows, from three complex moments (the "v8"
// formulation, every g fixed at 0).
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v8
// (_normal_eq_kernel_v8).  With every g fixed at 0 each Jacobian row is
// (alpha + i beta) t^p B_k with p <= 1 (amplitude 1/a, shift i 2 pi MHz t,
// linewidth -pi t, phase i pi/180), so H = J J^T needs only the pair moments
// M_q[k,k'] = sum_t t^q B_k conj(B_k'), q <= 2, and g = J r the residual
// moments N_q[k], q <= 1.  That is K2's evaluation restricted to degree-1
// rows: this kernel runs K2's body (`v9_eval`, lm_v9_eval.cuh) with an
// identity fold — one free slot per active row, scale 1 and dx/du = 1, so
// every coefficient is multiplied by exactly 1.0 — and the direct
// exp/sin/cos basis (v8 never factors it).  v9_eval writes g_f to
// g_out[f] and H(f, h) to h_out[(f*A + h) * stride]: with the voxel's
// (A,) and (A, A) blocks as g_out and h_out and stride 1, that is v8's
// output layout, physical active rows, dense H, no fold and no slab, so no
// other kernel body is needed.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID and writes
// A^2 + A + 1 floats (1.7 KB at A = 20); the work is the K direct bases
// (an exp and a sincos per peak and sample) and 15 pair moments of three
// powers plus 5 residual moments of two over 1024 samples, ~0.15 MFLOP per
// voxel: fp32 issue-bound, not memory-bound.  Design: K2's, one block of
// 256 threads per voxel, the bases and the residual in shared memory, one
// warp per moment group.  A voxel whose mask entry is 0 returns at once and
// leaves its outputs unspecified.

#include "lm_v9_eval.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) normal_eq_v8_kernel(
    const float* __restrict__ params,   // (B, K*5) physical parameters
    const float* __restrict__ y_re,     // (B, n_t)
    const float* __restrict__ y_im,
    const float* __restrict__ t,        // (n_t,)
    const unsigned char* __restrict__ mask,  // (B,) or null
    Structure st,                        // identity fold over the A rows
    const float* __restrict__ row_scale,  // (A,) ones
    float* __restrict__ cost_out,        // (B,)
    float* __restrict__ g_out,           // (B, A)
    float* __restrict__ h_out,           // (B, A, A)
    int n_t, int n_peaks, int n_rows, float w_cs_unit) {
    const long long v = blockIdx.x;
    if (mask != nullptr && mask[v] == 0) return;
    const int tid = threadIdx.x;

    extern __shared__ float smem[];
    float* s_t = smem;  // n_t, then v9_eval's work area
    __shared__ float s_par[kMaxPeaks * 5];
    __shared__ float s_dx[kMaxFree];

    for (int i = tid; i < n_peaks * 5; i += kThreads)
        s_par[i] = params[v * n_peaks * 5 + i];
    for (int i = tid; i < n_rows; i += kThreads) s_dx[i] = 1.f;
    for (int i = tid; i < n_t; i += kThreads) s_t[i] = t[i];
    __syncthreads();

    v9_eval(s_par, s_dx, smem, y_re + v * n_t, y_im + v * n_t, st, row_scale,
            cost_out + v, g_out + v * n_rows, h_out + v * n_rows * n_rows, 1,
            n_t, n_peaks, n_rows, n_rows, /*q_n=*/1, /*factored=*/0,
            w_cs_unit, nullptr);
}

}  // namespace

extern "C" int xmt_eq6_normal_eq_v8(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const unsigned char* mask, const int* ints, const float* row_scale,
    float* cost, float* g, float* h, int b, int n_t, int n_peaks, int n_rows,
    float w_cs_unit, void* stream) {
    if (n_peaks < 1 || n_peaks > kMaxPeaks || n_rows < 1 || n_rows > kMaxFree)
        return (int)cudaErrorInvalidValue;
    const Structure st = unpack_structure(ints, n_rows, n_rows);
    const size_t smem = v9_smem_floats(n_t, n_peaks, 1) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            normal_eq_v8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (b > 0) {
        normal_eq_v8_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            params, y_re, y_im, t, mask, st, row_scale, cost, g, h, n_t,
            n_peaks, n_rows, w_cs_unit);
    }
    return (int)cudaGetLastError();
}
