// K2: Eq.6 cost, gradient and Gauss-Newton Hessian per voxel, in free-
// parameter space, from complex moments (the "v9" formulation).
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v9
// (_normal_eq_kernel_v9 / _v9_tile_eval) with the free-space fold.  The
// evaluation itself is `v9_eval` in lm_v9_eval.cuh (shared with K8).
//
// What bounds it on the H100: per voxel it reads 8 KB of FID (134 MB per
// bench grid) and writes 1.6 KB of H (26 MB); the work is ~55 complex
// moment sums over 1024 samples plus K*1024 basis points, a few hundred
// kFLOP — fp32 issue-bound, not memory-bound.  Design: one block per voxel
// (see lm_v9_eval.cuh).  H is written in the port's voxel-minor slab layout
// (F*F, B), so the SPD kernels read it coalesced.  Voxels whose mask entry
// is 0 (done in the LM) return at once and leave their outputs unspecified:
// the LM loop discards them.  The accept gate (`cost_prev`, optional): a
// voxel whose trial cost is not below its previous accepted cost writes its
// cost and skips the moments, g and H (left unspecified), the LM loop
// taking only the cost of a rejected trial.  The reference gates per tile
// of voxels, when no voxel of the tile improves; per voxel, the outputs the
// loop consumes are the same.

#include "lm_v9_eval.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) normal_eq_v9_kernel(
    const float* __restrict__ params,   // (B, K*5) physical parameters
    const float* __restrict__ y_re,     // (B, n_t)
    const float* __restrict__ y_im,
    const float* __restrict__ t,        // (n_t,)
    const float* __restrict__ dxdu,     // (B, F)
    const unsigned char* __restrict__ mask,  // (B,) or null
    const float* __restrict__ cost_prev,     // (B,) or null
    Structure st,
    const float* __restrict__ row_scale,  // (A,)
    float* __restrict__ cost_out,        // (B,)
    float* __restrict__ g_out,           // (B, F)
    float* __restrict__ h_out,           // (F*F, B)
    int b, int n_t, int n_peaks, int n_free, int n_rows, int q_n,
    int factored, float w_cs_unit) {
    const int v = blockIdx.x;
    if (mask != nullptr && mask[v] == 0) return;
    const int tid = threadIdx.x;

    extern __shared__ float smem[];
    float* s_t = smem;  // n_t, then v9_eval's work area
    __shared__ float s_par[kMaxPeaks * 5];
    __shared__ float s_dx[kMaxFree];

    for (int i = tid; i < n_peaks * 5; i += kThreads)
        s_par[i] = params[(long long)v * n_peaks * 5 + i];
    for (int i = tid; i < n_free; i += kThreads)
        s_dx[i] = dxdu[(long long)v * n_free + i];
    for (int i = tid; i < n_t; i += kThreads) s_t[i] = t[i];
    __syncthreads();

    v9_eval(s_par, s_dx, smem, y_re + (long long)v * n_t,
            y_im + (long long)v * n_t, st, row_scale, cost_out + v,
            g_out + (long long)v * n_free, h_out + v, b, n_t, n_peaks,
            n_free, n_rows, q_n, factored, w_cs_unit,
            cost_prev != nullptr ? cost_prev + v : nullptr);
}

}  // namespace

extern "C" int xmt_eq6_normal_eq_v9(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const float* dxdu, const unsigned char* mask, const float* cost_prev,
    const int* ints, const float* row_scale, float* cost, float* g, float* h,
    int b, int n_t, int n_peaks, int n_free, int n_rows, int q_n,
    int factored, float w_cs_unit, void* stream) {
    const Structure st = unpack_structure(ints, n_rows, n_free);
    const size_t smem = v9_smem_floats(n_t, n_peaks, q_n) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(normal_eq_v9_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    if (b > 0) {
        normal_eq_v9_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            params, y_re, y_im, t, dxdu, mask, cost_prev, st, row_scale, cost,
            g, h, b, n_t, n_peaks, n_free, n_rows, q_n, factored, w_cs_unit);
    }
    return (int)cudaGetLastError();
}
