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
// rows: this kernel is K2's warp evaluation (lm_v9_warp.cuh) at q_n = 1
// with an identity fold — one free slot per active row, scale 1 and
// dx/du = 1, so every coefficient is multiplied by exactly 1.0 — the direct
// exp/sin/cos basis (v8 never factors it) and H dense: the voxel's (A,) g
// and (A, A) H, physical active rows, no fold and no slab.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID and writes
// A^2 + A + 1 floats (1.7 KB at A = 20); the work is the K direct bases (an
// exp and a sincos per peak and sample) and 15 pair moments of three powers
// plus 5 residual moments of two over 1024 samples: fp32 issue-bound, the
// transcendentals on the SFUs beside it, not memory-bound.  Design: K2's,
// one warp per voxel, 8 voxels a block, the bases and moments in registers
// in one sweep over the samples (one pass at K = 5; three at K = 8, each
// re-forming the direct bases); each voxel's A x A block is staged in
// shared memory and stored contiguous.  A voxel whose mask entry is 0
// returns at once and leaves its outputs unspecified.

#include "lm_v9_warp.cuh"

namespace {

constexpr int kPassBudget = 112;  // accumulator floats a moment pass keeps
constexpr int kMinBlocks = 1;     // blocks an SM must hold (register cap)

}  // namespace

extern "C" int xmt_eq6_normal_eq_v8(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const unsigned char* mask, const int* ints, const float* row_scale,
    float* cost, float* g, float* h, int b, int n_t, int n_peaks, int n_rows,
    float w_cs_unit, void* stream) {
    if (n_peaks < 1 || n_peaks > kMaxPeaks || n_rows < 1 || n_rows > kMaxFree)
        return (int)cudaErrorInvalidValue;
    const WarpArgs a{params, y_re, y_im, t, /*dxdu=*/nullptr, mask,
                     /*cost_prev=*/nullptr,
                     unpack_structure(ints, n_rows, n_rows), row_scale, cost,
                     g, h, b, n_t, n_rows, n_rows, /*factored=*/0, 0,
                     w_cs_unit};
    return launch_warp_any<WarpConfig</*slab H=*/false, kPassBudget,
                                      kMinBlocks>, 1, 1>(a, n_peaks, 1,
                                                         (cudaStream_t)stream);
}
