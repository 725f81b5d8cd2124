// K2: Eq.6 cost, gradient and Gauss-Newton Hessian per voxel, in free-
// parameter space, from complex moments (the "v9" formulation).
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v9
// (_normal_eq_kernel_v9 / _v9_tile_eval) with the free-space fold.  The
// evaluation is the warp evaluation of lm_v9_warp.cuh (shared with K9);
// the whole-loop K8 keeps the block evaluation `v9_eval` of lm_v9_eval.cuh,
// which computes the same outputs bit for bit.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID (134 MB per
// bench grid) and writes 1.6 KB of H (26 MB); the work is, per sample, the
// K factored bases and ~55 complex moment updates (~250 fp32 instructions
// at K = 5, q_n = 1) — fp32 issue-bound, not memory-bound.  Design: one
// warp per voxel, 8 voxels a block, the moments accumulated in registers
// (lm_v9_warp.cuh), 64 accumulator floats a pass (two sweeps over the
// samples at the bench shape, each re-forming the cheap factored bases) so
// that 2 blocks fit an SM.  H is written in the port's
// voxel-minor slab layout (F*F, B), so the SPD kernels read it coalesced:
// the block stages its voxels' H in shared memory and stores each slab row
// of its 8 voxels as one 32-byte sector.  Voxels whose mask entry is 0
// (done in the LM) return at once and leave their outputs unspecified: the
// LM loop discards them.  The accept gate (`cost_prev`, optional): a voxel
// whose trial cost is not below its previous accepted cost writes its cost
// (from a cost-only first pass) and skips the moments, g and H (left
// unspecified), the LM loop taking only the cost of a rejected trial.  The
// reference gates per tile of voxels, when no voxel of the tile improves;
// per voxel, the outputs the loop consumes are the same.

#include "lm_v9_warp.cuh"

namespace {

constexpr bool kSlabH = true;    // H as the voxel-minor slab (F*F, B)
constexpr int kPassBudget = 64;  // accumulator floats a moment pass keeps
constexpr int kMinBlocks = 2;    // blocks an SM must hold (register cap)

}  // namespace

extern "C" int xmt_eq6_normal_eq_v9(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const float* dxdu, const unsigned char* mask, const float* cost_prev,
    const int* ints, const float* row_scale, float* cost, float* g, float* h,
    int b, int n_t, int n_peaks, int n_free, int n_rows, int q_n,
    int factored, float w_cs_unit, void* stream) {
    if (n_free < 1 || n_free > kMaxFree || n_rows < 1 || n_rows > kMaxRows)
        return (int)cudaErrorInvalidValue;
    const WarpArgs a{params, y_re, y_im, t, dxdu, mask, cost_prev,
                     unpack_structure(ints, n_rows, n_free), row_scale,
                     cost, g, h, b, n_t, n_free, n_rows, factored, 0,
                     w_cs_unit};
    return launch_warp_any<WarpConfig<kSlabH, kPassBudget, kMinBlocks>, 0,
                           kMaxQn>(a, n_peaks, q_n, (cudaStream_t)stream);
}
