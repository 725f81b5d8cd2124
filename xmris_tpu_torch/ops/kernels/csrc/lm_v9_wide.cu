// K2 past the narrow caps: the same evaluation as lm_v9.cu (the warp
// evaluation of lm_v9_warp.cuh, H as the voxel-minor slab) for priors of
// more than kMaxPeaks peaks, kMaxFree free parameters or kMaxRows active
// rows (lm_v9_eval.cuh), up to kWidePeaks peaks, kWideRows rows and
// kWideFree free parameters (the SPD kernels' kMaxF): the 12-line 7 T
// brain 31P prior (K = 12, F = 48, 48 rows).  lm_v9.cu keeps the narrow
// priors and its build; the wrapper (ops/kernels/lm_cuda.py) picks this
// entry from the plan on the host.
//
// What bounds it on the H100: as lm_v9.cu, fp32 issue.  At K = 12 and
// q_n = 1 a sample updates 516 accumulator floats (12 residual moments of
// 2 powers, 78 pair moments of 3) against 110 at the bench's K = 5, about
// 4.3x the work a call.  Design: the narrow kernel's, with the budget and
// register cap of K9 (112 accumulator floats a pass, five sweeps over the
// samples at K = 12, q_n = 1; 1 block an SM, which the voxel areas' shared
// memory, ~148 KB at n_t = 1024, allows anyway).  The instantiations are
// K = 9..12 at q_n = 0..2, and K = 7, 8 at q_n = 2: a prior of at most 8
// peaks passes the narrow caps unless a freed g (q_n = 2) takes it past
// 32 free parameters.

#include "lm_v9_warp.cuh"

namespace {

constexpr int kWidePeaks = 12;
constexpr int kWideRows = 5 * kWidePeaks;
constexpr int kWideFree = 48;  // spd.cu's kMaxF: the LM's step must follow
constexpr bool kSlabH = true;     // H as the voxel-minor slab (F*F, B)
constexpr int kPassBudget = 112;  // accumulator floats a moment pass keeps
constexpr int kMinBlocks = 1;     // blocks an SM must hold (register cap)

using Wide = WarpConfig<kSlabH, kPassBudget, kMinBlocks>;

}  // namespace

extern "C" int xmt_eq6_normal_eq_v9_wide(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const float* dxdu, const unsigned char* mask, const float* cost_prev,
    const int* ints, const float* row_scale, float* cost, float* g, float* h,
    int b, int n_t, int n_peaks, int n_free, int n_rows, int q_n,
    int factored, float w_cs_unit, void* stream) {
    if (n_free < 1 || n_free > kWideFree || n_rows < 1 || n_rows > kWideRows)
        return (int)cudaErrorInvalidValue;
    const WarpArgs a{params, y_re, y_im, t, dxdu, mask, cost_prev,
                     unpack_structure(ints, n_rows, n_free), row_scale,
                     cost, g, h, b, n_t, n_free, n_rows, factored, 0,
                     w_cs_unit};
    if (n_peaks > kMaxPeaks)
        return launch_warp_any<Wide, 0, kMaxQn, kMaxPeaks + 1, kWidePeaks>(
            a, n_peaks, q_n, (cudaStream_t)stream);
    return launch_warp_any<Wide, kMaxQn, kMaxQn, kMaxPeaks - 1, kMaxPeaks>(
        a, n_peaks, q_n, (cudaStream_t)stream);
}
