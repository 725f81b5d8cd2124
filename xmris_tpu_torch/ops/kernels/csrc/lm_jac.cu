// K7 (v3), K12 (v5), K11 (v6), K10 (v7), K13 (v2) and K14 (v1): Eq.6
// cost, gradient and Gauss-Newton Hessian per voxel from the explicit
// Jacobian, in physical-parameter space.
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v3
// (_normal_eq_kernel_v3; K7), _v5 (K12), _v6 (K11), _v7 (K10), _v2 (K13) and
// eq6_normal_equations_pallas (v1; K14): one function on two row sets, all
// 5K physical rows (v1, v2, v3) or the prior's active rows (v5, v6, v7).
// v1 and v2 compute v3's function with v3's per-sample formulas (only
// their TPU reduction layouts differ), so their entries run this kernel
// unchanged.  Per voxel: the K peak bases B_k(t) = a_k exp(-pi lw_k
// ((1 - g_k) + g_k t) t) e^{i (2 pi MHz cs_k t + phi_k)}, the residual
// r = y - sum_k B_k and the cost; the Jacobian rows d(model)/d(parameter)
// of the requested physical parameters k*5 + p, with the reference's
// per-sample formulas; then H = Re(J) Re(J)^T + Im(J) Im(J)^T and
// g = Re(J) r_re + Im(J) r_im over the rows.  Two switches:
//   * `mask` (v6, v7): a voxel whose entry is 0 (done in the LM) returns at
//     once and leaves its outputs unspecified, as the reference's skipped
//     tiles do (it skips a tile of 8 voxels when all are done; the port
//     each done voxel).  v6's other change, stacking voxels into one MXU
//     dot, is a TPU tactic with no counterpart here: v6 is v5 plus the mask.
//   * `factored` (v7; uniform t, n_t % 128 == 0): the bases come from the
//     block-factored tables of K2 (`factored_tables`, lm_v9_eval.cuh), built
//     once per voxel: one exp and sincos per peak and table entry
//     (K * (128 + n_t/128)) instead of per peak and sample (K * n_t); a peak
//     whose g is fixed at 0 factors whole, the others keep their envelope
//     per sample and factor the angle.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID and writes
// R^2 + R + 1 floats (2.6 KB at R = 25); the work is R(R+1)/2 + R output
// entries of 2 n_t multiply-adds each, ~0.7 MFLOP per voxel at R = 25 and
// n_t = 1024, 23 GFLOP per bench grid: fp32 issue-bound (~0.35 ms at
// 67 TFLOP/s).  The Jacobian, 200 KB per voxel at R = 25, does not fit in
// shared memory whole, so the time axis streams through in chunks.
//
// Design: register tiling of the Gram product.  The residual is row R of
// the chunk's Jacobian, so g is H's extra column and the (R+1)-row Gram
// upper triangle, cut into 4x4 tiles, holds every output entry.  One warp
// owns one voxel (4 voxels a block, no block barrier after the start):
//   1. each lane evaluates one sample of the 32-sample chunk: the bases,
//      the model and residual, its cost term, and the R Jacobian values,
//      written as float4 row groups into the chunk's [sample][row] table
//      (re rows, then im rows; sample pitch 8*nb + 4 words, so the 8 lanes
//      of a 16-byte store phase hit 8 distinct bank groups);
//   2. each lane owns up to 3 tiles (28 tiles at R = 25, one round) and, per
//      sample, loads its two row groups as four 16-byte loads (a lane's
//      row groups are shared by the lanes of its tile row and column, so a
//      load has at most nb distinct addresses) and does 32 multiply-adds:
//      8 words loaded per 16 multiply-adds, where the one-entry-per-thread
//      scheme it replaced loaded 4 words per 2.
// Every entry keeps its own sequence of operations: a = fmaf(re_r, re_s, a)
// then a = fmaf(im_r, im_s, a), samples ascending, chunk after chunk, and
// the cost's per-sample sums meet in the order of a 256-thread block with
// 128-sample chunks (lane l's accumulator w takes the samples i with
// i % 128 == 32 w + l; four warp sums, then their sum in order).  So H, g
// and the cost equal, bit for bit, those of the one-entry-per-thread
// kernel this design replaced, whatever the tile shape or chunk length.
// Plain fp32 multiply-adds: no tensor cores, no TF32.  H is written dense
// row-major (B, R, R), both triangles; nothing is padded.

#include "lm_v9_eval.cuh"

namespace {

constexpr int kChunk = 32;    // samples per chunk: one per lane
constexpr int kTile = 4;      // a lane's tile: kTile x kTile Gram entries
constexpr int kVoxels = 4;    // voxels (warps) per block
constexpr int kMaxGroups = (kMaxRows + 1 + kTile - 1) / kTile;
constexpr int kMaxTiles = kMaxGroups * (kMaxGroups + 1) / 2;
constexpr int kMaxRounds = (kMaxTiles + 31) / 32;

// Row groups of 4 (the R rows and the residual), the chunk table's sample
// pitch, and the floats of one voxel's shared area: the chunk table, the
// chunk's bases and, with `factored`, K2's tables.  A multiple of 4 floats,
// so every voxel's table starts 16-byte aligned.
__host__ __device__ inline int row_groups(int n_rows) {
    return (n_rows + kTile) / kTile;
}
__host__ __device__ inline int sample_pitch(int n_rows) {
    return 2 * kTile * row_groups(n_rows) + 4;
}
__host__ __device__ inline int voxel_floats(int n_rows, int n_peaks, int n_t,
                                            int factored) {
    const int tables =
        factored ? n_peaks * (2 * kBlockT + 2 * (n_t / kBlockT)) : 0;
    const int n = kChunk * sample_pitch(n_rows) + 2 * n_peaks * kChunk + tables;
    return (n + 3) & ~3;
}

// Jacobian row d(model)/d(parameter j) at one sample from the peak's basis
// (br, bi), in the reference's per-sample formulas.
__device__ __forceinline__ void jac_row(int j, const float* s_par,
                                        const int* s_gz, float br, float bi,
                                        float ti, float w_cs_unit, float* jr,
                                        float* ji) {
    const int k = j / 5;
    switch (j % 5) {
        case 0: {  // amplitude
            const float a = s_par[k * 5 + 0];
            const float safe = (a == 0.f) ? 1.f : a;
            *jr = br / safe;
            *ji = bi / safe;
            break;
        }
        case 1: {  // chemical shift
            const float w = w_cs_unit * ti;
            *jr = -w * bi;
            *ji = w * br;
            break;
        }
        case 2: {  // linewidth (v7: damp profile t if g == 0)
            const float gg = s_par[k * 5 + 4];
            const float w =
                s_gz[k] ? -kPi * ti : -kPi * ((1.f - gg + gg * ti) * ti);
            *jr = w * br;
            *ji = w * bi;
            break;
        }
        case 3:  // phase
            *jr = -kDeg * bi;
            *ji = kDeg * br;
            break;
        default: {  // g
            const float d = kPi * s_par[k * 5 + 2];
            const float w = -d * (ti * ti - ti);
            *jr = w * br;
            *ji = w * bi;
            break;
        }
    }
}

template <int kRounds>
__global__ void __launch_bounds__(kVoxels * 32) normal_eq_jac_kernel(
    const float* __restrict__ params,   // (B, K*5) physical parameters
    const float* __restrict__ y_re,     // (B, n_t)
    const float* __restrict__ y_im,
    const float* __restrict__ t,        // (n_t,)
    const int* __restrict__ rows,       // (R,) flat indices k*5 + p
    const unsigned char* __restrict__ mask,  // (B,) or null
    const int* __restrict__ g_zero,     // (K,) g fixed at 0 (factored only)
    float* __restrict__ cost_out,       // (B,)
    float* __restrict__ g_out,          // (B, R)
    float* __restrict__ h_out,          // (B, R, R)
    int b, int n_t, int n_peaks, int n_rows, int factored, float w_cs_unit) {
    const int lane = threadIdx.x & 31;
    const int wv = threadIdx.x >> 5;
    const long long v = (long long)blockIdx.x * kVoxels + wv;
    const int nb = row_groups(n_rows);
    const int n_p = kTile * nb;              // words of one plane's rows
    const int pitch = sample_pitch(n_rows);  // 2 n_p + 4
    const int n_q = n_t / kBlockT;

    extern __shared__ float4 smem4[];
    float* s_j = reinterpret_cast<float*>(smem4) +
                 wv * voxel_floats(n_rows, n_peaks, n_t, factored);
    float* s_bre = s_j + kChunk * pitch;          // K * kChunk
    float* s_bim = s_bre + n_peaks * kChunk;      // K * kChunk
    float* s_gr_re = s_bim + n_peaks * kChunk;    // K * 128 (factored)
    float* s_gr_im = s_gr_re + n_peaks * kBlockT;
    float* s_fq_re = s_gr_im + n_peaks * kBlockT;  // K * n_q (factored)
    float* s_fq_im = s_fq_re + n_peaks * n_q;
    __shared__ float s_par_all[kVoxels][kMaxPeaks * 5];
    __shared__ int s_rows[kMaxRows];
    __shared__ int s_gz[kMaxPeaks];

    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) s_rows[i] = rows[i];
    for (int i = threadIdx.x; i < n_peaks; i += blockDim.x)
        s_gz[i] = factored ? g_zero[i] : 0;
    __syncthreads();
    if (v >= b || (mask != nullptr && mask[v] == 0)) return;
    float* s_par = s_par_all[wv];
    for (int i = lane; i < n_peaks * 5; i += 32)
        s_par[i] = params[v * n_peaks * 5 + i];
    __syncwarp();
    if (factored) {
        factored_tables(s_par, t, s_gz, n_peaks, n_q, w_cs_unit, s_gr_re,
                        s_gr_im, s_fq_re, s_fq_im, lane, 32);
        __syncwarp();
    }

    // This lane's tiles (row group ga <= column group gb of the upper
    // triangle, row-major; -1: no tile) and their accumulators.
    const int n_tiles = nb * (nb + 1) / 2;
    int ga[kRounds], gb[kRounds];
    float acc[kRounds][kTile * kTile];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
        const int e = lane + 32 * u;
        ga[u] = -1;
        gb[u] = 0;
        if (e < n_tiles) {
            int a = 0, rem = e;
            while (rem >= nb - a) {
                rem -= nb - a;
                ++a;
            }
            ga[u] = a;
            gb[u] = a + rem;
        }
#pragma unroll
        for (int q = 0; q < kTile * kTile; ++q) acc[u][q] = 0.f;
    }
    // The cost's per-sample sums, by (sample % 128) / 32.
    float cost0 = 0.f, cost1 = 0.f, cost2 = 0.f, cost3 = 0.f;

    for (int c0 = 0; c0 < n_t; c0 += kChunk) {
        const int i = c0 + lane;
        const bool in = i < n_t;
        // 1a. Bases of every peak at this lane's sample (v3's formulas and
        // order; v7's block-factored form with `factored`).
        if (in) {
            const float ti = t[i];
            for (int k = 0; k < n_peaks; ++k) {
                const int idx = k * kChunk + lane;
                if (factored) {
                    const int r = i % kBlockT;
                    const int q = i / kBlockT;
                    const float gr = s_gr_re[k * kBlockT + r];
                    const float gi = s_gr_im[k * kBlockT + r];
                    const float fr = s_fq_re[k * n_q + q];
                    const float fi = s_fq_im[k * n_q + q];
                    if (s_gz[k]) {
                        s_bre[idx] = fr * gr - fi * gi;
                        s_bim[idx] = fr * gi + fi * gr;
                    } else {
                        const float gg = s_par[k * 5 + 4];
                        const float d = kPi * s_par[k * 5 + 2];
                        const float dp = (1.f - gg + gg * ti) * ti;
                        const float env = s_par[k * 5 + 0] * expf(-d * dp);
                        s_bre[idx] = env * (fr * gr - fi * gi);
                        s_bim[idx] = env * (fr * gi + fi * gr);
                    }
                    continue;
                }
                const float amp = s_par[k * 5 + 0];
                const float cs = s_par[k * 5 + 1];
                const float lw = s_par[k * 5 + 2];
                const float ph = s_par[k * 5 + 3];
                const float gg = s_par[k * 5 + 4];
                const float d = kPi * lw;
                const float dp = (1.f - gg + gg * ti) * ti;
                const float env = amp * expf(-d * dp);
                const float ang = w_cs_unit * cs * ti + ph * kDeg;
                float sn, cn;
                sincosf(ang, &sn, &cn);
                s_bre[idx] = env * cn;
                s_bim[idx] = env * sn;
            }
        }
        __syncwarp();
        // 1b. Residual and cost; then the Jacobian rows and the residual as
        // row R, 4 rows to a 16-byte store; zeros past the end of the axis.
        float r_re = 0.f, r_im = 0.f, ti = 0.f;
        if (in) {
            ti = t[i];
            float m_re = 0.f, m_im = 0.f;
            for (int k = 0; k < n_peaks; ++k) {  // never fused with a basis
                m_re = __fadd_rn(m_re, s_bre[k * kChunk + lane]);
                m_im = __fadd_rn(m_im, s_bim[k * kChunk + lane]);
            }
            r_re = y_re[v * n_t + i] - m_re;
            r_im = y_im[v * n_t + i] - m_im;
            switch ((c0 / kChunk) & 3) {
                case 0: cost0 += r_re * r_re + r_im * r_im; break;
                case 1: cost1 += r_re * r_re + r_im * r_im; break;
                case 2: cost2 += r_re * r_re + r_im * r_im; break;
                default: cost3 += r_re * r_re + r_im * r_im; break;
            }
        }
        float* row = s_j + lane * pitch;
        for (int a = 0; a < nb; ++a) {
            float jr[kTile], ji[kTile];
#pragma unroll
            for (int p = 0; p < kTile; ++p) {
                const int r = a * kTile + p;
                jr[p] = 0.f;
                ji[p] = 0.f;
                if (!in) continue;
                if (r < n_rows) {
                    const int j = s_rows[r];
                    jac_row(j, s_par, s_gz, s_bre[(j / 5) * kChunk + lane],
                            s_bim[(j / 5) * kChunk + lane], ti, w_cs_unit,
                            &jr[p], &ji[p]);
                } else if (r == n_rows) {
                    jr[p] = r_re;
                    ji[p] = r_im;
                }
            }
            *reinterpret_cast<float4*>(row + a * kTile) =
                make_float4(jr[0], jr[1], jr[2], jr[3]);
            *reinterpret_cast<float4*>(row + n_p + a * kTile) =
                make_float4(ji[0], ji[1], ji[2], ji[3]);
        }
        __syncwarp();
        // 2. Each tile adds the chunk: per entry sum_c re_r re_s + im_r im_s.
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
            if (ga[u] < 0) continue;
            const float* pa = s_j + ga[u] * kTile;
            const float* pb = s_j + gb[u] * kTile;
#pragma unroll 4
            for (int c = 0; c < kChunk; ++c) {
                const float4 xr = *reinterpret_cast<const float4*>(pa + c * pitch);
                const float4 xi =
                    *reinterpret_cast<const float4*>(pa + c * pitch + n_p);
                const float4 yr = *reinterpret_cast<const float4*>(pb + c * pitch);
                const float4 yi =
                    *reinterpret_cast<const float4*>(pb + c * pitch + n_p);
                const float ar[kTile] = {xr.x, xr.y, xr.z, xr.w};
                const float ai[kTile] = {xi.x, xi.y, xi.z, xi.w};
                const float br[kTile] = {yr.x, yr.y, yr.z, yr.w};
                const float bi[kTile] = {yi.x, yi.y, yi.z, yi.w};
#pragma unroll
                for (int p = 0; p < kTile; ++p) {
#pragma unroll
                    for (int q = 0; q < kTile; ++q) {
                        float& e = acc[u][p * kTile + q];
                        e = fmaf(ar[p], br[q], e);
                        e = fmaf(ai[p], bi[q], e);
                    }
                }
            }
        }
        __syncwarp();
    }

    // The cost: four warp sums (the 128-sample block's four warps), added
    // in order.
    const float s0 = warp_sum(cost0), s1 = warp_sum(cost1);
    const float s2 = warp_sum(cost2), s3 = warp_sum(cost3);
    if (lane == 0) {
        float c = 0.f;
        c += s0;
        c += s1;
        c += s2;
        c += s3;
        cost_out[v] = c;
    }
    const long long rr = (long long)n_rows * n_rows;
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
        if (ga[u] < 0) continue;
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
#pragma unroll
            for (int q = 0; q < kTile; ++q) {
                const int r = ga[u] * kTile + p;
                const int s = gb[u] * kTile + q;
                if (r > s || r >= n_rows || s > n_rows) continue;
                const float val = acc[u][p * kTile + q];
                if (s == n_rows) {
                    g_out[v * n_rows + r] = val;
                } else {
                    h_out[v * rr + r * n_rows + s] = val;
                    if (s != r) h_out[v * rr + s * n_rows + r] = val;
                }
            }
        }
    }
}

template <int kRounds>
int launch(const float* params, const float* y_re, const float* y_im,
           const float* t, const int* rows, const unsigned char* mask,
           const int* g_zero, float* cost, float* g, float* h, int b, int n_t,
           int n_peaks, int n_rows, int factored, float w_cs_unit,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) * kVoxels *
                        (size_t)voxel_floats(n_rows, n_peaks, n_t, factored);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            normal_eq_jac_kernel<kRounds>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (b > 0) {
        normal_eq_jac_kernel<kRounds>
            <<<(b + kVoxels - 1) / kVoxels, kVoxels * 32, smem, stream>>>(
                params, y_re, y_im, t, rows, mask, g_zero, cost, g, h, b, n_t,
                n_peaks, n_rows, factored, w_cs_unit);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xmt_eq6_normal_eq_jac(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const int* rows, const unsigned char* mask, const int* g_zero, float* cost,
    float* g, float* h, int b, int n_t, int n_peaks, int n_rows, int factored,
    float w_cs_unit, void* stream) {
    if (n_peaks < 1 || n_peaks > kMaxPeaks || n_rows < 1 ||
        n_rows > kMaxRows || (factored && (n_t % kBlockT != 0 || !g_zero)))
        return (int)cudaErrorInvalidValue;
    const int nb = row_groups(n_rows);
    const int rounds = (nb * (nb + 1) / 2 + 31) / 32;
    static_assert(kMaxRounds == 3, "one instance per round count");
    const auto s = (cudaStream_t)stream;
    if (rounds == 1)
        return launch<1>(params, y_re, y_im, t, rows, mask, g_zero, cost, g, h,
                         b, n_t, n_peaks, n_rows, factored, w_cs_unit, s);
    if (rounds == 2)
        return launch<2>(params, y_re, y_im, t, rows, mask, g_zero, cost, g, h,
                         b, n_t, n_peaks, n_rows, factored, w_cs_unit, s);
    return launch<3>(params, y_re, y_im, t, rows, mask, g_zero, cost, g, h, b,
                     n_t, n_peaks, n_rows, factored, w_cs_unit, s);
}
