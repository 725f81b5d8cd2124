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
//   * `factored` (v7; uniform t, n_t % 128 == 0): the chunk's bases come
//     from the block-factored tables of K2 (`factored_tables`,
//     lm_v9_eval.cuh), built once per voxel: one exp and sincos per peak
//     and table entry (K * (128 + n_t/128)) instead of per peak and sample
//     (K * n_t), ~7x fewer; a peak whose g is fixed at 0 factors whole, the
//     others keep their envelope per sample and factor the angle.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID and writes
// R^2 + R + 1 floats (2.6 KB at R = 25); the work is R(R+1)/2 + R output
// entries of 2 n_t multiply-adds each, ~0.7 MFLOP per voxel at R = 25 and
// n_t = 1024, 23 GFLOP per bench grid: fp32 issue-bound (~0.35 ms at
// 67 TFLOP/s).  The Jacobian, 200 KB per voxel at R = 25, does not fit in
// shared memory whole.  Design: one block of 256 threads per voxel streams
// the time axis in chunks of 128 samples.  For each chunk the bases, the
// residual and the chunk's J rows (row pitch 129 words, so that threads on
// consecutive rows read distinct banks) are built in shared memory; then
// every thread adds the chunk to its output entries (upper-triangle H
// entries, then g; at most 4 a thread), held in registers across chunks.
// Plain fp32 multiply-adds: no tensor cores, no TF32.  H is written dense
// row-major (B, R, R), both triangles; nothing is padded.  The
// transcendentals are a small share of the work (the Gram sums dominate),
// so the factored basis moves K10's time little against K11's.

#include "lm_v9_eval.cuh"

namespace {

constexpr int kChunk = kBlockT;        // time samples per chunk
constexpr int kPitch = kChunk + 1;     // J row pitch in shared memory
constexpr int kSlots =
    (kMaxRows * (kMaxRows + 1) / 2 + kMaxRows + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads) normal_eq_jac_kernel(
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
    int n_t, int n_peaks, int n_rows, int factored, float w_cs_unit) {
    const long long v = blockIdx.x;
    if (mask != nullptr && mask[v] == 0) return;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    extern __shared__ float smem[];
    float* s_jre = smem;                          // R * kPitch
    float* s_jim = s_jre + n_rows * kPitch;       // R * kPitch
    float* s_bre = s_jim + n_rows * kPitch;       // K * kChunk
    float* s_bim = s_bre + n_peaks * kChunk;      // K * kChunk
    float* s_rre = s_bim + n_peaks * kChunk;      // kChunk
    float* s_rim = s_rre + kChunk;                // kChunk
    const int n_q = n_t / kChunk;                 // factored: n_t % 128 == 0
    float* s_gr_re = s_rim + kChunk;              // K * kChunk (factored)
    float* s_gr_im = s_gr_re + n_peaks * kChunk;  // K * kChunk
    float* s_fq_re = s_gr_im + n_peaks * kChunk;  // K * n_q
    float* s_fq_im = s_fq_re + n_peaks * n_q;     // K * n_q
    __shared__ float s_par[kMaxPeaks * 5];
    __shared__ int s_rows[kMaxRows];
    __shared__ int s_gz[kMaxPeaks];
    __shared__ float s_red[kWarps];

    for (int i = tid; i < n_peaks * 5; i += kThreads)
        s_par[i] = params[v * n_peaks * 5 + i];
    for (int i = tid; i < n_rows; i += kThreads) s_rows[i] = rows[i];
    for (int i = tid; i < n_peaks; i += kThreads)
        s_gz[i] = factored ? g_zero[i] : 0;
    __syncthreads();
    if (factored) {
        factored_tables(s_par, t, s_gz, n_peaks, n_q, w_cs_unit, s_gr_re,
                        s_gr_im, s_fq_re, s_fq_im);
        __syncthreads();
    }

    // This thread's output entries: (r, s) of the upper triangle of H, then
    // (r, -1) for g_r; r = -1 marks an unused slot.
    const int n_h = n_rows * (n_rows + 1) / 2;
    int ent_r[kSlots], ent_s[kSlots];
    float acc[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
        const int e = tid + q * kThreads;
        acc[q] = 0.f;
        ent_r[q] = -1;
        ent_s[q] = -1;
        if (e < n_h) {
            int r = 0, rem = e;
            while (rem >= n_rows - r) {
                rem -= n_rows - r;
                ++r;
            }
            ent_r[q] = r;
            ent_s[q] = r + rem;
        } else if (e < n_h + n_rows) {
            ent_r[q] = e - n_h;
        }
    }

    float cost_acc = 0.f;
    for (int c0 = 0; c0 < n_t; c0 += kChunk) {
        const int n_c = min(kChunk, n_t - c0);
        // Bases of every peak on the chunk (v3's formulas and order; v7's
        // block-factored form, chunk = block q, with `factored`).
        for (int idx = tid; idx < n_peaks * kChunk; idx += kThreads) {
            const int k = idx / kChunk;
            const int c = idx % kChunk;
            if (c >= n_c) continue;
            if (factored) {
                const int q = c0 / kChunk;
                const float gr = s_gr_re[idx], gi = s_gr_im[idx];
                const float fr = s_fq_re[k * n_q + q];
                const float fi = s_fq_im[k * n_q + q];
                if (s_gz[k]) {
                    s_bre[idx] = fr * gr - fi * gi;
                    s_bim[idx] = fr * gi + fi * gr;
                } else {
                    const float ti = t[c0 + c];
                    const float gg = s_par[k * 5 + 4];
                    const float d = kPi * s_par[k * 5 + 2];
                    const float dp = (1.f - gg + gg * ti) * ti;
                    const float env = s_par[k * 5 + 0] * expf(-d * dp);
                    s_bre[idx] = env * (fr * gr - fi * gi);
                    s_bim[idx] = env * (fr * gi + fi * gr);
                }
                continue;
            }
            const float ti = t[c0 + c];
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
        __syncthreads();
        // Residual and cost; zeros past the end of the axis.
        for (int c = tid; c < kChunk; c += kThreads) {
            float r_re = 0.f, r_im = 0.f;
            if (c < n_c) {
                float m_re = 0.f, m_im = 0.f;
                for (int k = 0; k < n_peaks; ++k) {
                    m_re += s_bre[k * kChunk + c];
                    m_im += s_bim[k * kChunk + c];
                }
                r_re = y_re[v * n_t + c0 + c] - m_re;
                r_im = y_im[v * n_t + c0 + c] - m_im;
                cost_acc += r_re * r_re + r_im * r_im;
            }
            s_rre[c] = r_re;
            s_rim[c] = r_im;
        }
        // Jacobian rows on the chunk; zeros past the end of the axis.
        for (int idx = tid; idx < n_rows * kChunk; idx += kThreads) {
            const int r = idx / kChunk;
            const int c = idx % kChunk;
            float jr = 0.f, ji = 0.f;
            if (c < n_c) {
                const int j = s_rows[r];
                const int k = j / 5;
                const float br = s_bre[k * kChunk + c];
                const float bi = s_bim[k * kChunk + c];
                const float ti = t[c0 + c];
                switch (j % 5) {
                    case 0: {  // amplitude
                        const float a = s_par[k * 5 + 0];
                        const float safe = (a == 0.f) ? 1.f : a;
                        jr = br / safe;
                        ji = bi / safe;
                        break;
                    }
                    case 1: {  // chemical shift
                        const float w = w_cs_unit * ti;
                        jr = -w * bi;
                        ji = w * br;
                        break;
                    }
                    case 2: {  // linewidth (v7: damp profile t if g == 0)
                        const float gg = s_par[k * 5 + 4];
                        const float w =
                            s_gz[k] ? -kPi * ti
                                    : -kPi * ((1.f - gg + gg * ti) * ti);
                        jr = w * br;
                        ji = w * bi;
                        break;
                    }
                    case 3:  // phase
                        jr = -kDeg * bi;
                        ji = kDeg * br;
                        break;
                    default: {  // g
                        const float d = kPi * s_par[k * 5 + 2];
                        const float w = -d * (ti * ti - ti);
                        jr = w * br;
                        ji = w * bi;
                        break;
                    }
                }
            }
            s_jre[r * kPitch + c] = jr;
            s_jim[r * kPitch + c] = ji;
        }
        __syncthreads();
        // Each entry adds the chunk: sum_c a_re b_re + a_im b_im.
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
            const int r = ent_r[q];
            if (r < 0) continue;
            const int s = ent_s[q];
            const float* ar = s_jre + r * kPitch;
            const float* ai = s_jim + r * kPitch;
            const float* br = s >= 0 ? s_jre + s * kPitch : s_rre;
            const float* bi = s >= 0 ? s_jim + s * kPitch : s_rim;
            float a = acc[q];
#pragma unroll 8
            for (int c = 0; c < kChunk; ++c) {
                a = fmaf(ar[c], br[c], a);
                a = fmaf(ai[c], bi[c], a);
            }
            acc[q] = a;
        }
        __syncthreads();
    }

    cost_acc = warp_sum(cost_acc);
    if (lane == 0) s_red[warp] = cost_acc;
    __syncthreads();
    if (tid == 0) {
        float c = 0.f;
        for (int wi = 0; wi < kWarps; ++wi) c += s_red[wi];
        cost_out[v] = c;
    }
    const long long rr = (long long)n_rows * n_rows;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
        const int r = ent_r[q];
        if (r < 0) continue;
        const int s = ent_s[q];
        if (s < 0) {
            g_out[v * n_rows + r] = acc[q];
        } else {
            h_out[v * rr + r * n_rows + s] = acc[q];
            if (s != r) h_out[v * rr + s * n_rows + r] = acc[q];
        }
    }
}

}  // namespace

extern "C" int xmt_eq6_normal_eq_jac(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const int* rows, const unsigned char* mask, const int* g_zero, float* cost,
    float* g, float* h, int b, int n_t, int n_peaks, int n_rows, int factored,
    float w_cs_unit, void* stream) {
    if (n_peaks < 1 || n_peaks > kMaxPeaks || n_rows < 1 ||
        n_rows > kMaxRows || (factored && (n_t % kChunk != 0 || !g_zero)))
        return (int)cudaErrorInvalidValue;
    const size_t tables =
        factored ? (size_t)n_peaks * (2 * kChunk + 2 * (n_t / kChunk)) : 0;
    const size_t smem =
        sizeof(float) * ((size_t)2 * n_rows * kPitch +
                         (size_t)2 * n_peaks * kChunk + 2 * kChunk + tables);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            normal_eq_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (b > 0) {
        normal_eq_jac_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            params, y_re, y_im, t, rows, mask, g_zero, cost, g, h, n_t,
            n_peaks, n_rows, factored, w_cs_unit);
    }
    return (int)cudaGetLastError();
}
