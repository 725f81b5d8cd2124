// K2: Eq.6 cost, gradient and Gauss-Newton Hessian per voxel, in free-
// parameter space, from complex moments (the "v9" formulation).
//
// Replaces xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v9
// (_normal_eq_kernel_v9 / _v9_tile_eval) with the free-space fold.
//
// Every Jacobian row of the Eq.6 model is (z_0 + z_1 t + z_2 t^2) * B_k with
// per-voxel complex coefficients z_d, so the Gram matrix J^T J collapses to
// complex moments M_q[k,k'] = sum_t t^q B_k conj(B_k') and the gradient
// J^T r to N_q[k] = sum_t t^q conj(B_k) r.  Per voxel the kernel:
//   1. evaluates the K peak bases B_k(t) (block-factored over 128-sample
//      blocks when the time axis is uniform, exactly as the reference's
//      factored_t form: ~8x fewer exp/sin/cos than the direct form, and
//      smaller angles), the model, the residual and the cost;
//   2. reduces the moments N_q (q <= q_n) and M_q (k <= k', q <= 2 q_n);
//   3. assembles g and H from the reference's coefficient rules, folded by
//      free slot, scatter scale and the bound-transform diagonal dx/du.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID (134 MB per
// bench grid) and writes 1.6 KB of H (26 MB); the work is ~55 complex
// moment sums over 1024 samples plus K*1024 basis points, a few hundred
// kFLOP — fp32 issue-bound, not memory-bound.  Design: one block per voxel;
// the bases, residual and time axis stay in shared memory (53 KB at the
// bench shape, K = 5 and n_t = 1024); each warp reduces whole moment
// groups (one peak or peak pair, all powers of t at once) with shuffles;
// a thread per H entry assembles the 20 x 20 system.  H is written in the
// port's voxel-minor slab layout (F*F, B), so the SPD kernels read it
// coalesced.  Voxels whose mask entry is 0 (done in the LM) return at once
// and leave their outputs unspecified: the LM loop discards them.
//
// The prior's static structure (active rows, slots, scales, g == 0 flags)
// arrives as small device arrays; kMaxPeaks, kMaxFree and kMaxRows bound it
// and the wrapper refuses anything larger.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPeaks = 8;
constexpr int kMaxFree = 32;
constexpr int kMaxRows = 5 * kMaxPeaks;
constexpr int kMaxQn = 2;              // highest t power of a Jacobian row
constexpr int kMaxQm = 2 * kMaxQn;     // highest t power of a pair moment
constexpr int kBlockT = 128;           // block length of the factored basis
constexpr float kPi = 3.14159265358979323846f;
constexpr float kDeg = (float)(3.14159265358979323846 / 180.0);

struct Structure {
    const int* row_peak;
    const int* row_ptype;
    const int* row_slot;
    const int* slot_ptr;   // (n_free + 1) CSR offsets into slot_rows
    const int* slot_rows;
    const int* g_zero;     // (n_peaks,) 1 when g is fixed at exactly 0
};

__device__ __forceinline__ float warp_sum(float x) {
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ int pair_index(int k, int kp, int n_peaks) {
    // k <= kp, row-major upper triangle
    return k * n_peaks - (k * (k - 1)) / 2 + (kp - k);
}

__global__ void __launch_bounds__(kThreads) normal_eq_v9_kernel(
    const float* __restrict__ params,   // (B, K*5) physical parameters
    const float* __restrict__ y_re,     // (B, n_t)
    const float* __restrict__ y_im,
    const float* __restrict__ t,        // (n_t,)
    const float* __restrict__ dxdu,     // (B, F)
    const unsigned char* __restrict__ mask,  // (B,) or null
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
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int q_m = 2 * q_n;
    const int n_q = n_t / kBlockT;
    const int n_pairs = n_peaks * (n_peaks + 1) / 2;

    extern __shared__ float smem[];
    float* s_t = smem;                        // n_t
    float* s_bre = s_t + n_t;                 // K * n_t
    float* s_bim = s_bre + n_peaks * n_t;     // K * n_t
    float* s_rre = s_bim + n_peaks * n_t;     // n_t
    float* s_rim = s_rre + n_t;               // n_t
    float* s_gr_re = s_rim + n_t;             // K * 128 (factored)
    float* s_gr_im = s_gr_re + n_peaks * kBlockT;
    float* s_fq_re = s_gr_im + n_peaks * kBlockT;   // K * n_q (factored)
    float* s_fq_im = s_fq_re + n_peaks * n_q;
    float* s_nmom = s_fq_im + n_peaks * n_q;        // K * (q_n+1) * 2
    float* s_mmom = s_nmom + n_peaks * (q_n + 1) * 2;  // pairs * (q_m+1) * 2

    __shared__ float s_par[kMaxPeaks * 5];
    __shared__ float s_dx[kMaxFree];
    __shared__ float s_al[kMaxRows][2];
    __shared__ float s_be[kMaxRows][2];
    __shared__ int s_deg[kMaxRows][2];
    __shared__ int s_nterm[kMaxRows];
    __shared__ float s_red[kWarps];

    for (int i = tid; i < n_peaks * 5; i += kThreads)
        s_par[i] = params[(long long)v * n_peaks * 5 + i];
    for (int i = tid; i < n_free; i += kThreads)
        s_dx[i] = dxdu[(long long)v * n_free + i];
    for (int i = tid; i < n_t; i += kThreads) s_t[i] = t[i];
    __syncthreads();

    // ---- 1. bases, model, residual, cost ----
    if (factored) {
        const float t0 = s_t[0];
        for (int idx = tid; idx < n_peaks * kBlockT; idx += kThreads) {
            const int k = idx / kBlockT;
            const int r = idx % kBlockT;
            const float d = kPi * s_par[k * 5 + 2];
            const float w = w_cs_unit * s_par[k * 5 + 1];
            const float ang = w * s_t[r] + s_par[k * 5 + 3] * kDeg;
            float sn, cs;
            sincosf(ang, &sn, &cs);
            if (st.g_zero[k]) {
                const float er = expf(-d * s_t[r]);
                s_gr_re[idx] = er * cs;
                s_gr_im[idx] = er * sn;
            } else {
                s_gr_re[idx] = cs;
                s_gr_im[idx] = sn;
            }
        }
        for (int idx = tid; idx < n_peaks * n_q; idx += kThreads) {
            const int k = idx / n_q;
            const int q = idx % n_q;
            const float tq = s_t[q * kBlockT] - t0;
            const float d = kPi * s_par[k * 5 + 2];
            const float w = w_cs_unit * s_par[k * 5 + 1];
            float sn, cs;
            sincosf(w * tq, &sn, &cs);
            if (st.g_zero[k]) {
                const float fq = s_par[k * 5 + 0] * expf(-d * tq);
                s_fq_re[idx] = fq * cs;
                s_fq_im[idx] = fq * sn;
            } else {
                s_fq_re[idx] = cs;
                s_fq_im[idx] = sn;
            }
        }
        __syncthreads();
    }

    float cost_acc = 0.f;
    for (int i = tid; i < n_t; i += kThreads) {
        const float ti = s_t[i];
        float m_re = 0.f, m_im = 0.f;
        for (int k = 0; k < n_peaks; ++k) {
            const float amp = s_par[k * 5 + 0];
            const float lw = s_par[k * 5 + 2];
            const float gv = s_par[k * 5 + 4];
            const bool gz = st.g_zero[k] != 0;
            float b_re, b_im;
            if (factored) {
                const int r = i % kBlockT;
                const int q = i / kBlockT;
                const float gr = s_gr_re[k * kBlockT + r];
                const float gi = s_gr_im[k * kBlockT + r];
                const float fr = s_fq_re[k * n_q + q];
                const float fi = s_fq_im[k * n_q + q];
                if (gz) {
                    b_re = fr * gr - fi * gi;
                    b_im = fr * gi + fi * gr;
                } else {
                    const float d = kPi * lw;
                    const float env =
                        amp * expf(-d * (1.0f - gv + gv * ti) * ti);
                    b_re = env * (fr * gr - fi * gi);
                    b_im = env * (fr * gi + fi * gr);
                }
            } else {
                const float env =
                    gz ? amp * expf((-kPi) * lw * ti)
                       : amp * expf((-kPi) * lw * (1.0f - gv + gv * ti) * ti);
                const float ang = w_cs_unit * s_par[k * 5 + 1] * ti +
                                  s_par[k * 5 + 3] * kDeg;
                float sn, cs;
                sincosf(ang, &sn, &cs);
                b_re = env * cs;
                b_im = env * sn;
            }
            s_bre[k * n_t + i] = b_re;
            s_bim[k * n_t + i] = b_im;
            m_re += b_re;
            m_im += b_im;
        }
        const float r_re = y_re[(long long)v * n_t + i] - m_re;
        const float r_im = y_im[(long long)v * n_t + i] - m_im;
        s_rre[i] = r_re;
        s_rim[i] = r_im;
        cost_acc += r_re * r_re + r_im * r_im;
    }
    cost_acc = warp_sum(cost_acc);
    if (lane == 0) s_red[warp] = cost_acc;
    __syncthreads();
    if (tid == 0) {
        float c = 0.f;
        for (int wi = 0; wi < kWarps; ++wi) c += s_red[wi];
        cost_out[v] = c;
    }

    // ---- 2. moments: one warp per peak (N) or peak pair (M) ----
    for (int item = warp; item < n_peaks + n_pairs; item += kWarps) {
        float acc_r[kMaxQm + 1], acc_i[kMaxQm + 1];
#pragma unroll
        for (int q = 0; q <= kMaxQm; ++q) acc_r[q] = acc_i[q] = 0.f;
        if (item < n_peaks) {
            const int k = item;
            for (int i = lane; i < n_t; i += 32) {
                const float br = s_bre[k * n_t + i], bi = s_bim[k * n_t + i];
                const float rr = s_rre[i], ri = s_rim[i];
                const float pr = br * rr + bi * ri;
                const float pi = br * ri - bi * rr;
                const float ti = s_t[i];
                float tq = 1.f;
#pragma unroll
                for (int q = 0; q <= kMaxQn; ++q) {
                    if (q <= q_n) {
                        acc_r[q] += tq * pr;
                        acc_i[q] += tq * pi;
                    }
                    tq *= ti;
                }
            }
#pragma unroll
            for (int q = 0; q <= kMaxQn; ++q) {
                if (q > q_n) break;
                const float sr = warp_sum(acc_r[q]);
                const float si = warp_sum(acc_i[q]);
                if (lane == 0) {
                    s_nmom[(k * (q_n + 1) + q) * 2 + 0] = sr;
                    s_nmom[(k * (q_n + 1) + q) * 2 + 1] = si;
                }
            }
        } else {
            // pair index -> (k, kp), k <= kp
            const int p = item - n_peaks;
            int k = 0, rem = p;
            while (rem >= n_peaks - k) {
                rem -= n_peaks - k;
                ++k;
            }
            const int kp = k + rem;
            for (int i = lane; i < n_t; i += 32) {
                const float ar = s_bre[k * n_t + i], ai = s_bim[k * n_t + i];
                const float br = s_bre[kp * n_t + i], bi = s_bim[kp * n_t + i];
                const float cr = ar * br + ai * bi;
                const float ci = ai * br - ar * bi;
                const float ti = s_t[i];
                float tq = 1.f;
#pragma unroll
                for (int q = 0; q <= kMaxQm; ++q) {
                    if (q <= q_m) {
                        acc_r[q] += tq * cr;
                        acc_i[q] += tq * ci;
                    }
                    tq *= ti;
                }
            }
#pragma unroll
            for (int q = 0; q <= kMaxQm; ++q) {
                if (q > q_m) break;
                const float sr = warp_sum(acc_r[q]);
                const float si = warp_sum(acc_i[q]);
                if (lane == 0) {
                    s_mmom[(p * (q_m + 1) + q) * 2 + 0] = sr;
                    s_mmom[(p * (q_m + 1) + q) * 2 + 1] = si;
                }
            }
        }
    }

    // ---- 3a. per-row coefficient terms (alpha, beta, degree) * m_r ----
    if (tid < n_rows) {
        const int r = tid;
        const int k = st.row_peak[r];
        const int pt = st.row_ptype[r];
        const float m = s_dx[st.row_slot[r]] * row_scale[r];
        float al0 = 0.f, be0 = 0.f, al1 = 0.f, be1 = 0.f;
        int d0 = 0, d1 = 0, nt = 1;
        if (pt == 0) {  // amplitude
            const float a = s_par[k * 5 + 0];
            const float safe = (a == 0.f) ? 1.f : a;
            al0 = 1.f / safe;
        } else if (pt == 1) {  // chemical shift
            be0 = w_cs_unit;
            d0 = 1;
        } else if (pt == 2) {  // linewidth
            if (st.g_zero[k]) {
                al0 = -kPi;
                d0 = 1;
            } else {
                const float gv = s_par[k * 5 + 4];
                al0 = -kPi * (1.f - gv);
                d0 = 1;
                al1 = -kPi * gv;
                d1 = 2;
                nt = 2;
            }
        } else if (pt == 3) {  // phase
            be0 = kDeg;
        } else {  // g
            const float d = kPi * s_par[k * 5 + 2];
            al0 = d;
            d0 = 1;
            al1 = -d;
            d1 = 2;
            nt = 2;
        }
        s_al[r][0] = al0 * m;
        s_be[r][0] = be0 * m;
        s_deg[r][0] = d0;
        s_al[r][1] = al1 * m;
        s_be[r][1] = be1 * m;
        s_deg[r][1] = d1;
        s_nterm[r] = nt;
    }
    __syncthreads();

    // ---- 3b. gradient g_f = sum_rows sum_terms Re(conj(z_d) N_d[k]) ----
    if (tid < n_free) {
        const int f = tid;
        float acc = 0.f;
        for (int rr = st.slot_ptr[f]; rr < st.slot_ptr[f + 1]; ++rr) {
            const int r = st.slot_rows[rr];
            const int k = st.row_peak[r];
            for (int i = 0; i < s_nterm[r]; ++i) {
                const int d = s_deg[r][i];
                const float nr = s_nmom[(k * (q_n + 1) + d) * 2 + 0];
                const float ni = s_nmom[(k * (q_n + 1) + d) * 2 + 1];
                acc = acc + s_al[r][i] * nr + s_be[r][i] * ni;
            }
        }
        g_out[(long long)v * n_free + f] = acc;
    }

    // ---- 3c. Hessian, upper triangle f <= h, mirrored ----
    const int n_upper = n_free * (n_free + 1) / 2;
    for (int e = tid; e < n_upper; e += kThreads) {
        int f = 0, rem = e;
        while (rem >= n_free - f) {
            rem -= n_free - f;
            ++f;
        }
        const int hh = f + rem;
        float acc = 0.f;
        for (int ra = st.slot_ptr[f]; ra < st.slot_ptr[f + 1]; ++ra) {
            const int r = st.slot_rows[ra];
            const int kr = st.row_peak[r];
            for (int sa = st.slot_ptr[hh]; sa < st.slot_ptr[hh + 1]; ++sa) {
                const int s = st.slot_rows[sa];
                const int ks = st.row_peak[s];
                const bool ordered = kr <= ks;
                const int p = ordered ? pair_index(kr, ks, n_peaks)
                                      : pair_index(ks, kr, n_peaks);
                for (int i = 0; i < s_nterm[r]; ++i) {
                    const float ar = s_al[r][i], br = s_be[r][i];
                    for (int j = 0; j < s_nterm[s]; ++j) {
                        const float as = s_al[s][j], bs = s_be[s][j];
                        const int q = s_deg[r][i] + s_deg[s][j];
                        const float mr = s_mmom[(p * (q_m + 1) + q) * 2 + 0];
                        float mi = s_mmom[(p * (q_m + 1) + q) * 2 + 1];
                        if (!ordered) mi = -mi;
                        acc = acc + ((ar * as + br * bs) * mr -
                                     (br * as - ar * bs) * mi);
                    }
                }
            }
        }
        h_out[(long long)(f * n_free + hh) * b + v] = acc;
        if (hh != f) h_out[(long long)(hh * n_free + f) * b + v] = acc;
    }
}

}  // namespace

extern "C" int xmt_eq6_normal_eq_v9(
    const float* params, const float* y_re, const float* y_im, const float* t,
    const float* dxdu, const unsigned char* mask, const int* ints,
    const float* row_scale, float* cost, float* g, float* h,
    int b, int n_t, int n_peaks, int n_free, int n_rows, int q_n,
    int factored, float w_cs_unit, void* stream) {
    // ints: row_peak(A) row_ptype(A) row_slot(A) slot_ptr(F+1) slot_rows(A)
    //       g_zero(K)
    Structure st;
    st.row_peak = ints;
    st.row_ptype = ints + n_rows;
    st.row_slot = ints + 2 * n_rows;
    st.slot_ptr = ints + 3 * n_rows;
    st.slot_rows = ints + 3 * n_rows + n_free + 1;
    st.g_zero = ints + 4 * n_rows + n_free + 1;
    const int n_q = n_t / kBlockT;
    const int n_pairs = n_peaks * (n_peaks + 1) / 2;
    const size_t floats = (size_t)n_t * (3 + 2 * n_peaks) +
                          (size_t)n_peaks * (2 * kBlockT + 2 * n_q) +
                          (size_t)n_peaks * (q_n + 1) * 2 +
                          (size_t)n_pairs * (2 * q_n + 1) * 2;
    const size_t smem = floats * sizeof(float);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(normal_eq_v9_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    if (b > 0) {
        normal_eq_v9_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
            params, y_re, y_im, t, dxdu, mask, st, row_scale, cost, g, h, b,
            n_t, n_peaks, n_free, n_rows, q_n, factored, w_cs_unit);
    }
    return (int)cudaGetLastError();
}
