// The block evaluation of one voxel (`v9_eval`), the body of the whole-loop
// LM kernel K8 (lm_v10.cu).  Its constants, `Structure`, the block-factored
// basis tables (`factored_tables`), `warp_sum` and `pair_index` are shared
// with the warp evaluation of K2 and K9 (lm_v9_warp.cuh) and with the
// explicit-Jacobian kernels (lm_jac.cu).
//
// Every Jacobian row of the Eq.6 model is (z_0 + z_1 t + z_2 t^2) * B_k with
// per-voxel complex coefficients z_d, so the Gram matrix J^T J collapses to
// complex moments M_q[k,k'] = sum_t t^q B_k conj(B_k') and the gradient
// J^T r to N_q[k] = sum_t t^q conj(B_k) r.  Per voxel the block:
//   1. evaluates the K peak bases B_k(t) (block-factored over 128-sample
//      blocks when the time axis is uniform, exactly as the reference's
//      factored_t form: ~8x fewer exp/sin/cos than the direct form, and
//      smaller angles), the model, the residual and the cost;
//   2. reduces the moments N_q (q <= q_n) and M_q (k <= k', q <= 2 q_n);
//   3. assembles g and H from the reference's coefficient rules, folded by
//      free slot, scatter scale and the bound-transform diagonal dx/du.
//
// What bounds it on the H100: fp32 issue (~250 instructions a sample at the
// bench shape, K = 5 and q_n = 1), and in this design the shared memory
// around it.  Design: one block of 256 threads per voxel, which K8 keeps
// for the voxel's whole LM loop; the bases, residual and time axis stay in
// shared memory (53 KB at the bench shape, 4 voxels an SM); each warp
// reduces whole moment groups (one peak or peak pair, all powers of t at
// once) with shuffles, reading every basis value back once per group; a
// thread per H entry assembles the F x F system.  The warp evaluation of
// lm_v9_warp.cuh keeps the moments in registers instead and computes the
// same outputs bit for bit; K8 has not taken it yet.
//
// The prior's static structure (active rows, slots, scales, g == 0 flags)
// arrives as small device arrays; kMaxPeaks, kMaxFree and kMaxRows bound it
// and the wrappers refuse anything larger.

#pragma once

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

// ints: row_peak(A) row_ptype(A) row_slot(A) slot_ptr(F+1) slot_rows(A)
//       g_zero(K), as the wrappers pack them.
inline Structure unpack_structure(const int* ints, int n_rows, int n_free) {
    Structure st;
    st.row_peak = ints;
    st.row_ptype = ints + n_rows;
    st.row_slot = ints + 2 * n_rows;
    st.slot_ptr = ints + 3 * n_rows;
    st.slot_rows = ints + 3 * n_rows + n_free + 1;
    st.g_zero = ints + 4 * n_rows + n_free + 1;
    return st;
}

// Floats of dynamic shared memory the evaluation needs, the time axis
// included (s_t first, then the work area `v9_eval` takes).
inline size_t v9_smem_floats(int n_t, int n_peaks, int q_n) {
    const int n_q = n_t / kBlockT;
    const int n_pairs = n_peaks * (n_peaks + 1) / 2;
    return (size_t)n_t * (3 + 2 * n_peaks) +
           (size_t)n_peaks * (2 * kBlockT + 2 * n_q) +
           (size_t)n_peaks * (q_n + 1) * 2 +
           (size_t)n_pairs * (2 * q_n + 1) * 2;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ int pair_index(int k, int kp, int n_peaks) {
    // k <= kp, row-major upper triangle
    return k * n_peaks - (k * (k - 1)) / 2 + (kp - k);
}

// The tables of the block-factored basis (the reference's factored form,
// lm_pallas.py:988-1026 and :1680-1727).  On a uniform axis with
// n_t % 128 == 0, t[q*128 + r] = t[r] + t_q with t_q = t[q*128] - t[0], so
// peak k's basis is F_q[k] * G_r[k] (complex), written here by the caller's
// threads `tid` of `n_threads` (the caller syncs after):
//   gr (K x 128): e^{-d t_r} e^{i (w t_r + phi)} if g_zero[k], else
//                 e^{i (w t_r + phi)} (the envelope stays per sample);
//   fq (K x n_q): a e^{-d t_q} e^{i w t_q} if g_zero[k], else e^{i w t_q};
// with d = pi lw and w = 2 pi MHz cs.  `t` may be shared or global memory.
// Each entry's arithmetic is the same whatever the split (K2 passes the
// block, the explicit-Jacobian kernel one warp).
__device__ __forceinline__ void factored_tables(
    const float* s_par, const float* t, const int* g_zero, int n_peaks,
    int n_q, float w_cs_unit, float* s_gr_re, float* s_gr_im,
    float* s_fq_re, float* s_fq_im, int tid, int n_threads) {
    const float t0 = t[0];
    for (int idx = tid; idx < n_peaks * kBlockT; idx += n_threads) {
        const int k = idx / kBlockT;
        const int r = idx % kBlockT;
        const float d = kPi * s_par[k * 5 + 2];
        const float w = w_cs_unit * s_par[k * 5 + 1];
        const float ang = w * t[r] + s_par[k * 5 + 3] * kDeg;
        float sn, cs;
        sincosf(ang, &sn, &cs);
        if (g_zero[k]) {
            const float er = expf(-d * t[r]);
            s_gr_re[idx] = er * cs;
            s_gr_im[idx] = er * sn;
        } else {
            s_gr_re[idx] = cs;
            s_gr_im[idx] = sn;
        }
    }
    for (int idx = tid; idx < n_peaks * n_q; idx += n_threads) {
        const int k = idx / n_q;
        const int q = idx % n_q;
        const float tq = t[q * kBlockT] - t0;
        const float d = kPi * s_par[k * 5 + 2];
        const float w = w_cs_unit * s_par[k * 5 + 1];
        float sn, cs;
        sincosf(w * tq, &sn, &cs);
        if (g_zero[k]) {
            const float fq = s_par[k * 5 + 0] * expf(-d * tq);
            s_fq_re[idx] = fq * cs;
            s_fq_im[idx] = fq * sn;
        } else {
            s_fq_re[idx] = cs;
            s_fq_im[idx] = sn;
        }
    }
}

// One voxel's evaluation by the whole block of kThreads threads.  The
// caller has written s_par (K*5 physical parameters), s_dx (F bound-
// transform factors) and s_t (n_t samples) to shared memory and passed a
// __syncthreads(); `smem` is the dynamic shared memory, s_t at its start.
// y_re/y_im are the voxel's (n_t,) rows.  Writes the cost to *cost_out
// (thread 0), g_f to g_out[f] and H(f, h) to h_out[(f*F + h) * h_stride].
// With a non-null `cost_prev` (the accept gate) the moments, g and H are
// skipped, and left unwritten, when the cost is not below *cost_prev.
__device__ __forceinline__ void v9_eval(
    const float* s_par, const float* s_dx, float* smem,
    const float* __restrict__ y_re, const float* __restrict__ y_im,
    const Structure& st, const float* __restrict__ row_scale,
    float* cost_out, float* g_out, float* h_out, long long h_stride,
    int n_t, int n_peaks, int n_free, int n_rows, int q_n, int factored,
    float w_cs_unit, const float* cost_prev) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int q_m = 2 * q_n;
    const int n_q = n_t / kBlockT;
    const int n_pairs = n_peaks * (n_peaks + 1) / 2;

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

    __shared__ float s_al[kMaxRows][2];
    __shared__ float s_be[kMaxRows][2];
    __shared__ int s_deg[kMaxRows][2];
    __shared__ int s_nterm[kMaxRows];
    __shared__ float s_red[kWarps];

    // ---- 1. bases, model, residual, cost ----
    if (factored) {
        factored_tables(s_par, s_t, st.g_zero, n_peaks, n_q, w_cs_unit,
                        s_gr_re, s_gr_im, s_fq_re, s_fq_im, tid, kThreads);
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
        const float r_re = y_re[i] - m_re;
        const float r_im = y_im[i] - m_im;
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
        *cost_out = c;
    }
    if (cost_prev != nullptr) {
        // Every thread sums s_red in thread 0's order: one uniform exit.
        float c = 0.f;
        for (int wi = 0; wi < kWarps; ++wi) c += s_red[wi];
        if (!(c < *cost_prev)) return;
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
        g_out[f] = acc;
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
        h_out[(long long)(f * n_free + hh) * h_stride] = acc;
        if (hh != f) h_out[(long long)(hh * n_free + f) * h_stride] = acc;
    }
}

}  // namespace
