// The v9 evaluation by one warp per voxel: K2 (lm_v9.cu for priors within
// lm_v9_eval.cuh's kMaxPeaks/kMaxFree/kMaxRows, lm_v9_wide.cu past them)
// and K9 (lm_v8.cu).
// The whole-loop K8 (lm_v10.cu) keeps the block evaluation `v9_eval` of
// lm_v9_eval.cuh; this header takes its constants, `Structure`,
// `factored_tables`, `warp_sum` and `pair_index` and changes none of them.
//
// What bounds it on the H100: per voxel it reads 8 KB of FID and writes
// F^2 + F + 1 floats; the work is, per sample, the K bases, the model and
// residual, and the moment sums of every item (N_k: K items of q_n + 1
// complex powers; M_kk': K(K+1)/2 items of 2 q_n + 1), ~250 fp32
// instructions a sample at the bench shape (K = 5, q_n = 1): fp32 issue-
// bound, not memory-bound.  The block design it replaces put every basis
// value through shared memory once per moment item (~410 KB of shared
// loads per voxel), held a 53 KB work area per voxel (4 voxels an SM) and
// left warps idle in its last item round and its assembly.
//
// Design:
// * One warp per voxel, kVox voxels a block.  The time axis is loaded into
//   shared memory once per block by the live warps.  A warp whose voxel is
//   masked (or past the batch) returns at once; the live warps then meet
//   only at named barriers counted over themselves (`live_barrier`), never
//   at __syncthreads.
// * No basis array: lane l owns the samples i = l + 32 m, m ascending, and
//   at each one forms, in registers, the K bases (from the block-factored
//   tables, K x 128 + K x n_q complex per voxel in shared memory, or the
//   direct exp/sincos), the model, the residual, t^q once, and updates the
//   accumulators of every moment item of the pass.  The items (N_0..N_K-1,
//   then the pairs row-major) are cut into passes of at most a budget of
//   accumulator floats (`pass_start`, greedy); a pass re-forms the bases.
//   Each kernel sets its budget and register cap (`WarpConfig`): K2's
//   factored bases are cheap to re-form, so it takes two passes at the
//   bench shape and 2 blocks an SM; K9's direct exp/sincos are not, so it
//   takes one pass and 1 block an SM.
//   K and q_n are template parameters so every accumulator is a register.
// * Assembly by the warp: the lanes run over the rows (3a), the g entries
//   (3b) and the upper-H entries (3c); H is staged in the voxel's shared
//   area (over its dead basis tables) and stored as whole rows: for the
//   slab (K2), the kVox voxels of each slab row together (one 32-byte
//   sector at kVox = 8); dense (K9), each voxel's F x F block contiguous.
// * The accept gate (`cost_prev`): the cost comes from a cost-only pass
//   first, and a rejected voxel skips every moment pass.  Without the gate
//   the cost rides on the first moment pass.
//
// Bit for bit the block evaluation: each moment item's per-lane sum runs
// over the same samples (i = lane mod 32, ascending) with the same
// expressions, then the same `warp_sum` butterfly; passes do not change an
// item's order.  The cost keeps the block's 256-thread order: lane l's
// partial m mod 8 takes the samples the block's thread 32 (m mod 8) + l
// took, and the 8 warp sums are added in that order.  3a-3c are the
// block's expressions, entry for entry.  Where this code shape would let
// the compiler round otherwise than the block build did (a diagonal pair,
// whose two products of ci are one value; a direct basis product that feeds
// only the model sum in a cost-only pass), the rounding is pinned with
// __fmaf_rn/__fmul_rn to the block build's.

#pragma once

#include "lm_v9_eval.cuh"

namespace {

constexpr int kVox = 8;  // voxels (one warp each) a block

// A kernel's build: H as the slab (K2) or dense (K9), the accumulator
// floats a moment pass keeps, and the blocks an SM must hold (which caps
// the registers a thread).
template <bool kSlabH, int kPassBudget, int kMinBlocks>
struct WarpConfig {
    static constexpr bool slab = kSlabH;
    static constexpr int budget = kPassBudget;
    static constexpr int blocks = kMinBlocks;
};

// ---- the moment items: N_k (k < K), then pair p = (k <= k') row-major ----

__host__ __device__ constexpr int item_width(int K, int QN, int item) {
    return item < K ? 2 * (QN + 1) : 2 * (2 * QN + 1);
}

__host__ __device__ constexpr int n_items(int K) { return K + K * (K + 1) / 2; }

// Floats of the accumulators of items [i0, i1).
__host__ __device__ constexpr int items_width(int K, int QN, int i0, int i1) {
    int w = 0;
    for (int it = i0; it < i1; ++it) w += item_width(K, QN, it);
    return w;
}

// First item of pass p (greedy, `budget` floats a pass; n_items(K) for
// p == the number of passes).
__host__ __device__ constexpr int pass_start(int K, int QN, int p,
                                             int budget) {
    int pass = 0, used = 0;
    for (int it = 0; it < n_items(K); ++it) {
        const int w = item_width(K, QN, it);
        if (used > 0 && used + w > budget) {
            if (++pass == p) return it;
            used = 0;
        }
        used += w;
    }
    return p == 0 ? 0 : n_items(K);
}

__host__ __device__ constexpr int n_passes(int K, int QN, int budget) {
    int p = 1;
    while (pass_start(K, QN, p, budget) < n_items(K)) ++p;
    return p;
}

// Pair p's peaks (k <= k'), the inverse of `pair_index`.
__host__ __device__ constexpr int pair_first(int K, int p) {
    int k = 0;
    while (p >= K - k) {
        p -= K - k;
        ++k;
    }
    return k;
}

__host__ __device__ constexpr int pair_second(int K, int p) {
    int k = 0;
    while (p >= K - k) {
        p -= K - k;
        ++k;
    }
    return k + p;
}

// ---- shared memory: the time axis, then kVox voxel areas of `stride` ----

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Floats of a voxel's area: parameters, dx/du, N and M moments, the row
// terms (alpha, beta: 2 per row; degrees 2, term count 1, as ints), the 8
// cost partials of each lane, then the work area: the factored tables, or
// (after the passes) the staged F x F H.  Rounded up to 4 mod 32 floats so
// that the slab store's 8 voxels of a row fall in 8 bank groups.
__host__ __device__ inline int warp_stride(int n_t, int K, int QN, int n_free,
                                           int n_rows, int factored) {
    const int head = 5 * K + n_free + 2 * K * (QN + 1) +
                     K * (K + 1) * (2 * QN + 1) + 7 * n_rows + 8 * 32;
    const int tables = factored ? 2 * K * kBlockT + 2 * K * (n_t / kBlockT) : 0;
    const int hh = n_free * n_free;
    const int total = head + (tables > hh ? tables : hh);
    return total + ((4 - total % 32) + 32) % 32;
}

inline size_t warp_smem_bytes(int n_t, int K, int QN, int n_free, int n_rows,
                              int factored) {
    return sizeof(float) *
           ((size_t)pad4(n_t) +
            (size_t)kVox * warp_stride(n_t, K, QN, n_free, n_rows, factored));
}

struct WarpArgs {
    const float* params;      // (B, K*5) physical parameters
    const float* y_re;        // (B, n_t)
    const float* y_im;
    const float* t;           // (n_t,)
    const float* dxdu;        // (B, F), or null: the identity fold (dx = 1)
    const unsigned char* mask;  // (B,) or null
    const float* cost_prev;   // (B,) or null: the accept gate
    Structure st;
    const float* row_scale;   // (A,)
    float* cost;              // (B,)
    float* g;                 // (B, F)
    float* h;                 // slab (F*F, B) or dense (B, F, F)
    long long b;
    int n_t, n_free, n_rows, factored, stride;
    float w_cs_unit;
};

struct VoxelSmem {
    float *par, *dx, *nm, *mm, *al, *be, *cp, *work;
    int *deg, *nterm;
};

__device__ __forceinline__ VoxelSmem voxel_smem(float* base, int K, int QN,
                                                int n_free, int n_rows) {
    VoxelSmem s;
    s.par = base;
    s.dx = s.par + 5 * K;
    s.nm = s.dx + n_free;
    s.mm = s.nm + 2 * K * (QN + 1);
    s.al = s.mm + K * (K + 1) * (2 * QN + 1);
    s.be = s.al + 2 * n_rows;
    s.deg = reinterpret_cast<int*>(s.be + 2 * n_rows);
    s.nterm = s.deg + 2 * n_rows;
    s.cp = reinterpret_cast<float*>(s.nterm + n_rows);
    s.work = s.cp + 8 * 32;
    return s;
}

// bar.sync over the block's live warps only (a masked warp has left).
__device__ __forceinline__ void live_barrier(int n_live) {
    asm volatile("bar.sync 1, %0;" ::"r"(n_live * 32) : "memory");
}

struct PassCtx {
    const float* s_t;
    const float* y_re;   // the voxel's rows
    const float* y_im;
    const int* g_zero;
    VoxelSmem s;
    int n_t, n_q, factored, lane;
    float w_cs_unit;
};

// The accumulator updates of one sample for items [IT, I1), item IT's at
// acc[O..]: by compile-time recursion, so that every index is a constant
// and every accumulator a register.
template <int K, int QN, int IT, int I1, int O, int W>
__device__ __forceinline__ void update_items(float (&acc)[W],
                                             const float (&b_re)[K],
                                             const float (&b_im)[K],
                                             float r_re, float r_im,
                                             const float (&tp)[2 * QN + 1]) {
    if constexpr (IT < I1) {
        if constexpr (IT < K) {
            const float br = b_re[IT], bi = b_im[IT];
            const float pr = br * r_re + bi * r_im;
            const float pi = br * r_im - bi * r_re;
#pragma unroll
            for (int q = 0; q <= QN; ++q) {
                acc[O + 2 * q] += tp[q] * pr;
                acc[O + 2 * q + 1] += tp[q] * pi;
            }
        } else {
            constexpr int k = pair_first(K, IT - K);
            constexpr int kp = pair_second(K, IT - K);
            const float ar = b_re[k], ai = b_im[k];
            const float br = b_re[kp], bi = b_im[kp];
            // cr = ar br + ai bi, ci = ai br - ar bi, contracted as the
            // block evaluation's build does.  Pinned: with k == k' known
            // here, ci's two products are one value and would cancel to
            // an exact 0 where the block kernel keeps the fma's residual.
            const float cr = __fmaf_rn(ar, br, __fmul_rn(ai, bi));
            const float ci = __fmaf_rn(ai, br, -__fmul_rn(ar, bi));
#pragma unroll
            for (int q = 0; q <= 2 * QN; ++q) {
                acc[O + 2 * q] += tp[q] * cr;
                acc[O + 2 * q + 1] += tp[q] * ci;
            }
        }
        update_items<K, QN, IT + 1, I1, O + item_width(K, QN, IT)>(
            acc, b_re, b_im, r_re, r_im, tp);
    }
}

// Items [IT, I1): each power's warp_sum, written by lane 0 in the block
// layout.
template <int K, int QN, int IT, int I1, int O, int W>
__device__ __forceinline__ void reduce_items(const float (&acc)[W],
                                             const VoxelSmem& s, int lane) {
    if constexpr (IT < I1) {
        constexpr int n_pow = item_width(K, QN, IT) / 2;
        float* dst = IT < K ? s.nm + IT * (QN + 1) * 2
                            : s.mm + (IT - K) * (2 * QN + 1) * 2;
#pragma unroll
        for (int q = 0; q < n_pow; ++q) {
            const float sr = warp_sum(acc[O + 2 * q]);
            const float si = warp_sum(acc[O + 2 * q + 1]);
            if (lane == 0) {
                dst[q * 2 + 0] = sr;
                dst[q * 2 + 1] = si;
            }
        }
        reduce_items<K, QN, IT + 1, I1, O + item_width(K, QN, IT)>(acc, s,
                                                                  lane);
    }
}

// One sweep over the lane's samples: the bases, model and residual; with
// `with_cost` the cost partials; the accumulators of items [I0, I1), which
// are then reduced (warp_sum) and written by lane 0 in the block layout:
// N at nm[(k*(QN+1) + q)*2 + {re, im}], M at mm[(p*(2QN+1) + q)*2 + ...].
template <int K, int QN, int I0, int I1>
__device__ __forceinline__ void moment_pass(const PassCtx& c, bool with_cost) {
    constexpr int kW = items_width(K, QN, I0, I1);
    constexpr int kQm = 2 * QN;
    const VoxelSmem& s = c.s;
    const float* s_par = s.par;
    bool gz[K];
#pragma unroll
    for (int k = 0; k < K; ++k) gz[k] = c.g_zero[k] != 0;
    float acc[kW + 1];
#pragma unroll
    for (int j = 0; j <= kW; ++j) acc[j] = 0.f;
    // y of the lane's next sample is loaded one sample ahead.
    float y_re = c.lane < c.n_t ? c.y_re[c.lane] : 0.f;
    float y_im = c.lane < c.n_t ? c.y_im[c.lane] : 0.f;
    for (int i = c.lane; i < c.n_t; i += 32) {
        const bool more = i + 32 < c.n_t;
        const float y_re_next = more ? c.y_re[i + 32] : 0.f;
        const float y_im_next = more ? c.y_im[i + 32] : 0.f;
        const float ti = c.s_t[i];
        float b_re[K], b_im[K];
        float m_re = 0.f, m_im = 0.f;
        if (c.factored) {
            const int r = i % kBlockT;
            const int q = i / kBlockT;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float gr = s.work[k * kBlockT + r];
                const float gi = s.work[(K + k) * kBlockT + r];
                const float fr = s.work[2 * K * kBlockT + k * c.n_q + q];
                const float fi = s.work[2 * K * kBlockT + (K + k) * c.n_q + q];
                if (gz[k]) {
                    b_re[k] = fr * gr - fi * gi;
                    b_im[k] = fr * gi + fi * gr;
                } else {
                    const float amp = s_par[k * 5 + 0];
                    const float lw = s_par[k * 5 + 2];
                    const float gv = s_par[k * 5 + 4];
                    const float d = kPi * lw;
                    const float env =
                        amp * expf(-d * (1.0f - gv + gv * ti) * ti);
                    b_re[k] = env * (fr * gr - fi * gi);
                    b_im[k] = env * (fr * gi + fi * gr);
                }
                m_re += b_re[k];
                m_im += b_im[k];
            }
        } else {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float amp = s_par[k * 5 + 0];
                const float lw = s_par[k * 5 + 2];
                const float gv = s_par[k * 5 + 4];
                const float env =
                    gz[k]
                        ? amp * expf((-kPi) * lw * ti)
                        : amp * expf((-kPi) * lw * (1.0f - gv + gv * ti) * ti);
                const float ang = c.w_cs_unit * s_par[k * 5 + 1] * ti +
                                  s_par[k * 5 + 3] * kDeg;
                float sn, cs;
                sincosf(ang, &sn, &cs);
                // Rounded products, as where they feed the moments too: a
                // cost-only pass must not fuse them into the model sum.
                b_re[k] = __fmul_rn(env, cs);
                b_im[k] = __fmul_rn(env, sn);
                m_re += b_re[k];
                m_im += b_im[k];
            }
        }
        const float r_re = y_re - m_re;
        const float r_im = y_im - m_im;
        y_re = y_re_next;
        y_im = y_im_next;
        if (with_cost)
            s.cp[((i >> 5) & 7) * 32 + c.lane] += r_re * r_re + r_im * r_im;
        float tp[kQm + 1];
        tp[0] = 1.f;
#pragma unroll
        for (int q = 1; q <= kQm; ++q) tp[q] = tp[q - 1] * ti;
        update_items<K, QN, I0, I1, 0>(acc, b_re, b_im, r_re, r_im, tp);
    }
    reduce_items<K, QN, I0, I1, 0>(acc, s, c.lane);
}

template <int K, int QN, int kBudget, int P>
__device__ __forceinline__ void run_passes(const PassCtx& c, bool fuse_cost) {
    if constexpr (P < n_passes(K, QN, kBudget)) {
        constexpr int i0 = pass_start(K, QN, P, kBudget);
        constexpr int i1 = pass_start(K, QN, P + 1, kBudget);
        moment_pass<K, QN, i0, i1>(c, P == 0 && fuse_cost);
        run_passes<K, QN, kBudget, P + 1>(c, fuse_cost);
    }
}

// The cost from the lane partials: 8 warp sums added in m mod 8 order.
__device__ __forceinline__ float warp_cost(const VoxelSmem& s, int lane) {
    float c = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) c += warp_sum(s.cp[m * 32 + lane]);
    return c;
}

// One voxel by one warp: writes its cost and g, stages H (F x F, row-major)
// in s.work and returns true; with the gate, a rejected voxel writes its
// cost only and returns false.
template <int K, int QN, int kBudget>
__device__ __forceinline__ bool warp_eval(const WarpArgs& a,
                                          const VoxelSmem& s,
                                          const float* s_t, long long v,
                                          int lane) {
    const int n_t = a.n_t;
    const int n_free = a.n_free;
    const int n_rows = a.n_rows;
    const Structure& st = a.st;
    const float* s_par = s.par;
    const float* s_dx = s.dx;
    const float w_cs_unit = a.w_cs_unit;
    constexpr int q_m = 2 * QN;
    PassCtx c{s_t, a.y_re + v * n_t, a.y_im + v * n_t, st.g_zero, s,
              n_t, n_t / kBlockT, a.factored, lane, w_cs_unit};

    // ---- 1. tables, cost (and the gate) ----
    if (a.factored)
        factored_tables(s_par, s_t, st.g_zero, K, c.n_q, w_cs_unit, s.work,
                        s.work + K * kBlockT, s.work + 2 * K * kBlockT,
                        s.work + 2 * K * kBlockT + K * c.n_q, lane, 32);
#pragma unroll
    for (int m = 0; m < 8; ++m) s.cp[m * 32 + lane] = 0.f;
    __syncwarp();
    const bool gate = a.cost_prev != nullptr;
    if (gate) {
        moment_pass<K, QN, 0, 0>(c, true);
        const float cost = warp_cost(s, lane);
        if (lane == 0) a.cost[v] = cost;
        if (!(cost < a.cost_prev[v])) return false;
    }

    // ---- 2. moments, in passes ----
    run_passes<K, QN, kBudget, 0>(c, !gate);
    if (!gate) {
        const float cost = warp_cost(s, lane);
        if (lane == 0) a.cost[v] = cost;
    }
    __syncwarp();

    // ---- 3a. per-row coefficient terms (alpha, beta, degree) * m_r ----
    for (int r = lane; r < n_rows; r += 32) {
        const int k = st.row_peak[r];
        const int pt = st.row_ptype[r];
        const float m = s_dx[st.row_slot[r]] * a.row_scale[r];
        float al0 = 0.f, be0 = 0.f, al1 = 0.f, be1 = 0.f;
        int d0 = 0, d1 = 0, nt = 1;
        if (pt == 0) {  // amplitude
            const float amp = s_par[k * 5 + 0];
            const float safe = (amp == 0.f) ? 1.f : amp;
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
        s.al[r * 2 + 0] = al0 * m;
        s.be[r * 2 + 0] = be0 * m;
        s.deg[r * 2 + 0] = d0;
        s.al[r * 2 + 1] = al1 * m;
        s.be[r * 2 + 1] = be1 * m;
        s.deg[r * 2 + 1] = d1;
        s.nterm[r] = nt;
    }
    __syncwarp();

    // ---- 3b. gradient g_f = sum_rows sum_terms Re(conj(z_d) N_d[k]) ----
    for (int f = lane; f < n_free; f += 32) {
        float acc = 0.f;
        for (int rr = st.slot_ptr[f]; rr < st.slot_ptr[f + 1]; ++rr) {
            const int r = st.slot_rows[rr];
            const int k = st.row_peak[r];
            for (int i = 0; i < s.nterm[r]; ++i) {
                const int d = s.deg[r * 2 + i];
                const float nr = s.nm[(k * (QN + 1) + d) * 2 + 0];
                const float ni = s.nm[(k * (QN + 1) + d) * 2 + 1];
                acc = acc + s.al[r * 2 + i] * nr + s.be[r * 2 + i] * ni;
            }
        }
        a.g[v * n_free + f] = acc;
    }

    // ---- 3c. Hessian, upper triangle f <= h, mirrored, staged ----
    const int n_upper = n_free * (n_free + 1) / 2;
    for (int e = lane; e < n_upper; e += 32) {
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
                const int sr = st.slot_rows[sa];
                const int ks = st.row_peak[sr];
                const bool ordered = kr <= ks;
                const int p = ordered ? pair_index(kr, ks, K)
                                      : pair_index(ks, kr, K);
                for (int i = 0; i < s.nterm[r]; ++i) {
                    const float ar = s.al[r * 2 + i], br = s.be[r * 2 + i];
                    for (int j = 0; j < s.nterm[sr]; ++j) {
                        const float as = s.al[sr * 2 + j];
                        const float bs = s.be[sr * 2 + j];
                        const int q = s.deg[r * 2 + i] + s.deg[sr * 2 + j];
                        const float mr = s.mm[(p * (q_m + 1) + q) * 2 + 0];
                        float mi = s.mm[(p * (q_m + 1) + q) * 2 + 1];
                        if (!ordered) mi = -mi;
                        acc = acc + ((ar * as + br * bs) * mr -
                                     (br * as - ar * bs) * mi);
                    }
                }
            }
        }
        s.work[f * n_free + hh] = acc;
        if (hh != f) s.work[hh * n_free + f] = acc;
    }
    __syncwarp();
    return true;
}

// K2 (kSlab: H as the voxel-minor slab (F*F, B)) and K9 (dense (B, F, F)).
template <int K, int QN, class C>
__global__ void __launch_bounds__(kVox * 32, C::blocks)
    normal_eq_warp_kernel(const WarpArgs a) {
    extern __shared__ float smem[];
    __shared__ int s_ok[kVox];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const long long v0 = (long long)blockIdx.x * kVox;
    const long long v = v0 + w;
    const bool mine = lane < kVox && v0 + lane < a.b &&
                      (a.mask == nullptr || a.mask[v0 + lane] != 0);
    const unsigned live = __ballot_sync(0xffffffffu, mine);
    if (!((live >> w) & 1u)) return;  // masked or past the batch
    const int n_live = __popc(live);
    const int rank = __popc(live & ((1u << w) - 1u));
    const int n_t = a.n_t;
    const int n_free = a.n_free;
    float* s_t = smem;
    float* areas = smem + pad4(n_t);
    for (int i = rank * 32 + lane; i < n_t; i += n_live * 32) s_t[i] = a.t[i];
    const VoxelSmem s =
        voxel_smem(areas + w * a.stride, K, QN, n_free, a.n_rows);
    for (int j = lane; j < K * 5; j += 32) s.par[j] = a.params[v * K * 5 + j];
    for (int f = lane; f < n_free; f += 32)
        s.dx[f] = a.dxdu != nullptr ? a.dxdu[v * n_free + f] : 1.f;
    live_barrier(n_live);

    const bool ok = warp_eval<K, QN, C::budget>(a, s, s_t, v, lane);

    const int ff = n_free * n_free;
    if constexpr (C::slab) {
        const int work_off = (int)(s.work - (areas + w * a.stride));
        if (lane == 0) s_ok[w] = ok;
        live_barrier(n_live);
        // Slab row e of the block: its kVox voxels side by side.
        for (int idx = rank * 32 + lane; idx < ff * kVox; idx += n_live * 32) {
            const int e = idx / kVox;
            const int j = idx % kVox;
            if (((live >> j) & 1u) && s_ok[j])
                a.h[(long long)e * a.b + v0 + j] =
                    areas[j * a.stride + work_off + e];
        }
    } else if (ok) {
        for (int e = lane; e < ff; e += 32) a.h[v * ff + e] = s.work[e];
    }
}

template <int K, int QN, class C>
int launch_warp(WarpArgs a, cudaStream_t stream) {
    a.stride = warp_stride(a.n_t, K, QN, a.n_free, a.n_rows, a.factored);
    const size_t smem =
        warp_smem_bytes(a.n_t, K, QN, a.n_free, a.n_rows, a.factored);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            normal_eq_warp_kernel<K, QN, C>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (a.b > 0) {
        const long long blocks = (a.b + kVox - 1) / kVox;
        normal_eq_warp_kernel<K, QN, C>
            <<<(unsigned)blocks, kVox * 32, smem, stream>>>(a);
    }
    return (int)cudaGetLastError();
}

template <class C, int K, int QN, int QN_MAX>
int launch_warp_qn(const WarpArgs& a, int q_n, cudaStream_t stream) {
    if constexpr (QN > QN_MAX) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (q_n == QN) return launch_warp<K, QN, C>(a, stream);
        return launch_warp_qn<C, K, QN + 1, QN_MAX>(a, q_n, stream);
    }
}

// The instantiation for (n_peaks, q_n), n_peaks in [K, K_MAX] and q_n in
// [QN_MIN, QN_MAX]; anything else is refused.
template <class C, int QN_MIN, int QN_MAX, int K = 1, int K_MAX = kMaxPeaks>
int launch_warp_any(const WarpArgs& a, int n_peaks, int q_n,
                    cudaStream_t stream) {
    if constexpr (K > K_MAX) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (n_peaks == K)
            return launch_warp_qn<C, K, QN_MIN, QN_MAX>(a, q_n, stream);
        return launch_warp_any<C, QN_MIN, QN_MAX, K + 1, K_MAX>(
            a, n_peaks, q_n, stream);
    }
}

}  // namespace
