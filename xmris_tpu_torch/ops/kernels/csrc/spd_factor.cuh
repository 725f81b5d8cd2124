// Pieces of the damped SPD solve shared by K3, K4, K6a, K6b and the
// whole-loop LM kernel K8, so that all of them run the same arithmetic in
// the same order: the LM damping of a diagonal entry, and the warp factor
// and substitutions (one warp per matrix, the factor in registers: a row a
// lane up to 32 rows, two rows a lane up to 64).  Every product and sum is
// rounded on its own (no fused multiply-add), as in the plain PyTorch
// versions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The LM damping of a diagonal entry: a + lam*max(a, 1e-12) + 1e-12.
__device__ __forceinline__ float damp(float a, float lam) {
    return __fadd_rn(__fadd_rn(a, __fmul_rn(lam, fmaxf(a, 1e-12f))), 1e-12f);
}

// ---------------------------------------------------------------------------
// The warp factor: one warp per matrix, lane i holds row i of the Cholesky
// factor in registers, a[j] = L(i, j) for j <= i.  Every loop runs kF trips,
// the row count n (<= 32) rounded up to a multiple of 4, with no branch, so
// the independent shuffles of a column issue together.  Rows n..kF-1 are
// padding, the identity with a zero right-hand side: no lane of a real row
// ever reads a padding lane's value except through a product that is an
// exact +0 (warp_back), so every operation on the first n rows is the
// plain version's, in its order (the factor column by column, each
// substitution in the serial order of a single thread).  Call them through
// XMT_WARP_ROWS.
// ---------------------------------------------------------------------------

// Runs STMT with `constexpr int kF` = n rounded up to a multiple of 4, for
// 1 <= n <= 32.
#define XMT_WARP_ROWS(n, ...)                                   \
    switch (((n) + 3) / 4) {                                    \
        case 1: { constexpr int kF = 4; __VA_ARGS__; } break;   \
        case 2: { constexpr int kF = 8; __VA_ARGS__; } break;   \
        case 3: { constexpr int kF = 12; __VA_ARGS__; } break;  \
        case 4: { constexpr int kF = 16; __VA_ARGS__; } break;  \
        case 5: { constexpr int kF = 20; __VA_ARGS__; } break;  \
        case 6: { constexpr int kF = 24; __VA_ARGS__; } break;  \
        case 7: { constexpr int kF = 28; __VA_ARGS__; } break;  \
        case 8: { constexpr int kF = 32; __VA_ARGS__; } break;  \
    }

// Loads row `lane` of the symmetric n x n matrix (`load(j, i)` reads A[j][i],
// j <= i: the upper triangle, column i by symmetry), maps its diagonal entry
// by `diag`, and factors in place: column k scaled by 1/sqrt(pivot) (both
// steps correctly rounded; a non-positive pivot gives NaN), then the
// outer-product update of the trailing columns.
template <int kF, typename Load, typename Diag>
__device__ __forceinline__ void warp_factor(int n, Load load, Diag diag,
                                            float (&a)[kF]) {
    const int lane = threadIdx.x & 31;
    const bool real = lane < n;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        const float x = (j <= lane && real) ? load(j, lane) : 0.f;
        a[j] = (j == lane) ? (real ? diag(x) : 1.f) : x;
    }
#pragma unroll
    for (int k = 0; k < kF; ++k) {
        float dk = __shfl_sync(kFull, a[k], k);
        dk = dk > 0.f ? dk : NAN;
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(dk));
        if (lane >= k) a[k] = __fmul_rn(a[k], inv);
#pragma unroll
        for (int j = k + 1; j < kF; ++j) {
            const float ljk = __shfl_sync(kFull, a[k], j);
            if (lane >= j) a[j] = __fsub_rn(a[j], __fmul_rn(a[k], ljk));
        }
    }
}

// Forward substitution L y = b by columns (`b` is lane i's b_i, 0 on a
// padding lane): y_i takes its subtractions j = 0..i-1 in order.  Returns
// lane i's y_i.
template <int kF>
__device__ __forceinline__ float warp_forward(const float (&a)[kF], float b) {
    const int lane = threadIdx.x & 31;
    float acc = b, y = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        if (lane == j) y = __fdiv_rn(acc, a[j]);
        const float yj = __shfl_sync(kFull, y, j);
        if (lane > j) acc = __fsub_rn(acc, __fmul_rn(a[j], yj));
    }
    return y;
}

// Back substitution L^T x = y in the serial order: lane j > i forms
// L(j, i) x_j, lane i subtracts them for j = i+1, i+2, ...  A padding lane
// forms +0, which leaves every difference as it is (also -0, inf and NaN).
// Returns lane i's x_i.
template <int kF>
__device__ __forceinline__ float warp_back(const float (&a)[kF], float y,
                                           int n) {
    const int lane = threadIdx.x & 31;
    const bool real = lane < n;
    float x = 0.f;
#pragma unroll
    for (int i = kF - 1; i >= 0; --i) {
        const float p = real ? __fmul_rn(a[i], x) : 0.f;
        float acc = y;
#pragma unroll
        for (int j = i + 1; j < kF; ++j)
            acc = __fsub_rn(acc, __shfl_sync(kFull, p, j));
        if (lane == i) x = __fdiv_rn(acc, a[i]);
    }
    return x;
}

// ---------------------------------------------------------------------------
// The wide warp factor, 32 < n <= 64: two rows a lane.  Lane l holds row l
// in lo[j] (j <= l) and row l + 32 in hi[j] (j <= l + 32), so row r sits in
// lane r & 31.  Every loop runs kF trips, n rounded up to a multiple of 16,
// the padding rows as above; XMT_WARP_ROWS_WIDE instantiates kF = 48 alone
// (33 <= n <= 48: the 12-line 7 T brain prior's F = 48), as each trip of
// the fully unrolled factor is code, and kF = 64 would double the build.  Each row takes the narrow
// factor's operations in the narrow factor's order: a real row reads
// another lane's value where the narrow version reads lane r's, at
// register lo[...] for r < 32 and hi[...] past it.  An index `j & 31`
// names lo[j] where j < 32 holds by the loop; it only keeps the index of
// a dead branch in range.  The narrow functions above, which K3/K4/K6a/K6b
// at F <= 32 and K8 run, are left as they are.  Call them through
// XMT_WARP_ROWS_WIDE.
// ---------------------------------------------------------------------------

// Runs STMT with `constexpr int kF` = n rounded up to a multiple of 16, for
// 32 < n <= 48.
#define XMT_WARP_ROWS_WIDE(n, ...)                              \
    switch (((n) + 15) / 16) {                                  \
        case 3: { constexpr int kF = 48; __VA_ARGS__; } break;  \
    }

template <int kF>
struct WideRows {
    float lo[32];  // row lane: L(lane, j), j <= lane
    float hi[kF];  // row lane + 32: L(lane + 32, j), j <= lane + 32
};

// warp_factor for two rows a lane (see there): the loads, the diagonal
// map, then column k scaled by 1/sqrt(pivot) and the trailing columns
// updated, rows lane and lane + 32 each as the narrow factor's lane.
template <int kF, typename Load, typename Diag>
__device__ __forceinline__ void warp_factor_wide(int n, Load load, Diag diag,
                                                 WideRows<kF>& a) {
    const int lane = threadIdx.x & 31;
    const int r1 = lane + 32;
    const bool real0 = lane < n;
    const bool real1 = r1 < n;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const float x = (j <= lane && real0) ? load(j, lane) : 0.f;
        a.lo[j] = (j == lane) ? (real0 ? diag(x) : 1.f) : x;
    }
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        const float x = (j <= r1 && real1) ? load(j, r1) : 0.f;
        a.hi[j] = (j == r1) ? (real1 ? diag(x) : 1.f) : x;
    }
#pragma unroll
    for (int k = 0; k < kF; ++k) {
        float dk = __shfl_sync(kFull, k < 32 ? a.lo[k & 31] : a.hi[k], k & 31);
        dk = dk > 0.f ? dk : NAN;
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(dk));
        if (k < 32 && lane >= k) a.lo[k & 31] = __fmul_rn(a.lo[k & 31], inv);
        if (r1 >= k) a.hi[k] = __fmul_rn(a.hi[k], inv);
#pragma unroll
        for (int j = k + 1; j < kF; ++j) {
            const float ljk = __shfl_sync(
                kFull, j < 32 ? a.lo[k & 31] : a.hi[k], j & 31);
            if (j < 32 && lane >= j)
                a.lo[j & 31] =
                    __fsub_rn(a.lo[j & 31], __fmul_rn(a.lo[k & 31], ljk));
            if (r1 >= j) a.hi[j] = __fsub_rn(a.hi[j], __fmul_rn(a.hi[k], ljk));
        }
    }
}

// warp_forward for two rows a lane: (b0, b1) are rows lane and lane + 32 of
// b (0 on a padding row); returns their y in (y0, y1).
template <int kF>
__device__ __forceinline__ void warp_forward_wide(const WideRows<kF>& a,
                                                  float b0, float b1,
                                                  float& y0, float& y1) {
    const int lane = threadIdx.x & 31;
    const int r1 = lane + 32;
    float acc0 = b0, acc1 = b1;
    y0 = 0.f;
    y1 = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
        if (j < 32) {
            if (lane == j) y0 = __fdiv_rn(acc0, a.lo[j & 31]);
            const float yj = __shfl_sync(kFull, y0, j & 31);
            if (lane > j)
                acc0 = __fsub_rn(acc0, __fmul_rn(a.lo[j & 31], yj));
            acc1 = __fsub_rn(acc1, __fmul_rn(a.hi[j], yj));  // r1 > j
        } else {
            if (r1 == j) y1 = __fdiv_rn(acc1, a.hi[j]);
            const float yj = __shfl_sync(kFull, y1, j & 31);
            if (r1 > j) acc1 = __fsub_rn(acc1, __fmul_rn(a.hi[j], yj));
        }
    }
}

// warp_back for two rows a lane: row j > i forms L(j, i) x_j in the lane
// that holds it (+0 on a padding row), row i's lane subtracts them for
// j = i+1, i+2, ... and divides.  Returns rows lane and lane + 32 of x.
template <int kF>
__device__ __forceinline__ void warp_back_wide(const WideRows<kF>& a,
                                               float y0, float y1, int n,
                                               float& x0, float& x1) {
    const int lane = threadIdx.x & 31;
    const bool real0 = lane < n;
    const bool real1 = lane + 32 < n;
    x0 = 0.f;
    x1 = 0.f;
#pragma unroll
    for (int i = kF - 1; i >= 0; --i) {
        const float p1 = real1 ? __fmul_rn(a.hi[i], x1) : 0.f;
        const float p0 =
            (i < 32 && real0) ? __fmul_rn(a.lo[i & 31], x0) : 0.f;
        float acc = i < 32 ? y0 : y1;
#pragma unroll
        for (int j = i + 1; j < kF; ++j)
            acc = __fsub_rn(acc, __shfl_sync(kFull, j < 32 ? p0 : p1, j & 31));
        if (i < 32) {
            if (lane == i) x0 = __fdiv_rn(acc, a.lo[i & 31]);
        } else {
            if (lane + 32 == i) x1 = __fdiv_rn(acc, a.hi[i]);
        }
    }
}

}  // namespace
