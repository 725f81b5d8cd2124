// K3, K4, K6a and K6b: per-voxel damped SPD solve and inverse diagonal.
//
// K3 replaces xmris_tpu/ops/kernels/spd.py::spd_solve_damped_pallas_slab
// (_spd_solve_kernel, _chol_cols_slab): A_kk += lam*max(A_kk, 1e-12) + 1e-12
// on the diagonal only, Cholesky-Crout in outer-product form, then forward
// and back substitution.  K4 replaces spd_inverse_diag_pallas_slab
// (_spd_inv_diag_kernel): a Tikhonov term on the diagonal, Cholesky, and
// diag(A^-1)_c = sum_i (L^-1)_ic^2 by one forward substitution per column.
// K6a replaces spd_solve_damped_pallas and K6b spd_inverse_diag_pallas: the
// same functions on dense row-major (B, F, F) input (the non-slab LM's
// step; fit_amares's CRLB adds its 1e-12 ridge before the K6b call, which
// runs with a Tikhonov term of 0).  A non-positive pivot makes it NaN,
// which spreads to the whole output row, as in the reference (the LM reads
// a NaN step as a rejected one).
//
// What bounds them on the H100: each reads the upper triangle of the
// Hessians once (13.8 MB per bench grid of 16 384 voxels at F = 20, ~4 us
// at 3.35 TB/s) and does ~F^3/3 = 2.7 kFLOP per voxel, sequentially
// dependent.
//
// Design: one kernel template per function, on the layout of A.  One warp
// per voxel (8 voxels a block on the dense layout, 16 on the slab); lane
// i reads A[j][i] for j <= i (the upper triangle, column i by symmetry)
// through the layout, holds row i of the Cholesky factor in registers
// (spd_factor.cuh's warp factor and substitutions, as K8 runs them,
// unrolled over F rounded up to a multiple of 4); each column step is a
// few shuffles, and 16 384 warps fill the card.  The inverse diagonal
// then forms column c of L^-1 in lane c (warp_inverse_diag): every lane
// divides at once, where a lane per row of L^-1 left each row's divisions
// to one lane (2.2x slower, and 72 registers with spills).
// Past 32 rows (the 12-line 7 T brain prior's F = 48) the same templates
// take the wide factor of spd_factor.cuh, two rows a lane (rows l and
// l + 32 in lane l), unrolled over kF = 48 (33 <= F <= 48), and the
// inverse diagonal forms columns l and l + 32 in lane l, one after the
// other (warp_inverse_diag_wide).  The slab tile then holds 8 voxels a
// block (kWideSlabVoxels), so that it stays a static array under 48 KB;
// the factor's ~F^3/3 dependent steps per warp now bound them.  The
// instantiations at F <= 32 are as before (if constexpr on kF).  The design
// this replaced ran a thread per voxel with its packed factor in local
// memory: K6a/K6b 0.45 / 0.53 ms against 0.059 / 0.074, K3/K4 0.092 /
// 0.125 against 0.063 / 0.074 (H100 80GB HBM3, 700 W;
// scripts/ablate_spd.py).
// Layouts: Dense reads a voxel's rows where they lie (row j of a voxel is
// contiguous across the lanes).  K2's voxel-minor slab (F*F, B) puts entry
// (j, i) of voxel v at h[(j*f + i)*b + v]: contiguous across voxels, not
// lanes, so lane i of a warp would touch a sector of its own.  SlabTile
// copies the block's voxels' upper-triangle rows into a shared tile first,
// coalesced (a row's 16 voxels are two 32-byte sectors), then each warp
// reads its voxel from the tile at an odd stride, free of bank conflicts.
// Every kernel factors, substitutes and forms the inverse diagonal in the
// same sequence of correctly rounded operations whatever the layout, so
// K6a equals K3, and K6b K4 with no Tikhonov term, bit for bit on the same
// matrices.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn, no fused multiply-add) in the order of the plain PyTorch
// version, so the two agree to the last bits on the card.

#include <cuda_runtime.h>
#include <math.h>

#include "spd_factor.cuh"

namespace {

constexpr int kMaxF = 48;   // two rows a lane past 32
constexpr int kWarpRows = 32;  // the narrow factor's rows, one a lane
constexpr int kWarpVoxels = 8;  // voxels (warps) per block, dense layout
// Voxels per block of the slab layout, chosen by scripts/ablate_spd.py
// (H100 80GB HBM3, 700 W): K4 0.0735 ms at 16 (8 voxels 0.0774 at 73
// registers, 3 blocks an SM; 32 voxels 0.0744; direct slab loads 0.0787),
// as its 16 warps a block at 60 registers keep 32 warps an SM resident;
// K3 0.0629 at 16, within 1 % of its best (0.0622 at 8; 32 voxels 0.0672,
// direct 0.0675).
constexpr int kSlabVoxels = 16;

// Voxels per block of the slab layout past 32 rows: the most that keeps the
// static tile (kF (kF + 1) / 2 rows at stride kV + 1) under 48 KB at
// kF = 48.
constexpr int kWideSlabVoxels = 8;

// A layout is built by every thread of the block before any warp returns;
// at(v) then gives voxel v's load(j, i) = A[j][i], j <= i < f.

// Dense row-major (B, F, F): row j of voxel v at h + (v*f + j)*f.
struct Dense {
    static constexpr int kVoxels = kWarpVoxels;
    const float* h;
    int f;
    __device__ Dense(const float* h_, int, int f_) : h(h_), f(f_) {}
    __device__ auto at(long long v) const {
        const float* hv = h + v * f * f;
        const int n = f;
        return [hv, n](int j, int i) { return hv[j * n + i]; };
    }
};

// The voxel-minor slab (F*F, B) through a shared tile of the block's kV
// voxels: row t of the packed upper triangle (t = j*f - j(j+1)/2 + i for
// j <= i) at tile[t*kStride + u] for voxel v0 + u.  The block stages kV
// threads a row and 32 rows a pass (coalesced: a row's kV voxels are
// contiguous), each thread's kTrips loads in flight together, then waits
// at a barrier.  kStride = kV + 1 is odd, so a warp's reads (lanes
// i = j..f-1 of one voxel: consecutive t) fall in 32 different banks.
// Voxels past b stage zeros that no warp reads.
template <int kF, int kV>
struct SlabTile {
    static constexpr int kVoxels = kV;
    static constexpr int kStride = kV + 1;
    static constexpr int kRows = kF * (kF + 1) / 2;
    static constexpr int kTrips = (kRows + 31) / 32;
    const float* tile;
    int f;
    __device__ SlabTile(const float* h, int b, int f_)
        : tile(stage(h, b, f_)), f(f_) {}
    __device__ static const float* stage(const float* h, int b, int f) {
        __shared__ float s[kRows * kStride];
        const long long v0 = (long long)blockIdx.x * kV;
        const int u = threadIdx.x % kV;
        const bool in = v0 + u < b;
        // Row t = threadIdx.x / kV + 32 p of the packed triangle is (j, i):
        // i runs past the end of row j into row j + 1, which starts at
        // i = j + 1; j = f past the last row.
        float x[kTrips];
        int j = 0, i = threadIdx.x / kV;
#pragma unroll
        for (int p = 0; p < kTrips; ++p) {
            while (j < f && i >= f) {
                i -= f - 1 - j;
                ++j;
            }
            x[p] = (j < f && in) ? h[(long long)(j * f + i) * b + v0 + u] : 0.f;
            i += 32;
        }
#pragma unroll
        for (int p = 0; p < kTrips; ++p) {
            const int t = threadIdx.x / kV + 32 * p;
            if (t < kRows) s[t * kStride + u] = x[p];
        }
        __syncthreads();
        return s;
    }
    __device__ auto at(long long v) const {
        const float* sv = tile + (v - (long long)blockIdx.x * kV);
        const int n = f;
        return [sv, n](int j, int i) {
            return sv[(j * n - j * (j + 1) / 2 + i) * kStride];
        };
    }
};

// diag(A^-1) from the warp factor in K4's order: lane c forms column c of
// X = L^-1, x[i] = X(i, c) = (delta_ic - sum_{j=c}^{i-1} L(i, j) X(j, c)) /
// L(i, i), each L(i, j) and L(i, i) broadcast from lane i, and adds
// X(i, c)^2 to its sum for i = c..n-1 in ascending i from 0.  Every lane
// divides at once (kF divisions a lane).  Rows n..kF-1 are padding: they
// come after every real row and are not summed, so they add nothing to a
// real column.  Returns lane c's out_c.
template <int kF>
__device__ __forceinline__ float warp_inverse_diag(const float (&a)[kF],
                                                   int n) {
    const int lane = threadIdx.x & 31;
    float x[kF];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
        float acc = (i == lane) ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < i; ++j) {
            const float lij = __shfl_sync(kFull, a[j], i);
            if (j >= lane) acc = __fsub_rn(acc, __fmul_rn(lij, x[j]));
        }
        x[i] = __fdiv_rn(acc, __shfl_sync(kFull, a[i], i));
        if (i >= lane && i < n) sum = __fadd_rn(sum, __fmul_rn(x[i], x[i]));
    }
    return sum;
}

// warp_inverse_diag for two rows a lane (spd_factor.cuh's wide factor):
// lane c forms column c of X = L^-1 as warp_inverse_diag does, each L(i, j)
// broadcast from the lane that holds row i, then column c + 32, whose
// rows i < 32 are zero and are skipped.  Returns out_c and out_{c+32}.
template <int kF>
__device__ __forceinline__ void warp_inverse_diag_wide(
    const WideRows<kF>& a, int n, float& out0, float& out1) {
    const int lane = threadIdx.x & 31;
    const int c1 = lane + 32;
    float x[kF];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
        float acc = (i == lane) ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < i; ++j) {
            const float lij =
                __shfl_sync(kFull, i < 32 ? a.lo[j & 31] : a.hi[j], i & 31);
            if (j >= lane) acc = __fsub_rn(acc, __fmul_rn(lij, x[j]));
        }
        x[i] = __fdiv_rn(acc, __shfl_sync(kFull, i < 32 ? a.lo[i & 31] : a.hi[i],
                                          i & 31));
        if (i >= lane && i < n) sum = __fadd_rn(sum, __fmul_rn(x[i], x[i]));
    }
    out0 = sum;
    sum = 0.f;
#pragma unroll
    for (int i = 32; i < kF; ++i) {
        float acc = (i == c1) ? 1.f : 0.f;
#pragma unroll
        for (int j = 32; j < i; ++j) {
            const float lij = __shfl_sync(kFull, a.hi[j], i & 31);
            if (j >= c1) acc = __fsub_rn(acc, __fmul_rn(lij, x[j]));
        }
        x[i] = __fdiv_rn(acc, __shfl_sync(kFull, a.hi[i], i & 31));
        if (i >= c1 && i < n) sum = __fadd_rn(sum, __fmul_rn(x[i], x[i]));
    }
    out1 = sum;
}

// K3 (SlabTile) and K6a (Dense): the damped factor and both substitutions;
// a warp past the last voxel returns.
template <int kF, class Layout>
__global__ void __launch_bounds__(32 * Layout::kVoxels)
    spd_solve_damped_kernel(const float* __restrict__ h,
                            const float* __restrict__ g,
                            const float* __restrict__ lam,
                            float* __restrict__ out, int b, int f) {
    const Layout layout(h, b, f);
    const long long v =
        (long long)blockIdx.x * Layout::kVoxels + threadIdx.x / 32;
    if (v >= b) return;
    const int lane = threadIdx.x & 31;
    const float lv = lam[v];
    if constexpr (kF <= kWarpRows) {
        float a[kF];
        warp_factor<kF>(f, layout.at(v), [lv](float x) { return damp(x, lv); },
                        a);
        const float rhs = lane < f ? g[v * f + lane] : 0.f;
        const float x = warp_back<kF>(a, warp_forward<kF>(a, rhs), f);
        if (lane < f) out[v * f + lane] = x;
    } else {
        WideRows<kF> a;
        warp_factor_wide<kF>(f, layout.at(v),
                             [lv](float x) { return damp(x, lv); }, a);
        const float rhs0 = lane < f ? g[v * f + lane] : 0.f;
        const float rhs1 = lane + 32 < f ? g[v * f + lane + 32] : 0.f;
        float y0, y1, x0, x1;
        warp_forward_wide<kF>(a, rhs0, rhs1, y0, y1);
        warp_back_wide<kF>(a, y0, y1, f, x0, x1);
        if (lane < f) out[v * f + lane] = x0;
        if (lane + 32 < f) out[v * f + lane + 32] = x1;
    }
}

// K4 (SlabTile) and K6b (Dense, tikhonov 0): the factor with `tikhonov`
// added to the diagonal, then the inverse diagonal; a warp past the last
// voxel returns.
template <int kF, class Layout>
__global__ void __launch_bounds__(32 * Layout::kVoxels)
    spd_inverse_diag_kernel(const float* __restrict__ h,
                            float* __restrict__ out, int b, int f,
                            float tikhonov) {
    const Layout layout(h, b, f);
    const long long v =
        (long long)blockIdx.x * Layout::kVoxels + threadIdx.x / 32;
    if (v >= b) return;
    const int lane = threadIdx.x & 31;
    if constexpr (kF <= kWarpRows) {
        float a[kF];
        warp_factor<kF>(f, layout.at(v),
                        [tikhonov](float x) { return __fadd_rn(x, tikhonov); },
                        a);
        const float d = warp_inverse_diag<kF>(a, f);
        if (lane < f) out[v * f + lane] = d;
    } else {
        WideRows<kF> a;
        warp_factor_wide<kF>(
            f, layout.at(v),
            [tikhonov](float x) { return __fadd_rn(x, tikhonov); }, a);
        float d0, d1;
        warp_inverse_diag_wide<kF>(a, f, d0, d1);
        if (lane < f) out[v * f + lane] = d0;
        if (lane + 32 < f) out[v * f + lane + 32] = d1;
    }
}

template <int kF, class Layout>
void launch_solve(const float* h, const float* g, const float* lam,
                  float* out, int b, int f, void* stream) {
    constexpr int kV = Layout::kVoxels;
    spd_solve_damped_kernel<kF, Layout>
        <<<(b + kV - 1) / kV, 32 * kV, 0, (cudaStream_t)stream>>>(
            h, g, lam, out, b, f);
}

template <int kF, class Layout>
void launch_inverse_diag(const float* h, float* out, int b, int f,
                         float tikhonov, void* stream) {
    constexpr int kV = Layout::kVoxels;
    spd_inverse_diag_kernel<kF, Layout>
        <<<(b + kV - 1) / kV, 32 * kV, 0, (cudaStream_t)stream>>>(
            h, out, b, f, tikhonov);
}

}  // namespace

extern "C" int xmt_spd_solve_damped(const float* h, const float* g,
                                    const float* lam, float* out, int b, int f,
                                    void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        if (f <= kWarpRows) {
            XMT_WARP_ROWS(f, launch_solve<kF, SlabTile<kF, kSlabVoxels>>(
                                 h, g, lam, out, b, f, stream))
        } else {
            XMT_WARP_ROWS_WIDE(
                f, launch_solve<kF, SlabTile<kF, kWideSlabVoxels>>(
                       h, g, lam, out, b, f, stream))
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_inverse_diag(const float* h, float* out, int b, int f,
                                    float tikhonov, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        if (f <= kWarpRows) {
            XMT_WARP_ROWS(f, launch_inverse_diag<kF, SlabTile<kF, kSlabVoxels>>(
                                 h, out, b, f, tikhonov, stream))
        } else {
            XMT_WARP_ROWS_WIDE(
                f,
                launch_inverse_diag<kF, SlabTile<kF, kWideSlabVoxels>>(
                    h, out, b, f, tikhonov, stream))
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_solve_damped_dense(const float* h, const float* g,
                                          const float* lam, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        if (f <= kWarpRows) {
            XMT_WARP_ROWS(f, launch_solve<kF, Dense>(h, g, lam, out, b, f, stream))
        } else {
            XMT_WARP_ROWS_WIDE(
                f, launch_solve<kF, Dense>(h, g, lam, out, b, f, stream))
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int xmt_spd_inverse_diag_dense(const float* h, float* out, int b,
                                          int f, void* stream) {
    if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        if (f <= kWarpRows) {
            XMT_WARP_ROWS(f, launch_inverse_diag<kF, Dense>(h, out, b, f, 0.f,
                                                            stream))
        } else {
            XMT_WARP_ROWS_WIDE(f, launch_inverse_diag<kF, Dense>(h, out, b, f,
                                                                 0.f, stream))
        }
    }
    return (int)cudaGetLastError();
}
