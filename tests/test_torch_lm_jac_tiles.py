"""The explicit-Jacobian kernel's tile map, checked where there is no card.

The CUDA kernel (``csrc/lm_jac.cu``: K7, K10-K14) runs only on the card
(``test_torch_cuda.py`` holds it against its plain twin there).  Here its
index algebra is run in NumPy, from the same Python mirror of the layout
that the wrapper sizes the kernel's shared memory with
(``lm_jac_cuda.row_groups``, ``sample_pitch``, ``voxel_floats``,
``tile_map``):

* every upper-triangle H entry (r, s) and every g entry is owned by exactly
  one lane and round, for R = 1..40;
* no lane reads past its voxel's chunk table, and a row group's 16-byte
  read stays inside its plane's padded rows;
* the tiled sums, run in the kernel's order with an emulated fused
  multiply-add, equal bit for bit a per-entry loop over the samples (the
  order of the kernel this one replaced), and match the plain twin;
* the cost's per-lane accumulators and four warp sums equal the 256-thread,
  128-sample reduction bit for bit.
"""

import numpy as np
import pytest
import torch

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.fitting.lm import hashable_pmap
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops.bounds import expand_params_batched
from xmris_tpu_torch.ops.kernels import lm_jac_cuda as J

TILE = J._TILE
CHUNK = J._CHUNK


def _fma(a, b, c):
    """float32 fused multiply-add, emulated in float64 (the product of two
    float32 is exact there)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("n_rows", range(1, J.MAX_ROWS + 1))
def test_every_entry_owned_once_and_reads_in_bounds(n_rows):
    nb = J.row_groups(n_rows)
    n_p = TILE * nb
    pitch = J.sample_pitch(n_rows)
    assert n_p >= n_rows + 1 and pitch == 2 * n_p + 4
    assert (pitch // 4) % 2 == 1  # 8 lanes' 16-byte stores: 8 bank groups
    tiles = J.tile_map(n_rows)
    assert len({(lane, rnd) for lane, rnd, _, _ in tiles}) == len(tiles)
    assert max(rnd for _, rnd, _, _ in tiles) < 3  # the kernel's 3 rounds
    owned = {}
    for lane, rnd, a, b in tiles:
        assert a <= b < nb
        for p in range(TILE):
            for q in range(TILE):
                r, s = a * TILE + p, b * TILE + q
                if r > s or r >= n_rows or s > n_rows:
                    continue
                assert (r, s) not in owned
                owned[(r, s)] = (lane, rnd)
        # The four 16-byte reads of every sample of the chunk.
        for c in (0, CHUNK - 1):
            for g in (a, b):
                for plane in (0, n_p):
                    lo = c * pitch + plane + g * TILE
                    assert lo % 4 == 0 and lo + TILE <= c * pitch + plane + n_p
                    assert lo + TILE <= CHUNK * pitch
    want = {(r, s) for r in range(n_rows) for s in range(r, n_rows + 1)}
    assert set(owned) == want  # H's upper triangle and g (s == R)
    floats = J.voxel_floats(n_rows, 8, 1024, True)
    assert floats % 4 == 0 and floats >= CHUNK * pitch


def _jacobian_planes(n_rows, n_t, b=3):
    """(B, R, n_t) float32 Jacobian planes and residuals of the plain twin
    at seeded parameters of the bench prior."""
    pk = prior_from_csv_text(bi.PK_CSV)
    ps = hashable_pmap(pk.pmap)
    fids, _, _ = bi.make_inputs((b, 1, 1))
    rng = np.random.default_rng(0)
    x = np.clip(pk.init_free[None] * rng.uniform(0.8, 1.2, (b, pk.n_free)),
                pk.lower, pk.upper).astype(np.float32)
    grids = expand_params_batched(torch.as_tensor(x), ps).contiguous()
    re = torch.as_tensor(np.ascontiguousarray(fids.real[:, :n_t]))
    im = torch.as_tensor(np.ascontiguousarray(fids.imag[:, :n_t]))
    t = torch.arange(n_t, dtype=torch.float32) / bi.SW
    rows = tuple(range(n_rows))
    j_re, j_im, r_re, r_im, _ = J._jacobian(grids, re, im, t, pk.n_peaks,
                                            bi.MHZ, rows)
    args = (grids, re, im, t, pk.n_peaks, bi.MHZ, rows)
    return (j_re.numpy(), j_im.numpy(), r_re.numpy(), r_im.numpy()), args


def _tiled_sums(j_re, j_im, r_re, r_im, n_rows):
    """One voxel's (R+1, R+1) tiled Gram sums in the kernel's layout and
    order: per chunk the [sample][row] table (re rows, im rows, residual as
    row R, zero padding), then per tile and sample the 32 fused
    multiply-adds."""
    n_t = j_re.shape[1]
    nb = J.row_groups(n_rows)
    n_p = TILE * nb
    pitch = J.sample_pitch(n_rows)
    tiles = J.tile_map(n_rows)
    acc = {(a, b): np.zeros((TILE, TILE), np.float32) for _, _, a, b in tiles}
    for c0 in range(0, n_t, CHUNK):
        table = np.zeros(CHUNK * pitch, np.float32)
        for c in range(CHUNK):
            i = c0 + c
            if i >= n_t:
                continue
            col = np.zeros(n_p, np.float32)
            col[:n_rows], col[n_rows] = j_re[:, i], r_re[i]
            table[c * pitch:c * pitch + n_p] = col
            col = np.zeros(n_p, np.float32)
            col[:n_rows], col[n_rows] = j_im[:, i], r_im[i]
            table[c * pitch + n_p:c * pitch + 2 * n_p] = col
        for _, _, a, b in tiles:
            for c in range(CHUNK):
                base = c * pitch
                ar = table[base + a * TILE:base + a * TILE + TILE]
                ai = table[base + n_p + a * TILE:base + n_p + a * TILE + TILE]
                br = table[base + b * TILE:base + b * TILE + TILE]
                bi_ = table[base + n_p + b * TILE:base + n_p + b * TILE + TILE]
                e = acc[(a, b)]
                e[:] = _fma(ar[:, None], br[None, :], e)
                e[:] = _fma(ai[:, None], bi_[None, :], e)
    return acc


@pytest.mark.parametrize("n_rows,n_t", [(7, 96), (20, 200), (25, 200),
                                        (25, 128)])
def test_tiled_sums_keep_each_entry_order(n_rows, n_t):
    (j_re, j_im, r_re, r_im), args = _jacobian_planes(n_rows, n_t)
    _, g_plain, h_plain = J._normal_eq_jac_plain(*args)
    for v in range(j_re.shape[0]):
        acc = _tiled_sums(j_re[v], j_im[v], r_re[v], r_im[v], n_rows)
        a_re = np.vstack([j_re[v], r_re[v][None]])
        a_im = np.vstack([j_im[v], r_im[v][None]])
        h = np.zeros((n_rows, n_rows), np.float32)
        g = np.zeros(n_rows, np.float32)
        for (a, b), e in acc.items():
            for p in range(TILE):
                for q in range(TILE):
                    r, s = a * TILE + p, b * TILE + q
                    if r > s or r >= n_rows or s > n_rows:
                        continue
                    # The parent kernel's per-entry loop over the samples.
                    ref = np.float32(0.0)
                    for i in range(n_t):
                        ref = _fma(a_re[r, i], a_re[s, i], ref)
                        ref = _fma(a_im[r, i], a_im[s, i], ref)
                    assert e[p, q].tobytes() == ref.tobytes(), (r, s)
                    if s == n_rows:
                        g[r] = e[p, q]
                    else:
                        h[r, s] = h[s, r] = e[p, q]
        # Against the plain twin per entry, at 1e-3 of its Cauchy-Schwarz
        # bound (the card tests' tolerance; torch sums in another order).
        hp, gp = h_plain[v].numpy(), g_plain[v].numpy()
        d = np.sqrt(np.abs(np.diag(hp)).astype(np.float64))
        cost = float((r_re[v].astype(np.float64) ** 2
                      + r_im[v].astype(np.float64) ** 2).sum())
        assert np.all(np.abs(h - hp) <= 1e-4 * np.abs(hp) + 1e-3 * np.outer(d, d))
        assert np.all(np.abs(g - gp) <= 1e-4 * np.abs(gp) + 1e-3 * d
                      * np.sqrt(cost))


def _warp_sum(x):
    """lm_v9_eval.cuh's warp_sum, lane 0's value (xor butterfly)."""
    x = x.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(32) ^ off]).astype(np.float32)
    return x[0]


@pytest.mark.parametrize("n_t", [100, 1000, 1024])
def test_cost_reduction_is_the_block_reductions(n_t):
    rng = np.random.default_rng(n_t)
    terms = rng.uniform(0.0, 3.0, n_t).astype(np.float32)
    # The parent: 256 threads, 128-sample chunks, thread c takes sample c of
    # every chunk; 8 warp sums added in order.
    acc = np.zeros(256, np.float32)
    for i in range(n_t):
        acc[i % 128] = np.float32(acc[i % 128] + terms[i])
    old = np.float32(0.0)
    for w in range(8):
        old = np.float32(old + _warp_sum(acc[32 * w:32 * w + 32]))
    # The tiled kernel: lane l's accumulator (i % 128) // 32, 32-sample
    # chunks; four warp sums added in order.
    lanes = np.zeros((4, 32), np.float32)
    for c0 in range(0, n_t, CHUNK):
        w = (c0 // CHUNK) & 3
        for lane in range(CHUNK):
            if c0 + lane < n_t:
                lanes[w, lane] = np.float32(lanes[w, lane] + terms[c0 + lane])
    new = np.float32(0.0)
    for w in range(4):
        new = np.float32(new + _warp_sum(lanes[w]))
    assert new.tobytes() == old.tobytes()
