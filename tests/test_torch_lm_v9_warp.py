"""The warp evaluation of K2 and K9 (``csrc/lm_v9_warp.cuh``), checked where
there is no card.

The CUDA kernels run only on the card (``test_torch_cuda.py`` holds them
against their plain twins there, and ``scripts/compare_kernel_builds.py``
against another build bit for bit).  Here their index algebra and
summation orders are run in NumPy, from the Python mirror of the layout
that the wrappers size the kernels' shared memory with
(``lm_cuda.moment_items``, ``moment_passes``, ``warp_stride``,
``warp_smem_bytes``):

* every (moment item, power) is owned by exactly one pass, and every
  sample by exactly one lane, for K = 1..8 and q_n = 0..2;
* the per-lane moment sums of the passes, with an emulated fused
  multiply-add, and the warp butterfly equal bit for bit the block
  kernel's per-item warp order, and match a float64 sum;
* the cost's 8 partials a lane equal the 256-thread block tree bit for bit;
* the staged H stores (slab rows of the block's voxels; dense blocks)
  write each entry of each stored voxel exactly once;
* the shared memory stays within 227 KB at the shapes the prior allows,
  and the wrapper's check refuses a time axis that exceeds it.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from xmris_tpu_torch.ops.kernels import lm_cuda as L

CSRC = Path(L.__file__).resolve().parent / "csrc"


def _fma(a, b, c):
    """float32 fused multiply-add, emulated in float64 (the product of two
    float32 is exact there)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _warp_sum(x):
    """lm_v9_eval.cuh's warp_sum, lane 0's value (xor butterfly)."""
    x = np.asarray(x, np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        x = (x + x[np.arange(32) ^ off]).astype(np.float32)
    return x[0]


def _header_int(name, source="lm_v9_warp.cuh"):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_mirror_constants_are_the_header_s():
    assert L.WARP_VOXELS == _header_int("kVox")
    assert L.K2_PASS_BUDGET == _header_int("kPassBudget", "lm_v9.cu")
    assert L.K9_PASS_BUDGET == _header_int("kPassBudget", "lm_v8.cu")
    eval_text = (CSRC / "lm_v9_eval.cuh").read_text()
    for name, val in (("kMaxPeaks", L.MAX_PEAKS), ("kMaxFree", L.MAX_FREE),
                      ("kMaxQn", L.MAX_QN), ("kBlockT", L._BLOCK_T)):
        assert re.search(rf"constexpr int {name} = {val};", eval_text), name


@pytest.mark.parametrize("budget", [L.K2_PASS_BUDGET, L.K9_PASS_BUDGET])
@pytest.mark.parametrize("q_n", [0, 1, 2])
@pytest.mark.parametrize("n_peaks", range(1, L.MAX_PEAKS + 1))
def test_every_item_power_owned_once(n_peaks, q_n, budget):
    items = L.moment_items(n_peaks, q_n)
    # The block kernel's items: N_k, then pair p = pair_index(k, k').
    assert [(k, kp) for k, kp, _ in items[:n_peaks]] == [
        (k, -1) for k in range(n_peaks)]
    for p, (k, kp, n_pow) in enumerate(items[n_peaks:]):
        assert k <= kp and n_pow == 2 * q_n + 1
        assert p == k * n_peaks - k * (k - 1) // 2 + (kp - k)
    passes = L.moment_passes(n_peaks, q_n, budget)
    owned = {}
    for n, (i0, i1) in enumerate(passes):
        assert i0 < i1
        width = sum(2 * items[i][2] for i in range(i0, i1))
        assert width <= budget or i1 == i0 + 1
        for i in range(i0, i1):
            for q in range(items[i][2]):
                assert (i, q) not in owned
                owned[(i, q)] = n
    assert set(owned) == {(i, q) for i, it in enumerate(items)
                          for q in range(it[2])}
    # Greedy: a pass ends only where the next item does not fit.
    for i0, i1 in passes[:-1]:
        width = sum(2 * items[i][2] for i in range(i0, i1))
        assert width + 2 * items[i1][2] > budget
    # The bench shape (K = 5, q_n = 1): 110 accumulators, two passes for
    # K2, one for K9.
    if (n_peaks, q_n) == (5, 1):
        assert len(passes) == (2 if budget == L.K2_PASS_BUDGET else 1)


@pytest.mark.parametrize("n_t", [96, 1000, 1020, 1024])
def test_every_sample_owned_by_one_lane(n_t):
    seen = np.zeros(n_t, int)
    for lane in range(32):
        samples = list(range(lane, n_t, 32))
        assert samples == sorted(samples)  # m ascending
        seen[samples] += 1
    assert (seen == 1).all()


def _bases(n_peaks, n_t, seed):
    rng = np.random.default_rng(seed)
    t = (np.arange(n_t) / 5000.0).astype(np.float32)
    b_re = rng.normal(size=(n_peaks, n_t)).astype(np.float32)
    b_im = rng.normal(size=(n_peaks, n_t)).astype(np.float32)
    r_re = rng.normal(size=n_t).astype(np.float32)
    r_im = rng.normal(size=n_t).astype(np.float32)
    return t, b_re, b_im, r_re, r_im


def _item_terms(item, i, b_re, b_im, r_re, r_im):
    """The (re, im) product a sample adds to an item, with the kernels'
    contraction (the first product fused into the add)."""
    k, kp, _ = item
    if kp < 0:
        br, bi = b_re[k, i], b_im[k, i]
        return (_fma(br, r_re[i], np.float32(bi * r_im[i])),
                _fma(br, r_im[i], np.float32(-(bi * r_re[i]))))
    ar, ai, br, bi = b_re[k, i], b_im[k, i], b_re[kp, i], b_im[kp, i]
    return (_fma(ar, br, np.float32(ai * bi)),
            _fma(ai, br, np.float32(-(ar * bi))))


def _powers(ti, q_max):
    tp = [np.float32(1.0)]
    for _ in range(q_max):
        tp.append(np.float32(tp[-1] * ti))
    return tp


def _add(acc, tq, x, q):
    """acc += t^q x: a plain add at q = 0 (t^0 = 1 folds away), else a
    fused multiply-add."""
    return np.float32(acc + x) if q == 0 else _fma(tq, x, acc)


@pytest.mark.parametrize("n_peaks,q_n,n_t", [(5, 1, 96), (2, 2, 100),
                                             (8, 2, 64), (3, 0, 70)])
def test_pass_sums_are_the_block_order(n_peaks, q_n, n_t):
    t, b_re, b_im, r_re, r_im = _bases(n_peaks, n_t, n_peaks + n_t)
    items = L.moment_items(n_peaks, q_n)
    # The block kernel: one warp per item, each lane its samples in order.
    old = {}
    for it, item in enumerate(items):
        n_pow = item[2]
        lanes = np.zeros((n_pow, 2, 32), np.float32)
        for lane in range(32):
            for i in range(lane, n_t, 32):
                xr, xi = _item_terms(item, i, b_re, b_im, r_re, r_im)
                tp = _powers(t[i], 2 * q_n)
                for q in range(n_pow):
                    lanes[q, 0, lane] = _add(lanes[q, 0, lane], tp[q], xr, q)
                    lanes[q, 1, lane] = _add(lanes[q, 1, lane], tp[q], xi, q)
        for q in range(n_pow):
            old[(it, q)] = (_warp_sum(lanes[q, 0]), _warp_sum(lanes[q, 1]))
    # The warp kernel: per pass, each lane sweeps its samples once and
    # updates every item of the pass at each sample.
    new = {}
    for i0, i1 in L.moment_passes(n_peaks, q_n, L.K2_PASS_BUDGET):
        acc = {(it, q): np.zeros((2, 32), np.float32)
               for it in range(i0, i1) for q in range(items[it][2])}
        for lane in range(32):
            for i in range(lane, n_t, 32):
                tp = _powers(t[i], 2 * q_n)
                for it in range(i0, i1):
                    xr, xi = _item_terms(items[it], i, b_re, b_im, r_re, r_im)
                    for q in range(items[it][2]):
                        a = acc[(it, q)]
                        a[0, lane] = _add(a[0, lane], tp[q], xr, q)
                        a[1, lane] = _add(a[1, lane], tp[q], xi, q)
        for key, a in acc.items():
            new[key] = (_warp_sum(a[0]), _warp_sum(a[1]))
    assert set(new) == set(old)
    for key in old:
        assert (np.asarray(new[key]).tobytes()
                == np.asarray(old[key]).tobytes()), key
    # And against a float64 sum: only float32 rounding apart.
    t64 = t.astype(np.float64)
    for (it, q), (sr, si) in new.items():
        k, kp, _ = items[it]
        if kp < 0:
            z = (b_re[k] + 1j * b_im[k]).astype(np.complex128)
            w = np.conj(z) * (r_re + 1j * r_im)
        else:
            a = (b_re[k] + 1j * b_im[k]).astype(np.complex128)
            w = a * np.conj(b_re[kp] + 1j * b_im[kp])
        ref = (t64 ** q * w).sum()
        scale = (t64 ** q * np.abs(w)).sum()
        assert abs(sr - ref.real) <= 1e-5 * scale + 1e-30
        assert abs(si - ref.imag) <= 1e-5 * scale + 1e-30


@pytest.mark.parametrize("n_t", [100, 1000, 1020, 1024])
def test_cost_partials_are_the_block_tree(n_t):
    rng = np.random.default_rng(n_t)
    terms = rng.uniform(0.0, 3.0, n_t).astype(np.float32)
    # The block: thread tid = 32 w + l sums samples tid + 256 j; the 8 warp
    # sums are added in w order.
    acc = np.zeros(256, np.float32)
    for i in range(n_t):
        acc[i % 256] = np.float32(acc[i % 256] + terms[i])
    old = np.float32(0.0)
    for w in range(8):
        old = np.float32(old + _warp_sum(acc[32 * w:32 * w + 32]))
    # The warp: lane l's partial (i >> 5) & 7 over its samples i = l + 32 m.
    part = np.zeros((8, 32), np.float32)
    for lane in range(32):
        for i in range(lane, n_t, 32):
            m = (i >> 5) & 7
            part[m, lane] = np.float32(part[m, lane] + terms[i])
    new = np.float32(0.0)
    for m in range(8):
        new = np.float32(new + _warp_sum(part[m]))
    assert new.tobytes() == old.tobytes()


def _staged(n_free):
    """Stage 3c: lanes over the upper entries, each written to (f, h) and
    mirrored to (h, f)."""
    writes = np.zeros((n_free, n_free), int)
    n_upper = n_free * (n_free + 1) // 2
    for lane in range(32):
        for e in range(lane, n_upper, 32):
            f, rem = 0, e
            while rem >= n_free - f:
                rem -= n_free - f
                f += 1
            h = f + rem
            writes[f, h] += 1
            if h != f:
                writes[h, f] += 1
    return writes


@pytest.mark.parametrize("n_free", [1, 5, 20, 25, 32])
def test_staged_h_stores_write_each_entry_once(n_free):
    assert (_staged(n_free) == 1).all()
    ff, kvox = n_free * n_free, L.WARP_VOXELS
    # Dense (K9): each voxel's F x F block, lanes over e.
    dense = np.zeros(ff, int)
    for lane in range(32):
        dense[np.arange(lane, ff, 32)] += 1
    assert (dense == 1).all()
    # Slab (K2): the block's live, accepted voxels' slab rows, idx = e *
    # kVox + j, rank-strided over the live warps; a partial last block.
    b = 3 * kvox + 5
    rng = np.random.default_rng(n_free)
    mask = rng.uniform(size=b) < 0.7
    accepted = rng.uniform(size=b) < 0.8
    writes = np.zeros((ff, b), int)
    for block in range((b + kvox - 1) // kvox):
        v0 = block * kvox
        live = [w for w in range(kvox) if v0 + w < b and mask[v0 + w]]
        for rank, _ in enumerate(live):
            for lane in range(32):
                for idx in range(rank * 32 + lane, ff * kvox, len(live) * 32):
                    e, j = divmod(idx, kvox)
                    if j in live and accepted[v0 + j]:
                        writes[e, v0 + j] += 1
    want = (mask & accepted)[None, :].astype(int).repeat(ff, 0)
    assert (writes == want).all()
    # 32 lanes of a slab-row read (4 rows x kVox voxels) hit 32 banks.
    stride = L.warp_stride(1024, 5, 1, n_free, n_free, True)
    assert stride % 32 == 4
    for e0 in range(0, ff, 4):
        banks = {(j * stride + e0 + de) % 32 for de in range(4)
                 for j in range(kvox)}
        assert len(banks) == 32


def _prior_plan(n_peaks, q_n, n_free, factored):
    ptypes = {0: (0, 3), 1: (0, 1, 2, 3), 2: (0, 1, 2, 3, 4)}[q_n]
    active = tuple(k * 5 + p for k in range(n_peaks) for p in ptypes)
    n_rows = len(active)
    return L.NormalEqPlan(
        n_peaks=n_peaks, n_free=n_free, mhz=120.0, active=active,
        g_zero=(q_n < 2,) * n_peaks,
        fold_slots=tuple(min(r, n_free - 1) for r in range(n_rows)),
        fold_scales=(1.0,) * n_rows, factored=factored)


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("q_n", [0, 1, 2])
def test_shared_memory_fits_and_the_wrapper_refuses_more(q_n, factored):
    for n_peaks in range(1, L.MAX_PEAKS + 1):
        n_rows = len(_prior_plan(n_peaks, q_n, 1, factored).active)
        plan = _prior_plan(n_peaks, q_n, min(n_rows, L.MAX_FREE), factored)
        assert plan.q_n == q_n
        # The bench length and the largest the reference's bench runs.
        for n_t in (1024, 4096):
            smem = L.warp_smem_bytes(n_t, n_peaks, q_n, plan.n_free,
                                     len(plan.active), factored)
            assert smem <= L._SMEM_LIMIT
            L.check_warp_plan(plan, n_t)
        # The first n_t (a multiple of 128) past the limit is refused.
        n_t = 1024
        while L.warp_smem_bytes(n_t, n_peaks, q_n, plan.n_free,
                                len(plan.active), factored) <= L._SMEM_LIMIT:
            n_t += 128
        with pytest.raises(ValueError, match="shared memory"):
            L.check_warp_plan(plan, n_t)
        L.check_warp_plan(plan, n_t - 128)
    # The bench shape: 65 664 bytes, against the block design's 53 KB a
    # voxel (its check stays the whole-loop kernel's).
    assert L.warp_smem_bytes(1024, 5, 1, 20, 20, True) == 65664


def test_wrapper_refuses_a_prior_past_the_bounds():
    """K9 keeps the narrow caps; K2 takes a prior past them to its wide
    build, up to the wide caps, and refuses one past those."""
    plan = _prior_plan(L.MAX_PEAKS, 2, L.MAX_FREE, True)
    too_many = dataclasses.replace(plan, n_free=L.MAX_FREE + 1)
    with pytest.raises(ValueError, match="too large"):
        L.check_warp_plan(too_many, 1024, caps=L.NARROW_CAPS)
    assert not L.is_wide(plan) and L.is_wide(too_many)
    L.check_warp_plan(too_many, 1024)
    plan = _prior_plan(L.WIDE_MAX_PEAKS, 2, L.WIDE_MAX_FREE, True)
    L.check_warp_plan(plan, 1024)
    for past in (dataclasses.replace(plan, n_free=L.WIDE_MAX_FREE + 1),
                 _prior_plan(L.WIDE_MAX_PEAKS + 1, 1, 4, True)):
        with pytest.raises(ValueError, match="prior too large for the kernel"):
            L.check_warp_plan(past, 1024)


def test_wide_build_mirror_and_its_reach():
    """K2's wide build (``csrc/lm_v9_wide.cu``): its constants are the
    mirror's, its instantiations cover every prior past the narrow caps
    (K = 9..12 at any q_n, K = 7, 8 with a freed g, which a narrow plan
    past 32 free parameters needs) up to 48 free parameters, the SPD
    kernels' reach, and its shared memory fits at the bench length and four
    times it."""
    text = (CSRC / "lm_v9_wide.cu").read_text()
    assert L.K2_WIDE_PASS_BUDGET == _header_int("kPassBudget", "lm_v9_wide.cu")
    assert L.WIDE_MAX_PEAKS == _header_int("kWidePeaks", "lm_v9_wide.cu")
    assert "constexpr int kWideRows = 5 * kWidePeaks;" in text
    assert L.WIDE_MAX_FREE == _header_int("kWideFree", "lm_v9_wide.cu") == 48
    assert "launch_warp_any<Wide, 0, kMaxQn, kMaxPeaks + 1, kWidePeaks>(" in text
    assert "launch_warp_any<Wide, kMaxQn, kMaxQn, kMaxPeaks - 1, kMaxPeaks>(" in text
    for n_peaks in range(1, L.WIDE_MAX_PEAKS + 1):
        for q_n in (0, 1, 2):
            n_rows = len(_prior_plan(n_peaks, q_n, 1, True).active)
            for n_free in range(1, min(n_rows, L.WIDE_MAX_FREE) + 1):
                plan = _prior_plan(n_peaks, q_n, n_free, True)
                if not L.is_wide(plan):
                    continue
                assert n_peaks > L.MAX_PEAKS or (
                    n_peaks >= L.MAX_PEAKS - 1 and plan.q_n == 2)
                for n_t in (1024, 4096):
                    L.check_warp_plan(plan, n_t)
    # The 12-line 7 T brain prior (F = 48, q_n = 1) at the bench length.
    assert L.warp_smem_bytes(1024, 12, 1, 48, 48, True) <= L._SMEM_LIMIT
    assert len(L.moment_passes(12, 1, L.K2_WIDE_PASS_BUDGET)) == 5


@pytest.mark.parametrize("q_n", [0, 1, 2])
@pytest.mark.parametrize("n_peaks", range(L.MAX_PEAKS + 1, L.WIDE_MAX_PEAKS + 1))
def test_wide_items_owned_once(n_peaks, q_n):
    """Past 8 peaks every (item, power) is owned by one pass of the wide
    budget, greedily, as at the narrow widths."""
    items = L.moment_items(n_peaks, q_n)
    passes = L.moment_passes(n_peaks, q_n, L.K2_WIDE_PASS_BUDGET)
    assert passes[0][0] == 0 and passes[-1][1] == len(items)
    for (_, a1), (b0, _) in zip(passes, passes[1:]):
        assert a1 == b0
    for i0, i1 in passes:
        width = sum(2 * items[i][2] for i in range(i0, i1))
        assert width <= L.K2_WIDE_PASS_BUDGET
        if i1 < len(items):
            assert width + 2 * items[i1][2] > L.K2_WIDE_PASS_BUDGET
