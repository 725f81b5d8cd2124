"""The warp design of K3, K4, K6a and K6b (``csrc/spd.cu`` on
``spd_factor.cuh``), checked where there is no card.

The CUDA kernels run only on the card (``test_torch_cuda.py`` holds them
against their plain twins and against each other there, and
``scripts/compare_kernel_builds.py`` against another build bit for bit).
Here a NumPy float32 model of their warp schedule, every operation
rounded on its own, runs the same sequence of operations:

* the layout's loads: lane i reads A[j][i], j <= i, from the dense
  (B, F, F) form (K6a/K6b) or from K2's voxel-minor slab (F*F, B) through
  ``SlabTile``'s shared tile (K3/K4): the block's voxels' packed upper
  rows staged by the source's walk, 32 rows a pass, into a tile poisoned
  with NaN, then read back at the source's odd stride;
* the warp factor: lane i holds row i of L, rows padded with the identity
  to a multiple of 4 (``XMT_WARP_ROWS``), the damped diagonal for K3/K6a
  and the diagonal plus the Tikhonov term for K4/K6b (0 for K6b);
* the forward substitution by columns and the back substitution in the
  serial order, padding lanes forming +0;
* the inverse diagonal by columns: lane c forms column c of L^-1 from the
  rows of L broadcast from their lanes, and sums its squares in ascending
  i;

and must equal the plain versions bit for bit, NaN rows exactly at the
non-SPD voxels, for F = 1..32, K3/K4 at a batch that is not a multiple of
a block's voxels.  Past 32 rows the model of the wide factor (two rows a
lane: row l in ``lo``, row l + 32 in ``hi``, padded to 48, the inverse
diagonal's columns l and l + 32 one after the other, the tile at
``kWideSlabVoxels``) is a transcription of the CUDA loops, each
register and shuffle by name, and must equal the plain versions the same
way.  Poisoned padding rows leave every real output as it
is: the padding adds nothing to a real row or column.  Source checks pin
what the model assumes of the kernels' source: the shared warp factor for
all four, the tile's stride and size, shared memory in the slab layout
only, and the padding switch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from xmris_tpu_torch.ops.kernels import spd

CSRC = Path(spd.__file__).resolve().parent / "csrc"
LANES = 32
F32 = np.float32
TINY = F32(1e-12)


def _rows(n):
    """XMT_WARP_ROWS: n rounded up to a multiple of 4."""
    return 4 * ((n + 3) // 4)


def _packed(j, n):
    """Row t of the packed upper triangle of (j, i), i >= j: j*n - j(j+1)/2 + i
    (``SlabTile::at``), as an offset to add i to."""
    return j * n - j * (j + 1) // 2


def _stage_walk(n, kf):
    """``SlabTile::stage``'s walk: for each of a pass's 32 rows (q) and each
    trip p, the packed row t = q + 32 p and its (j, i), j = n past the last
    row."""
    rows = kf * (kf + 1) // 2
    out = []
    for q in range(LANES):
        j, i = 0, q
        for p in range((rows + 31) // 32):
            while j < n and i >= n:
                i -= n - 1 - j
                j += 1
            out.append((q + 32 * p, j, i))
            i += 32
    return out


def _tile_loads(slab, n, kv, kf=None):
    """K3/K4's loads: each block of kv voxels stages its packed upper rows
    into a tile poisoned with NaN (zeros for voxels past B), then voxel
    v0 + u's lane i reads row j at tile[(packed(j) + i) * (kv + 1) + u].
    ``kf``: the tile's rows, n padded (``_rows(n)`` by default)."""
    b = slab.shape[1]
    kf = _rows(n) if kf is None else kf
    rows, stride = kf * (kf + 1) // 2, kv + 1
    n_blocks = -(-b // kv)
    padded = np.zeros((n * n, n_blocks * kv), F32)
    padded[:, :b] = slab
    tile = np.full((n_blocks, rows * stride), np.nan, F32)
    for t, j, i in _stage_walk(n, kf):
        if t >= rows:
            continue
        for u in range(kv):
            tile[:, t * stride + u] = (
                padded[j * n + i, u::kv] if j < n else F32(0))
    v = np.arange(b)
    blk, u = v // kv, v % kv

    def load(j):
        idx = (_packed(j, n) + np.arange(j, n)[None, :]) * stride + u[:, None]
        return tile[blk[:, None], idx]
    return load


def _dense_loads(h):
    return lambda j: h[:, j, j:]


def _warp_factor(load, b, n, diag, pad=None):
    """Registers after ``warp_factor``: a[v, lane, j] = L(lane, j), j <= lane.

    ``load(j)`` gives A[j][i] for i = j..n-1 (lanes j..n-1 load, as in the
    kernel); ``diag`` maps a real lane's diagonal entry.  ``pad``, if given,
    overwrites the padding lanes' rows after the load (a poisoned
    padding)."""
    kf = _rows(n)
    lane = np.arange(LANES)
    real = lane < n
    a = np.zeros((b, LANES, kf), F32)
    for j in range(kf):
        col = np.zeros((b, LANES), F32)  # load(j, lane) = A[j][lane]
        if j < n:
            col[:, j:n] = load(j)
        x = np.where((j <= lane) & real, col, F32(0))
        a[:, :, j] = np.where(lane == j, np.where(real, diag(x), F32(1)), x)
    if pad is not None:
        a[:, n:, :] = pad
    for k in range(kf):
        dk = a[:, k, k]  # lane k's a[k]
        dk = np.where(dk > 0, dk, F32(np.nan))
        inv = F32(1) / np.sqrt(dk)
        a[:, k:, k] = a[:, k:, k] * inv[:, None]
        for j in range(k + 1, kf):
            ljk = a[:, j, k]  # lane j's a[k]
            a[:, j:, j] = a[:, j:, j] - a[:, j:, k] * ljk[:, None]
    return a


def _warp_forward(a, rhs):
    """``warp_forward``: lane i's y_i, its subtractions j = 0..i-1 in order."""
    kf = a.shape[2]
    acc = rhs.copy()
    y = np.zeros_like(rhs)
    for j in range(kf):
        y[:, j] = acc[:, j] / a[:, j, j]
        acc[:, j + 1:] = acc[:, j + 1:] - a[:, j + 1:, j] * y[:, j, None]
    return y


def _warp_back(a, y, n):
    """``warp_back``: lane j > i forms L(j, i) x_j (+0 on a padding lane),
    lane i subtracts them for j = i+1, i+2, ... and divides."""
    kf = a.shape[2]
    real = np.arange(LANES) < n
    x = np.zeros_like(y)
    for i in reversed(range(kf)):
        p = np.where(real, a[:, :, i] * x, F32(0))
        acc = y[:, i].copy()
        for j in range(i + 1, kf):
            acc = acc - p[:, j]
        x[:, i] = acc / a[:, i, i]
    return x


def _warp_inverse_diag(a, n):
    """``warp_inverse_diag``: lane c forms column c of X = L^-1, X(i, c) =
    (delta_ic - sum_{j=c}^{i-1} L(i, j) X(j, c)) / L(i, i), each L(i, j)
    and L(i, i) broadcast from lane i, and adds X(i, c)^2 for i = c..n-1."""
    b, _, kf = a.shape
    lane = np.arange(LANES)
    x = np.zeros((b, LANES, kf), F32)  # lane c's x[i] = X(i, c)
    s = np.zeros((b, LANES), F32)
    for i in range(kf):
        acc = np.broadcast_to((lane == i).astype(F32), (b, LANES)).copy()
        for j in range(i):
            lij = a[:, i, j, None]  # lane i's a[j]
            acc = np.where(j >= lane, acc - lij * x[:, :, j], acc)
        x[:, :, i] = acc / a[:, i, i, None]
        if i < n:
            s = np.where(i >= lane, s + x[:, :, i] * x[:, :, i], s)
    return s


def _loads(h, layout, kv, kf=None):
    """The kernel's loads of dense (B, n, n) ``h`` in ``layout``: "dense"
    (K6a/K6b) or "slab" (K3/K4: the slab form through the tile)."""
    n = h.shape[1]
    if layout == "dense":
        return _dense_loads(h)
    slab = np.ascontiguousarray(h.transpose(1, 2, 0).reshape(n * n, -1))
    return _tile_loads(slab, n, kv, kf)


def model_solve_damped(h, g, lam, pad=None, layout="dense", kv=None):
    """K3's/K6a's schedule: out[v, i] = lane i's x_i."""
    b, n, _ = h.shape
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        def damp(x):
            return (x + lam[:, None] * np.maximum(x, TINY)) + TINY
        a = _warp_factor(_loads(h, layout, kv), b, n, damp, pad)
        rhs = np.zeros((b, LANES), F32)
        rhs[:, :n] = g
        return _warp_back(a, _warp_forward(a, rhs), n)[:, :n]


def model_inverse_diag(h, tikhonov=0.0, pad=None, layout="dense", kv=None):
    """K4's/K6b's schedule: out[v, c] = lane c's column sum."""
    b, n, _ = h.shape
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        a = _warp_factor(_loads(h, layout, kv), b, n,
                         lambda x: x + F32(tikhonov), pad)
        return _warp_inverse_diag(a, n)[:, :n]


def _case(f, seed, b=6):
    """b SPD matrices (voxel 5 with rows six orders of magnitude apart, as
    a Gauss-Newton H), and two planted non-SPD voxels: a negative first
    pivot (voxel 1) and a negative last pivot (voxel b - 2)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(b, f, f))
    h = m @ m.transpose(0, 2, 1) + 0.1 * f * np.eye(f)
    d = np.logspace(-3, 3, f)
    h[5] = d[:, None] * h[5] * d[None, :]
    h = h.astype(F32)
    h[1, 0, 0] = -1.0
    h[b - 2, f - 1, f - 1] = -4.0 * abs(h[b - 2, f - 1, f - 1]) - 1.0
    bad = np.zeros(b, bool)
    bad[[1, b - 2]] = True
    g = rng.normal(size=(b, f)).astype(F32)
    lam = np.logspace(-5, -1, b).astype(F32)
    return h, g, lam, bad


def _assert_bits(got, ref):
    """Equal bit for bit: NaN exactly where the other is NaN, every other
    entry's float32 bits (the sign of a zero included) the same."""
    got = np.asarray(got, F32)
    ref = np.asarray(ref, F32)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), ref[~nan].view(np.int32))


# K3/K4 at B = 37: four blocks of 8 voxels and a fifth of 5.
SLAB_B = 37


def _slab(h):
    return torch.from_numpy(np.ascontiguousarray(
        h.transpose(1, 2, 0).reshape(h.shape[1] ** 2, -1)))


@pytest.mark.parametrize("kernel", ["K6a", "K6b", "K3", "K4", "K4 ridge"])
@pytest.mark.parametrize("f", range(1, 33))
def test_model_equals_plain_bit_for_bit(f, kernel):
    if kernel.startswith("K6"):
        h, g, lam, bad = _case(f, seed=f)
    else:
        h, g, lam, bad = _case(f, seed=1000 + f, b=SLAB_B)
    th = torch.from_numpy(h)
    tg, tlam = torch.from_numpy(g), torch.from_numpy(lam)
    kv = _source_voxels()
    if kernel == "K6a":
        got = model_solve_damped(h, g, lam)
        ref = spd.spd_solve_damped_dense_plain(th, tg, tlam).numpy()
    elif kernel == "K6b":
        got = model_inverse_diag(h)
        ref = spd.spd_inverse_diag_dense_plain(th).numpy()
    elif kernel == "K3":
        got = model_solve_damped(h, g, lam, layout="slab", kv=kv)
        ref = spd.spd_solve_damped_plain(_slab(h), tg, tlam).numpy()
    else:
        tik = 1e-12 if kernel == "K4 ridge" else 0.0
        got = model_inverse_diag(h, tik, layout="slab", kv=kv)
        ref = spd.spd_inverse_diag_plain(_slab(h), tik).numpy()
    _assert_bits(got, ref)
    assert np.array_equal(np.isnan(got).all(1), bad)
    assert not np.isnan(got[~bad]).any()


@pytest.mark.parametrize("kv", [8, 32])
@pytest.mark.parametrize("n", [1, 4, 5, 19, 20, 21, 31, 32])
def test_stage_walk_covers_the_packed_upper_triangle(n, kv):
    """The staging walk names every upper-triangle row (j <= i < n) once,
    at its packed row t; the rest of the tile's rows stage zeros (j = n);
    and a tile at any block size gives the same outputs bit for bit."""
    kf = _rows(n)
    walk = _stage_walk(n, kf)
    upper = [(j, i) for j in range(n) for i in range(j, n)]
    real = sorted((t, j, i) for t, j, i in walk if j < n)
    assert real == [(t, j, i) for t, (j, i) in enumerate(upper)]
    assert all(_packed(j, n) + i == t for t, j, i in real)
    assert all(j == n for t, j, i in walk if t >= len(upper))
    assert {t for t, _, _ in walk} >= set(range(kf * (kf + 1) // 2))
    h, g, lam, _ = _case(n, seed=2000 + n, b=SLAB_B)
    _assert_bits(model_solve_damped(h, g, lam, layout="slab", kv=kv),
                 model_solve_damped(h, g, lam))
    _assert_bits(model_inverse_diag(h, 1e-12, layout="slab", kv=kv),
                 model_inverse_diag(h, 1e-12))


@pytest.mark.parametrize("f", [1, 2, 3, 5, 18, 21, 30, 31])
def test_padding_adds_nothing_to_a_real_row(f):
    """Rows f..kF-1 poisoned with NaN and inf after the load: every real
    output is still the identity padding's, bit for bit."""
    h, g, lam, _ = _case(f, seed=100 + f)
    ref_a = model_solve_damped(h, g, lam)
    ref_b = model_inverse_diag(h)
    for pad in (np.nan, np.inf, -np.inf):
        _assert_bits(model_solve_damped(h, g, lam, pad=F32(pad)), ref_a)
        _assert_bits(model_inverse_diag(h, pad=F32(pad)), ref_b)


def test_model_solves_and_inverts():
    """The model is a solver, not only a copy of the twin: x solves the
    damped system and the diagonal is diag(A^-1), both against float64."""
    h, g, lam, bad = _case(20, seed=7)
    x = model_solve_damped(h, g, lam)
    d = model_inverse_diag(h)
    for v in np.nonzero(~bad)[0]:
        a = h[v].astype(np.float64)
        damped = a.copy()
        dg = np.diagonal(a)
        np.fill_diagonal(damped, dg + lam[v] * np.maximum(dg, 1e-12) + 1e-12)
        exact = np.linalg.solve(damped, g[v])
        np.testing.assert_allclose(
            x[v], exact, rtol=0, atol=1e-4 * np.abs(exact).max())
        np.testing.assert_allclose(
            d[v], np.diagonal(np.linalg.inv(a)), rtol=2e-3)


def _source_voxels():
    """The voxels a block of K3's and K4's tile (``kSlabVoxels``), from the
    source."""
    text = (CSRC / "spd.cu").read_text()
    return int(re.search(r"constexpr int kSlabVoxels = (\d+);", text).group(1))


def test_source_takes_no_shared_memory_and_shares_the_warp_factor():
    """What the model assumes of the dense kernels K6a/K6b: their layout
    takes no shared memory and no barrier, and they run the one template
    per function on ``warp_factor`` that K3/K4 run too, K6b with no
    Tikhonov term; K8 shares the warp factor."""
    text = (CSRC / "spd.cu").read_text()
    assert "extern __shared__" not in text
    assert "cudaFuncSetAttribute" not in text
    dense = text.split("struct Dense {", 1)[1].split("\n};\n", 1)[0]
    assert "__shared__" not in dense and "__syncthreads" not in dense
    assert "static constexpr int kVoxels = kWarpVoxels;" in dense
    for name in ("spd_solve_damped_kernel", "spd_inverse_diag_kernel"):
        body = text.split(f"    {name}(", 1)[1].split("\n}\n", 1)[0]
        assert body.index("const Layout layout(h, b, f);") < body.index(
            "if (v >= b) return;")
        assert "warp_factor<kF>(f, layout.at(v)," in body
    launches = {
        "xmt_spd_solve_damped_dense": "launch_solve<kF, Dense>(",
        "xmt_spd_inverse_diag_dense": "launch_inverse_diag<kF, Dense>(h, out, b, f, 0.f,",
    }
    for entry, launch in launches.items():
        body = text.split(f'extern "C" int {entry}(', 1)[1].split("\n}\n", 1)[0]
        assert "if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;" in body
        assert "if (b > 0) {" in body
        assert "XMT_WARP_ROWS(f, " + launch in body, entry
    assert "load_and_factor" not in text and "tri(" not in text
    factor = (CSRC / "spd_factor.cuh").read_text()
    assert "solve_with_factor" not in factor and "tri(" not in factor
    k8 = (CSRC / "lm_v10.cu").read_text()
    assert "warp_factor<kF>(" in k8 and "XMT_WARP_ROWS(" in k8
    assert "__shfl_sync" not in k8.split("warp_factor_solve(", 1)[1].split(
        "warp_back<kF>", 1)[0]


def test_source_stages_only_the_slab_tile():
    """What the model assumes of the slab kernels K3/K4: the slab layout is
    the only shared memory of ``spd.cu``, one static tile sized by kF at
    the odd stride kV + 1, under 48 KB at kF = 32, filled before a barrier
    that every thread reaches before any warp returns; both slab entries
    launch the same template on it at ``kSlabVoxels`` voxels a block."""
    text = (CSRC / "spd.cu").read_text()
    assert text.count("__shared__") == 1
    tile = text.split("struct SlabTile {", 1)[1].split("\n};\n", 1)[0]
    assert "__shared__ float s[kRows * kStride];" in tile
    assert "static constexpr int kStride = kV + 1;" in tile
    assert "static constexpr int kRows = kF * (kF + 1) / 2;" in tile
    assert "__syncthreads();" in tile
    assert "sv[(j * n - j * (j + 1) / 2 + i) * kStride]" in tile
    kv = _source_voxels()
    assert (kv + 1) % 2 == 1 and kv in (8, 16, 32)
    assert 32 * 33 // 2 * (kv + 1) * 4 <= 48 * 1024
    launches = {
        "xmt_spd_solve_damped": "launch_solve<kF, SlabTile<kF, kSlabVoxels>>(",
        "xmt_spd_inverse_diag": (
            "launch_inverse_diag<kF, SlabTile<kF, kSlabVoxels>>("),
    }
    for entry, launch in launches.items():
        body = text.split(f'extern "C" int {entry}(', 1)[1].split("\n}\n", 1)[0]
        assert "if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;" in body
        assert "if (b > 0) {" in body
        assert "XMT_WARP_ROWS(f, " + launch in body, entry


def test_padding_switch_covers_every_row_count():
    text = (CSRC / "spd_factor.cuh").read_text()
    macro = text.split("#define XMT_WARP_ROWS", 1)[1].split("\n\n", 1)[0]
    assert "((n) + 3) / 4" in macro
    cases = dict(
        (int(q), int(kf)) for q, kf in re.findall(
            r"case (\d+): \{ constexpr int kF = (\d+);", macro))
    assert cases == {q: 4 * q for q in range(1, 9)}
    assert {(n + 3) // 4 for n in range(1, 33)} == set(cases)
    for n in range(1, 33):
        assert cases[(n + 3) // 4] == _rows(n) >= n
    # Past 32 rows: the wide switch, n rounded up to a multiple of 16.
    wide = text.split("#define XMT_WARP_ROWS_WIDE", 1)[1].split("\n\n", 1)[0]
    assert "((n) + 15) / 16" in wide
    cases = dict(
        (int(q), int(kf)) for q, kf in re.findall(
            r"case (\d+): \{ constexpr int kF = (\d+);", wide))
    assert cases == {3: 48} and spd.MAX_F == 48
    assert {(n + 15) // 16 for n in range(33, spd.MAX_F + 1)} == set(cases)
    for n in range(33, spd.MAX_F + 1):
        assert cases[(n + 15) // 16] == _wide_rows(n) >= n



# ---------------------------------------------------------------------------
# The wide factor: two rows a lane, 32 < F <= 48
# ---------------------------------------------------------------------------


def _wide_rows(n):
    """XMT_WARP_ROWS_WIDE: n rounded up to a multiple of 16."""
    return 16 * ((n + 15) // 16)


def _wide_factor(load, b, n, diag, pad=None):
    """Registers after ``warp_factor_wide``: lo[v, lane, j] = L(lane, j) and
    hi[v, lane, j] = L(lane + 32, j); each step as the CUDA loop writes it,
    a shuffle from lane s as ``[:, s]``.  ``pad`` overwrites the padding
    rows (lane + 32 >= n) after the load."""
    kf = _wide_rows(n)
    lane = np.arange(LANES)
    r1 = lane + 32
    real0, real1 = lane < n, r1 < n
    full = np.zeros((b, kf, kf), F32)  # full[v, j, r] = A[j][r], j <= r < n
    for j in range(n):
        full[:, j, j:n] = load(j)
    lo = np.zeros((b, LANES, LANES), F32)
    hi = np.zeros((b, LANES, kf), F32)
    for j in range(LANES):
        x = np.where((j <= lane) & real0, full[:, j, lane], F32(0))
        lo[:, :, j] = np.where(lane == j, np.where(real0, diag(x), F32(1)), x)
    for j in range(kf):
        x = np.where((j <= r1) & real1, full[:, j, np.minimum(r1, kf - 1)],
                     F32(0))
        hi[:, :, j] = np.where(r1 == j, np.where(real1, diag(x), F32(1)), x)
    if pad is not None:
        hi[:, ~real1, :] = pad
    for k in range(kf):
        piv = lo[:, k, k] if k < 32 else hi[:, k - 32, k]
        dk = np.where(piv > 0, piv, F32(np.nan))
        inv = F32(1) / np.sqrt(dk)
        if k < 32:
            m = lane >= k
            lo[:, m, k] = lo[:, m, k] * inv[:, None]
        m = r1 >= k
        hi[:, m, k] = hi[:, m, k] * inv[:, None]
        for j in range(k + 1, kf):
            ljk = (lo[:, j, k] if j < 32 else hi[:, j - 32, k])[:, None]
            if j < 32:
                m = lane >= j
                lo[:, m, j] = lo[:, m, j] - lo[:, m, k] * ljk
            m = r1 >= j
            hi[:, m, j] = hi[:, m, j] - hi[:, m, k] * ljk
    return lo, hi


def _wide_forward(lo, hi, b0, b1):
    """``warp_forward_wide``: rows lane and lane + 32 of y."""
    kf = hi.shape[2]
    lane = np.arange(LANES)
    acc0, acc1 = b0.copy(), b1.copy()
    y0, y1 = np.zeros_like(b0), np.zeros_like(b1)
    for j in range(kf):
        if j < 32:
            y0[:, j] = acc0[:, j] / lo[:, j, j]
            yj = y0[:, j, None]
            m = lane > j
            acc0[:, m] = acc0[:, m] - lo[:, m, j] * yj
            acc1 = acc1 - hi[:, :, j] * yj
        else:
            y1[:, j - 32] = acc1[:, j - 32] / hi[:, j - 32, j]
            yj = y1[:, j - 32, None]
            m = lane + 32 > j
            acc1[:, m] = acc1[:, m] - hi[:, m, j] * yj
    return y0, y1


def _wide_back(lo, hi, y0, y1, n):
    """``warp_back_wide``: rows lane and lane + 32 of x."""
    kf = hi.shape[2]
    lane = np.arange(LANES)
    real0, real1 = lane < n, lane + 32 < n
    x0, x1 = np.zeros_like(y0), np.zeros_like(y1)
    for i in reversed(range(kf)):
        p1 = np.where(real1, hi[:, :, i] * x1, F32(0))
        p0 = (np.where(real0, lo[:, :, i] * x0, F32(0)) if i < 32
              else np.zeros_like(x0))
        acc = (y0[:, i] if i < 32 else y1[:, i - 32]).copy()
        for j in range(i + 1, kf):
            acc = acc - (p0[:, j] if j < 32 else p1[:, j - 32])
        if i < 32:
            x0[:, i] = acc / lo[:, i, i]
        else:
            x1[:, i - 32] = acc / hi[:, i - 32, i]
    return x0, x1


def _wide_inverse_diag(lo, hi, n):
    """``warp_inverse_diag_wide``: lane c's sums of columns c and c + 32 of
    X = L^-1, each L(i, j) broadcast from row i's lane and register."""
    b, _, kf = hi.shape
    lane = np.arange(LANES)

    def row(i, j):
        return lo[:, i, j] if i < 32 else hi[:, i - 32, j]

    out = []
    for c, first in ((lane, 0), (lane + 32, 32)):
        x = np.zeros((b, LANES, kf), F32)
        s = np.zeros((b, LANES), F32)
        for i in range(first, kf):
            acc = np.broadcast_to((c == i).astype(F32), (b, LANES)).copy()
            for j in range(first, i):
                acc = np.where(j >= c, acc - row(i, j)[:, None] * x[:, :, j],
                               acc)
            x[:, :, i] = acc / row(i, i)[:, None]
            if i < n:
                s = np.where(i >= c, s + x[:, :, i] * x[:, :, i], s)
        out.append(s)
    return np.concatenate(out, axis=1)


def _wide_voxels(kf):
    """``kWideSlabVoxels`` of the source (the wide tile's voxels at kF)."""
    text = (CSRC / "spd.cu").read_text()
    return int(re.search(r"constexpr int kWideSlabVoxels = (\d+);",
                         text).group(1))


def model_wide_solve_damped(h, g, lam, pad=None, layout="dense"):
    """K3's/K6a's wide schedule: out[v, r] = row r's x."""
    b, n, _ = h.shape
    kf = _wide_rows(n)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        def damp(x):
            return (x + lam[:, None] * np.maximum(x, TINY)) + TINY
        lo, hi = _wide_factor(_loads(h, layout, _wide_voxels(kf), kf), b, n,
                              damp, pad)
        rhs = np.zeros((b, 2 * LANES), F32)
        rhs[:, :n] = g
        y0, y1 = _wide_forward(lo, hi, rhs[:, :LANES], rhs[:, LANES:])
        x0, x1 = _wide_back(lo, hi, y0, y1, n)
        return np.concatenate([x0, x1], axis=1)[:, :n]


def model_wide_inverse_diag(h, tikhonov=0.0, pad=None, layout="dense"):
    """K4's/K6b's wide schedule: out[v, c] = column c's sum."""
    b, n, _ = h.shape
    kf = _wide_rows(n)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        lo, hi = _wide_factor(_loads(h, layout, _wide_voxels(kf), kf), b, n,
                              lambda x: x + F32(tikhonov), pad)
        return _wide_inverse_diag(lo, hi, n)[:, :n]


@pytest.mark.parametrize("kernel", ["K6a", "K6b", "K3", "K4", "K4 ridge"])
@pytest.mark.parametrize("f", [33, 40, 48])
def test_wide_model_equals_plain_bit_for_bit(f, kernel):
    """Past 32 rows (F = 48: the 12-line 7 T brain prior): the wide
    schedule equals the plain versions bit for bit, NaN rows exactly at the
    planted non-SPD voxels; K3/K4 through the wide tile at B = 37."""
    if kernel.startswith("K6"):
        h, g, lam, bad = _case(f, seed=3000 + f)
    else:
        h, g, lam, bad = _case(f, seed=4000 + f, b=SLAB_B)
    th = torch.from_numpy(h)
    tg, tlam = torch.from_numpy(g), torch.from_numpy(lam)
    if kernel == "K6a":
        got = model_wide_solve_damped(h, g, lam)
        ref = spd.spd_solve_damped_dense_plain(th, tg, tlam).numpy()
    elif kernel == "K6b":
        got = model_wide_inverse_diag(h)
        ref = spd.spd_inverse_diag_dense_plain(th).numpy()
    elif kernel == "K3":
        got = model_wide_solve_damped(h, g, lam, layout="slab")
        ref = spd.spd_solve_damped_plain(_slab(h), tg, tlam).numpy()
    else:
        tik = 1e-12 if kernel == "K4 ridge" else 0.0
        got = model_wide_inverse_diag(h, tik, layout="slab")
        ref = spd.spd_inverse_diag_plain(_slab(h), tik).numpy()
    _assert_bits(got, ref)
    assert np.array_equal(np.isnan(got).all(1), bad)
    assert not np.isnan(got[~bad]).any()


@pytest.mark.parametrize("f", [35, 47])
def test_wide_padding_adds_nothing_to_a_real_row(f):
    """The wide factor's padding rows poisoned with NaN and inf after the
    load: every real output is still the identity padding's."""
    h, g, lam, _ = _case(f, seed=5000 + f)
    ref_a = model_wide_solve_damped(h, g, lam)
    ref_b = model_wide_inverse_diag(h)
    for pad in (np.nan, np.inf, -np.inf):
        _assert_bits(model_wide_solve_damped(h, g, lam, pad=F32(pad)), ref_a)
        _assert_bits(model_wide_inverse_diag(h, pad=F32(pad)), ref_b)


def test_wide_model_solves_and_inverts():
    """At F = 48 the wide model is a solver: x solves the damped system and
    the diagonal is diag(A^-1), both against float64."""
    h, g, lam, bad = _case(48, seed=8)
    x = model_wide_solve_damped(h, g, lam)
    d = model_wide_inverse_diag(h)
    for v in np.nonzero(~bad)[0]:
        a = h[v].astype(np.float64)
        damped = a.copy()
        dg = np.diagonal(a)
        np.fill_diagonal(damped, dg + lam[v] * np.maximum(dg, 1e-12) + 1e-12)
        exact = np.linalg.solve(damped, g[v])
        np.testing.assert_allclose(
            x[v], exact, rtol=0, atol=1e-4 * np.abs(exact).max())
        np.testing.assert_allclose(
            d[v], np.diagonal(np.linalg.inv(a)), rtol=2e-3)


def test_wide_source_keeps_the_narrow_build_and_a_small_tile():
    """What the wide model assumes of the source: both kernel templates
    keep the narrow factor for kF <= 32 (``if constexpr``) and take the
    wide one past it; every entry sends F <= 32 to XMT_WARP_ROWS as before
    and the rest to XMT_WARP_ROWS_WIDE, the slab at ``kWideSlabVoxels``;
    the wide tile stays a static array under 48 KB; K8 keeps the narrow
    factor."""
    text = (CSRC / "spd.cu").read_text()
    assert "constexpr int kMaxF = 48;" in text
    assert "constexpr int kWarpRows = 32;" in text
    for name in ("spd_solve_damped_kernel", "spd_inverse_diag_kernel"):
        body = text.split(f"    {name}(", 1)[1].split("\n}\n", 1)[0]
        narrow, wide = body.split("if constexpr (kF <= kWarpRows) {", 1)[1].split(
            "} else {", 1)
        assert "warp_factor<kF>(f, layout.at(v)," in narrow
        assert "warp_factor_wide<kF>(" in wide
    for entry in ("xmt_spd_solve_damped", "xmt_spd_inverse_diag",
                  "xmt_spd_solve_damped_dense", "xmt_spd_inverse_diag_dense"):
        body = text.split(f'extern "C" int {entry}(', 1)[1].split("\n}\n", 1)[0]
        narrow, wide = body.split("if (f <= kWarpRows) {", 1)[1].split(
            "} else {", 1)
        assert "XMT_WARP_ROWS(f, " in narrow and "XMT_WARP_ROWS_WIDE(" in wide
        if "dense" not in entry:
            assert "SlabTile<kF, kSlabVoxels>" in narrow
            assert "SlabTile<kF, kWideSlabVoxels>" in wide
    kv = _wide_voxels(48)
    assert 48 * 49 // 2 * (kv + 1) * 4 <= 48 * 1024 and (kv + 1) % 2 == 1
    k8 = (CSRC / "lm_v10.cu").read_text()
    assert "_wide" not in k8
