"""The warp design of K6a and K6b (``csrc/spd.cu`` on ``spd_factor.cuh``),
checked where there is no card.

The CUDA kernels run only on the card (``test_torch_cuda.py`` holds them
against their plain twins and against K3/K4 there, and
``scripts/compare_kernel_builds.py`` against another build bit for bit).
Here a NumPy float32 model of their warp schedule, every operation
rounded on its own, runs the same sequence of operations:

* the warp factor: lane i holds row i of L, rows padded with the identity
  to a multiple of 4 (``XMT_WARP_ROWS``), the damped diagonal for K6a;
* the forward substitution by columns and the back substitution in K3's
  serial order, padding lanes forming +0;
* K6b's inverse diagonal by columns: lane c forms column c of L^-1 from
  the rows of L broadcast from their lanes, and sums its squares in
  ascending i;

and must equal ``spd_solve_damped_dense_plain`` and
``spd_inverse_diag_dense_plain`` bit for bit, NaN rows exactly at the
non-SPD voxels, for F = 1..32.  Poisoned padding rows leave every real
output as it is: the padding adds nothing to a real row or column.  A
source check pins what the model assumes of the kernels' source: no shared
memory, the shared warp factor, and the padding switch.
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


def _warp_factor(h, lam, pad=None):
    """Registers after ``warp_factor``: a[v, lane, j] = L(lane, j), j <= lane.

    ``lam`` is None for K6b (no damping).  ``pad``, if given, overwrites
    the padding lanes' rows after the load (a poisoned padding)."""
    b, n, _ = h.shape
    kf = _rows(n)
    lane = np.arange(LANES)
    real = lane < n
    a = np.zeros((b, LANES, kf), F32)
    for j in range(kf):
        col = np.zeros((b, LANES), F32)  # load(j, lane) = A[j][lane]
        if j < n:
            col[:, :n] = h[:, j, :]
        x = np.where((j <= lane) & real, col, F32(0))
        if lam is not None:
            damped = (x + lam[:, None] * np.maximum(x, TINY)) + TINY
        else:
            damped = x
        a[:, :, j] = np.where(lane == j, np.where(real, damped, F32(1)), x)
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


def model_solve_damped(h, g, lam, pad=None):
    """K6a's schedule: out[v, i] = lane i's x_i."""
    n = h.shape[1]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        a = _warp_factor(h, lam, pad)
        rhs = np.zeros((h.shape[0], LANES), F32)
        rhs[:, :n] = g
        return _warp_back(a, _warp_forward(a, rhs), n)[:, :n]


def model_inverse_diag(h, pad=None):
    """K6b's schedule: out[v, c] = lane c's column sum."""
    n = h.shape[1]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return _warp_inverse_diag(_warp_factor(h, None, pad), n)[:, :n]


def _case(f, seed):
    """SPD matrices (one with rows six orders of magnitude apart, as a
    Gauss-Newton H), and two planted non-SPD voxels: a negative first
    pivot (voxel 1) and a negative last pivot (voxel 4)."""
    rng = np.random.default_rng(seed)
    b = 6
    m = rng.normal(size=(b, f, f))
    h = m @ m.transpose(0, 2, 1) + 0.1 * f * np.eye(f)
    d = np.logspace(-3, 3, f)
    h[5] = d[:, None] * h[5] * d[None, :]
    h = h.astype(F32)
    h[1, 0, 0] = -1.0
    h[4, f - 1, f - 1] = -4.0 * abs(h[4, f - 1, f - 1]) - 1.0
    bad = np.zeros(b, bool)
    bad[[1, 4]] = True
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


@pytest.mark.parametrize("kernel", ["K6a", "K6b"])
@pytest.mark.parametrize("f", range(1, 33))
def test_model_equals_plain_bit_for_bit(f, kernel):
    h, g, lam, bad = _case(f, seed=f)
    th = torch.from_numpy(h)
    if kernel == "K6a":
        got = model_solve_damped(h, g, lam)
        ref = spd.spd_solve_damped_dense_plain(
            th, torch.from_numpy(g), torch.from_numpy(lam)).numpy()
    else:
        got = model_inverse_diag(h)
        ref = spd.spd_inverse_diag_dense_plain(th).numpy()
    _assert_bits(got, ref)
    assert np.array_equal(np.isnan(got).all(1), bad)
    assert not np.isnan(got[~bad]).any()


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


def test_source_takes_no_shared_memory_and_shares_the_warp_factor():
    text = (CSRC / "spd.cu").read_text()
    assert "extern __shared__" not in text
    assert "__shared__" not in text
    assert "cudaFuncSetAttribute" not in text
    for name in ("spd_solve_damped_dense_kernel",
                 "spd_inverse_diag_dense_kernel"):
        launch = re.search(rf"{name}<kF>\s*<<<([^>]*)>>>", text)
        assert launch, name
        args = [x.strip() for x in launch.group(1).split(",")]
        assert args[1] == "32 * kWarpVoxels" and args[2] == "0", args
        body = text.split(f"    {name}(", 1)[1].split("\n}\n", 1)[0]
        assert "if (v >= b) return;" in body
        assert "warp_factor<kF>(" in body
    k8 = (CSRC / "lm_v10.cu").read_text()
    assert "warp_factor<kF>(" in k8 and "XMT_WARP_ROWS(" in k8
    assert "__shfl_sync" not in k8.split("warp_factor_solve(", 1)[1].split(
        "warp_back<kF>", 1)[0]


def test_padding_switch_covers_every_row_count():
    text = (CSRC / "spd_factor.cuh").read_text()
    macro = text.split("#define XMT_WARP_ROWS", 1)[1].split("\n\n", 1)[0]
    assert "((n) + 3) / 4" in macro
    cases = dict(
        (int(q), int(kf)) for q, kf in re.findall(
            r"case (\d+): \{ constexpr int kF = (\d+);", macro))
    assert cases == {q: 4 * q for q in range(1, 9)}
    assert {(n + 3) // 4 for n in range(1, spd.MAX_F + 1)} == set(cases)
    for n in range(1, spd.MAX_F + 1):
        assert cases[(n + 3) // 4] == _rows(n) >= n
