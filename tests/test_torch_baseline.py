"""The port's AsLS baseline (``xmris_tpu_torch.ops.baseline``) against the
scipy sparse oracle, the JAX package and itself, mirroring
``tests/test_baseline.py``.

Everything is float64.  The system's condition number is ~lam * 16 /
min(w) ~ 1e9 at the reference's default (lam 1e5, p 0.001), so two
float64 builds of the same solve agree only to its rounding floor: the
reference's own answer sits 7.3e-9 max|z| from spsolve there.  Hence the
reference test's bars: either solver's single linear solve against the
reference's at 1e-9, the iterated scan against spsolve and against the
reference's scan at 1e-8, the CR iteration against the scan (the port's
and the reference's) at 1e-7, a float32 input at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.core.array import XmrArray as RefArray
from xmris_tpu.ops import baseline as jb

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.ops import baseline as tb

from test_baseline import als_oracle, make_spectrum

PARAMS = [(1e5, 0.001), (1e4, 0.01), (1e6, 0.05)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("lam,p", PARAMS)
def test_scan_matches_spsolve_oracle_and_reference(lam, p):
    y = make_spectrum()
    ours = tb.als_baseline_batched(y[None], lam, p, 10, device="cpu")
    assert ours.dtype == torch.float64
    assert _rel(ours.numpy()[0], als_oracle(y, lam, p, 10)) < 1e-8
    ref = np.asarray(jb.als_baseline_batched(y[None], lam, p, 10,
                                             solver="scan"))
    assert _rel(ours.numpy(), ref) < 1e-8


@pytest.mark.parametrize("lam,p", PARAMS)
def test_cr_matches_reference_and_scan(lam, p):
    ys = np.stack([make_spectrum(seed=s) for s in range(4)])
    cr = tb.als_baseline_batched(ys, lam, p, 10, solver="cr", device="cpu")
    scan = tb.als_baseline_batched(ys, lam, p, 10, solver="scan",
                                   device="cpu")
    ref = np.asarray(jb.als_baseline_batched(ys, lam, p, 10, solver="cr"))
    ref_scan = np.asarray(jb.als_baseline_batched(ys, lam, p, 10,
                                                  solver="scan"))
    assert _rel(cr.numpy(), scan.numpy()) < 1e-7
    assert _rel(cr.numpy(), ref) < 1e-7
    assert _rel(cr.numpy(), ref_scan) < 1e-7


@pytest.mark.parametrize("n", [256, 300, 511, 512])
def test_direct_solves_match_reference(n):
    """One pentadiagonal solve (no reweighting) by both solvers against the
    reference's at 1e-9, CR against the scan at 1e-9, and the residual."""
    rng = np.random.default_rng(n)
    lam = 1e5
    w = rng.uniform(0.001, 1.0, (4, n))
    m0, m1, m2 = (x.numpy() for x in tb._dtd_bands(n, torch.float64))
    a0, b = w + lam * m0, rng.normal(size=(4, n))
    args = [torch.tensor(x) for x in (a0, lam * m1, lam * m2, b)]
    x_cr = tb.penta_solve_cr(*args).numpy()
    x_scan = tb._penta_ldlt_solve(*args).numpy()
    bands = [jnp.asarray(x) for x in (lam * m1, lam * m2)]
    ref_cr = np.asarray(jb.penta_solve_cr(
        jnp.asarray(a0), jnp.broadcast_to(bands[0], (4, n - 1)),
        jnp.broadcast_to(bands[1], (4, n - 2)), jnp.asarray(b)))
    ref_scan = np.stack([np.asarray(jb._penta_ldlt_solve(
        jnp.asarray(a0[i]), *bands, jnp.asarray(b[i]))) for i in range(4)])
    assert _rel(x_cr, ref_cr) < 1e-9
    assert _rel(x_scan, ref_scan) < 1e-9
    assert _rel(x_cr, x_scan) < 1e-9
    r = tb._penta_matvec(args[0], args[1].expand(4, n - 1),
                         args[2].expand(4, n - 2), torch.tensor(x_cr)).numpy()
    assert np.max(np.abs(r - b)) / np.max(np.abs(b)) < 1e-8
    for band, ref_band in zip(tb._dtd_bands(n, torch.float64),
                              jb._dtd_bands(n, jnp.float64)):
        np.testing.assert_array_equal(band.numpy(), np.asarray(ref_band))


def test_batched_consistency_and_refine():
    ys = np.stack([make_spectrum(seed=s) for s in range(6)])
    for solver in ("scan", "cr"):
        batch = tb.als_baseline_batched(ys, 1e5, 0.001, 10, solver=solver,
                                        device="cpu").numpy()
        for i in (0, 5):
            single = tb.als_baseline_batched(ys[i:i + 1], 1e5, 0.001, 10,
                                             solver=solver,
                                             device="cpu").numpy()[0]
            np.testing.assert_allclose(batch[i], single, rtol=1e-12)
    refined = tb.als_baseline_batched(ys, 1e5, 0.001, 10, solver="cr",
                                      refine=2, device="cpu").numpy()
    assert _rel(refined, batch) < 1e-7
    zero = tb.als_baseline_batched(ys, 1e5, 0.001, 0, device="cpu")
    assert not zero.any()


def test_float32_input_computes_in_float64():
    """A float32 input comes back float32, NaN-free, agreeing with the
    float64 answer to input resolution (``test_baseline.py``'s bar)."""
    lam, p = 1e5, 0.001
    ys = np.stack([make_spectrum(seed=s) for s in range(4)])
    z64 = tb.als_baseline_batched(ys, lam, p, 10, solver="scan",
                                  device="cpu").numpy()
    z32 = tb.als_baseline_batched(torch.tensor(ys, dtype=torch.float32), lam,
                                  p, 10, solver="cr")
    assert z32.dtype == torch.float32 and not torch.isnan(z32).any()
    assert _rel(z32.numpy().astype(np.float64), z64) < 1e-4


def test_bad_solver_raises_the_reference_value_error():
    ys = make_spectrum()[None]
    with pytest.raises(ValueError, match="solver") as ref_err:
        jb.als_baseline_batched(ys, 1e5, 0.001, 2, solver="qr")
    with pytest.raises(ValueError) as port_err:
        tb.als_baseline_batched(ys, 1e5, 0.001, 2, solver="qr", device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def _labeled(y, dims=("frequency",), attrs=None):
    coords = {"frequency": np.arange(y.shape[-1], dtype=float)}
    return (RefArray(y, dims=dims, coords=coords, attrs=attrs),
            XmrArray(y, dims=dims, coords=coords, attrs=attrs))


def test_labeled_removes_the_baseline_as_the_reference():
    y = make_spectrum()
    ref_da, da = _labeled(y, attrs={"scan": 1})
    out = tb.baseline_als(da, lam=1e5, p=0.001, device="cpu")
    ref = ref_da.xmr.baseline_als(lam=1e5, p=0.001)
    off = np.abs(out.values[:100])
    assert off.mean() < 0.2 and off.mean() < 0.2 * np.abs(y[:100]).mean()
    assert _rel(out.values - y, ref.values - y) < 1e-8
    assert out.attrs == ref.attrs
    assert out.attrs["baseline_method"] == "als" and out.attrs["scan"] == 1


def test_complex_input_uses_real_part():
    y = make_spectrum()
    ref_da, da = _labeled(y + 1j * 99.0)
    out = tb.baseline_als(da, device="cpu")
    assert not np.iscomplexobj(out.values)
    np.testing.assert_array_equal(
        out.values, tb.baseline_als(_labeled(y)[1], device="cpu").values)
    assert _rel(out.values - y, ref_da.xmr.baseline_als().values - y) < 1e-8
    tensor_out = tb.baseline_als(da.copy(data=torch.from_numpy(da.values)),
                                 device="cpu")
    assert isinstance(tensor_out.data, torch.Tensor)
    assert not tensor_out.data.is_complex()
    np.testing.assert_array_equal(tensor_out.values, out.values)


def test_nd_vectorization():
    ys = np.stack([make_spectrum(seed=s) for s in range(4)]).reshape(2, 2, -1)
    _, da = _labeled(ys, dims=("x", "y", "frequency"))
    out = tb.baseline_als(da, device="cpu")
    assert out.dims == ("x", "y", "frequency")
    flat = tb.baseline_als(da.isel({"x": 0, "y": 1}), device="cpu")
    np.testing.assert_allclose(out.values[0, 1], flat.values, rtol=1e-10)
    moved = tb.baseline_als(da.transpose("frequency", "y", "x"), device="cpu")
    np.testing.assert_allclose(moved.values.transpose(2, 1, 0), out.values,
                               rtol=1e-10)


def test_default_device_is_the_card():
    """Without ``device``, an array runs on the card (and raises where
    there is none); a tensor runs on its own device."""
    ys = make_spectrum()[None]
    z = tb.als_baseline_batched(torch.tensor(ys), 1e4, 0.01, 2)
    assert z.device.type == "cpu"
    if torch.cuda.is_available():
        z = tb.als_baseline_batched(ys, 1e4, 0.01, 2)
        assert z.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.als_baseline_batched(ys, 1e4, 0.01, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.baseline_als(_labeled(ys[0])[1])
