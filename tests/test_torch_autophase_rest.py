"""The rest of autophase in the port against the JAX package: the ROI
objectives, the NumPy objective and the scipy search, the Newton and BFGS
polishes, and ``differential_evolution_jit``.

Cases are the reference's own (``tests/test_phasing.py``): the dominant-peak
spectra of ``build_spectrum`` at three (p0, p1) errors, p0 only, the bad
polish, ``peak_minima``/``positivity``, ``target_coord`` and lb smoothing.
Both packages get the same complex128 numpy spectra.  Tolerances: scores
rtol 1e-6; the NumPy objective equal; scipy's (p0, p1) within 1e-6 deg at
lb = 0 (the same objective and seed: the same trajectory) and within 0.5
deg, ACME within 1e-3, at lb > 0 (the smoothed spectra come from two FFT
libraries); Hessians rtol 1e-4 against ``jax.jacfwd(jax.grad)``; polished
phases within 0.5 deg of the reference's p0 and the score within 1e-3
relative (as ``test_torch_slice.py`` holds the grid search).  The searches
use the grid optimizer or scipy, never the reference's in-graph DE.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xmris_tpu as xmt
from xmris_tpu.ops import optim as joptim
from xmris_tpu.ops import phasing as jph

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.ops import optim as toptim
from xmris_tpu_torch.ops import phasing as tph

from test_phasing import build_spectrum, real_corr

CASES_P0P1 = [(40.0, 300.0, 1), (-70.0, -800.0, 2), (160.0, 0.0, 3)]


def _port(da):
    """The port's XmrArray of a reference array (same numpy payload)."""
    return XmrArray(np.asarray(da.values), dims=da.dims,
                    coords={k: Coord(c.dim, np.asarray(c.values))
                            for k, c in da.coords.items()},
                    attrs=dict(da.attrs))


def _stacked(builds):
    """Reference and port (voxel, frequency) arrays of several spectra."""
    f = builds[0][1].coords["frequency"].values
    data = np.stack([s.values for _, s in builds])
    ref = xmt.XmrArray(data, dims=("voxel", "frequency"),
                       coords={"frequency": f})
    return ref, _port(ref)


def _acme(spec, p0, p1, pivot):
    """Float64 ACME score of each row of ``spec`` (V, n) at its phases."""
    f = np.asarray(spec.coords["frequency"].values, np.float64)
    rows = np.asarray(spec.values).reshape(-1, len(f))
    d = tph._phased_real_planar(
        torch.tensor(rows.real), torch.tensor(rows.imag), torch.tensor(f),
        torch.tensor(np.atleast_1d(p0), dtype=torch.float64),
        torch.tensor(np.atleast_1d(p1), dtype=torch.float64),
        torch.tensor(np.atleast_1d(pivot), dtype=torch.float64)[:, None],
        float(f.max() - f.min()))
    return tph.acme_score_raw(d).numpy()


def _wrap(d):
    return (np.asarray(d) + 180.0) % 360.0 - 180.0


def _close_to_reference(out, ref, spec):
    """p0 within 0.5 deg of the reference's and the ACME score within 1e-3
    relative, voxel by voxel, on the spectra searched."""
    a = {k: np.atleast_1d(out.attrs[f"phase_{k}"]) for k in ("p0", "p1", "pivot")}
    b = {k: np.atleast_1d(ref.attrs[f"phase_{k}"]) for k in ("p0", "p1", "pivot")}
    np.testing.assert_array_equal(a["pivot"], b["pivot"])
    assert np.all(np.abs(_wrap(a["p0"] - b["p0"])) <= 0.5), (a, b)
    s = _acme(spec, a["p0"], a["p1"], a["pivot"])
    s_ref = _acme(spec, b["p0"], b["p1"], b["pivot"])
    np.testing.assert_allclose(s, s_ref, rtol=1e-3)


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["peak_minima_score_raw",
                                  "roi_positivity_score_raw"])
def test_roi_scores_match_reference(name):
    """Masked scores on seeded rows, targets at the edges and inside, one
    target per row and per (row, candidate); and against slicing."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(6, 3, 256))
    ti = np.array([100, 0, 255, 3, 128, 29])
    iw = 30
    want = np.array([[float(getattr(jph, name)(jnp.asarray(d[v, c]),
                                                int(ti[v]), iw))
                      for c in range(3)] for v in range(6)])
    got = getattr(tph, name)(torch.tensor(d), torch.tensor(ti)[:, None], iw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    row, t = d[0, 0], 100
    start, end = t - iw, t + iw
    if name == "peak_minima_score_raw":
        sliced = abs(np.min(row[start:t]) - np.min(row[t:end]))
    else:
        roi = row[start:end]
        sliced = np.sum(np.abs(roi[roi < 0])) * 5.0 - np.sum(roi[roi > 0])
    assert float(getattr(tph, name)(torch.tensor(row), t, iw)) == pytest.approx(
        sliced, rel=1e-12)


@pytest.mark.parametrize("method", ["acme", "peak_minima", "positivity"])
def test_np_objective_equals_reference(method):
    _, spec = build_spectrum(p0_true=40.0, p1_true=200.0)
    data = spec.values
    x = spec.coords["frequency"].values
    pivot = x[int(np.argmax(np.abs(data)))]
    args = (method, data, x, pivot, x.max() - x.min(), 500, 40)
    ref, port = jph._np_objective(*args), tph._np_objective(*args)
    for ph in ([10.0, 50.0], [-90.0, 1000.0], [0.0, 0.0], [33.0]):
        assert port(ph) == ref(ph)
    with pytest.raises(ValueError, match="Unknown method"):
        tph._np_objective("entropy", *args[1:])([0.0])


@pytest.mark.parametrize("method", ["acme", "peak_minima", "positivity"])
@pytest.mark.parametrize("p0_only", [False, True])
def test_hessian_matches_jax(method, p0_only):
    """The Newton/BFGS Hessian, ``vmap(jacfwd(grad))`` of the unit-space
    objective, against ``jax.vmap(jax.jacfwd(jax.grad))``, float64."""
    rng = np.random.default_rng(1)
    n, iw, xr = 128, 12, 2000.0
    f = np.linspace(-1000.0, 1000.0, n)
    rr, ri = rng.normal(size=(3, n)), rng.normal(size=(3, n))
    rr[:, 40] += 30.0
    ti = np.argmax(rr ** 2 + ri ** 2, axis=1)
    piv = f[ti]
    n_par = 1 if p0_only else 2
    u = rng.normal(size=(3, n_par)) * 0.05
    span = torch.tensor([360.0, 8000.0], dtype=torch.float64)[:n_par]
    one = tph._unit_objective(method, p0_only, torch.tensor(f), xr, iw, span)
    h = tph.unit_hessians(one, torch.tensor(u), torch.tensor(rr),
                          torch.tensor(ri), torch.tensor(piv),
                          torch.tensor(ti)).numpy()
    score, sp = jph._SCORES[method], jnp.asarray([360.0, 8000.0])[:n_par]

    def jobj(uu, a, b, pv, t):
        p1 = 0.0 if p0_only else uu[1] * sp[1]
        return score(jph._phased_real_planar(a, b, jnp.asarray(f),
                                             uu[0] * sp[0], p1, pv, xr),
                     t, iw)

    want = np.asarray(jax.vmap(jax.jacfwd(jax.grad(jobj)))(
        jnp.asarray(u), jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(piv),
        jnp.asarray(ti)))
    assert h.shape == (3, n_par, n_par)
    np.testing.assert_allclose(h, want, rtol=1e-4,
                               atol=1e-10 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# The scipy search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,p0_only", [("acme", False),
                                            ("positivity", True)])
def test_scipy_single_mode_matches_reference(method, p0_only):
    """Same NumPy objective, same seed: the same scipy trajectory."""
    _, spec = build_spectrum(p0_true=30.0, p1_true=-400.0)
    kw = dict(optimizer="scipy", method=method, p0_only=p0_only,
              peak_width=200.0)
    ref = xmt.autophase(spec, **kw)
    out = tph.autophase(_port(spec), device="cpu", **kw)
    for k in ("phase_p0", "phase_p1", "phase_pivot"):
        assert abs(out.attrs[k] - ref.attrs[k]) <= 1e-6, k
    np.testing.assert_allclose(out.values, ref.values, rtol=1e-9, atol=1e-12)


def test_scipy_with_lb_smoothing_matches_reference():
    pristine, spec = build_spectrum(p0_true=-30.0)
    ref = xmt.autophase(spec, optimizer="scipy", lb=2.0, p0_only=True)
    out = tph.autophase(_port(spec), optimizer="scipy", lb=2.0, p0_only=True,
                        device="cpu")
    assert real_corr(out.values, pristine.values) > 0.97
    _close_to_reference(out, ref, spec)


# ---------------------------------------------------------------------------
# Newton and BFGS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polish", ["newton", "bfgs"])
def test_second_order_polish_matches_reference(polish):
    """Per-voxel grid search on the three (p0, p1) spectra: each voxel
    recovered, p0 wrapped and p1 boxed, and at the reference's phases."""
    builds = [build_spectrum(p0_true=p, p1_true=q, seed=s)
              for p, q, s in CASES_P0P1]
    ref_da, port_da = _stacked(builds)
    kw = dict(mode="all", optimizer="grid", polish_optimizer=polish)
    ref = xmt.autophase(ref_da, **kw)
    out = tph.autophase(port_da, device="cpu", **kw)
    for v, (pristine, _) in enumerate(builds):
        assert real_corr(out.values[v], pristine.values) > 0.98
    assert np.all(np.abs(out.attrs["phase_p0"]) <= 180.0)
    assert np.all(np.abs(out.attrs["phase_p1"]) <= 4000.0)
    _close_to_reference(out, ref, ref_da)


def test_second_order_polish_p0_only_matches_reference():
    builds = [build_spectrum(p0_true=p, seed=s) for p, s in [(40.0, 1),
                                                              (-70.0, 2)]]
    ref_da, port_da = _stacked(builds)
    for polish in ("newton", "bfgs"):
        kw = dict(mode="all", p0_only=True, optimizer="grid",
                  polish_optimizer=polish)
        ref = xmt.autophase(ref_da, **kw)
        out = tph.autophase(port_da, device="cpu", **kw)
        for v, (pristine, _) in enumerate(builds):
            assert real_corr(out.values[v], pristine.values) > 0.98
        assert np.all(out.attrs["phase_p1"] == 0.0)
        _close_to_reference(out, ref, ref_da)


def test_bad_polish_raises_the_reference_value_error():
    ref_da, port_da = _stacked([build_spectrum(p0_true=40.0, seed=1)])
    for kw in (dict(polish_optimizer="adam"),
               dict(polish_optimizer="fused", method="peak_minima")):
        with pytest.raises(ValueError, match="polish_optimizer") as ref_err:
            xmt.autophase(ref_da, mode="all", optimizer="grid", **kw)
        with pytest.raises(ValueError) as port_err:
            tph.autophase(port_da, mode="all", optimizer="grid",
                          device="cpu", **kw)
        assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# ROI methods, target_coord, lb
# ---------------------------------------------------------------------------


def test_mode_all_roi_method_matches_reference():
    """peak_minima scans at full resolution (``test_mode_all_grid_roi_
    method``): the same winners and polish as the reference."""
    builds = [build_spectrum(p0_true=p, seed=s) for p, s in [(-45.0, 1),
                                                              (90.0, 2)]]
    ref_da, port_da = _stacked(builds)
    kw = dict(mode="all", method="peak_minima", peak_width=200.0,
              p0_only=True, optimizer="grid")
    ref = xmt.autophase(ref_da, **kw)
    out = tph.autophase(port_da, device="cpu", **kw)
    for v, (pristine, _) in enumerate(builds):
        assert real_corr(out.values[v], pristine.values) > 0.95
    np.testing.assert_allclose(_wrap(out.attrs["phase_p0"]
                                     - ref.attrs["phase_p0"]), 0.0, atol=0.5)


@pytest.mark.parametrize("optimizer", ["grid", "de"])
def test_single_mode_positivity(optimizer):
    """``test_positivity_method`` in both device searches; the grid search
    against the reference's."""
    pristine, spec = build_spectrum(p0_true=-45.0)
    kw = dict(method="positivity", peak_width=200.0, p0_only=True,
              optimizer=optimizer)
    out = tph.autophase(_port(spec), device="cpu", **kw)
    assert real_corr(out.values, pristine.values) > 0.95
    if optimizer == "grid":
        ref = xmt.autophase(spec, **kw)
        assert abs(_wrap(out.attrs["phase_p0"] - ref.attrs["phase_p0"])) <= 0.5


def test_target_coord_and_lb_match_reference():
    """``test_target_coord_pivot`` and ``test_lb_smoothing_path`` on the
    grid search."""
    pristine, spec = build_spectrum(p0_true=20.0)
    kw = dict(target_coord=-200.0, p0_only=True, optimizer="grid")
    ref = xmt.autophase(spec, **kw)
    out = tph.autophase(_port(spec), device="cpu", **kw)
    assert out.attrs["phase_pivot"] == pytest.approx(-200.0)
    _close_to_reference(out, ref, spec)
    pristine, spec = build_spectrum(p0_true=-30.0)
    kw = dict(lb=2.0, p0_only=True, optimizer="grid")
    ref = xmt.autophase(spec, **kw)
    out = tph.autophase(_port(spec), device="cpu", **kw)
    assert real_corr(out.values, pristine.values) > 0.97
    assert abs(_wrap(out.attrs["phase_p0"] - ref.attrs["phase_p0"])) <= 0.5


# ---------------------------------------------------------------------------
# differential_evolution_jit
# ---------------------------------------------------------------------------


def test_differential_evolution_jit_is_differential_evolution():
    """Same defaults as the reference's wrapper, and the same search as
    ``differential_evolution``."""
    import inspect

    want = {k: v.default for k, v in inspect.signature(
        joptim.differential_evolution_jit).parameters.items()
        if v.default is not inspect.Parameter.empty}
    got = {k: v.default for k, v in inspect.signature(
        toptim.differential_evolution_jit).parameters.items()
        if k in want}
    assert got == want

    def sphere(x):
        return ((x - 0.3) ** 2).sum(-1)

    bounds = torch.tensor([(-2.0, 2.0), (-2.0, 2.0)], dtype=torch.float64)
    a = toptim.differential_evolution_jit(sphere, bounds, seed=3,
                                          polish_iters=10)
    b = toptim.differential_evolution(sphere, bounds, seed=3, polish_iters=10)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_allclose(a.x.numpy(), 0.3, atol=1e-3)
