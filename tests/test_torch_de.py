"""Differential evolution in the port: ``ops/optim.py`` on the cases of
``tests/test_optim.py`` at that file's tolerances, and DE autophase in both
modes, ``process_grid_planar_raw`` at ``PipelineConfig`` defaults and the
per-voxel DE pipeline against the JAX package.

The reference draws from ``jax.random`` and the port from a
``torch.Generator``, so the two searches take other paths: they are held by
the ACME objective they reach, and on simulated spectra by the reference's
own recovery tests (``tests/test_phasing.py``: real correlation with the
pristine spectrum > 0.98).  Single mode and per-voxel p0: the reference's
pivot, p0 within 1 deg, a score no worse than the reference's by more than
1e-3 relative.  Per-voxel p0 + p1 over several seeds: a search that ends in
the best basin (within 1e-3 of the best score either package found for the
row) scores no worse than the reference's same-seed run by more than 1e-3;
its p0 is not held to 1 deg there, because the valley is flat along
p0 - p1 and the reference's DE alone stops 2-3 deg apart between seeds at
equal score (seeds 42, 1, 2, 3, 4 on the bench phantom's pivot row: p0
from -0.14 to -2.79 deg).  DE converges early into another minimum on a
few rows in either package (over seeds 0-7 of the per-voxel pipeline
phantom: the port 9 of 192 searches, the reference 7): the port may be
trapped at most two Poisson standard deviations more often than the
reference, ``trapped <= ref + 2 sqrt(ref + 1)``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xmris_tpu as xmt
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.ops import phasing as jph
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.planar_pipeline import (
    _solve_phase_on_row as ref_solve_phase,
    spectral_pipeline_planar_raw as ref_spectral,
)
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.ops import phasing as tph
from xmris_tpu_torch.ops.kernels import PATHS, counters, reset_counters
from xmris_tpu_torch.ops.optim import (
    DEResult,
    differential_evolution,
    differential_evolution_batched,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

from _torch_parity import BENCH_PK_CSV, MHZ, bench_phantom, load_priors
from _torch_parity import spectral_constants
from test_phasing import build_spectrum, real_corr
from test_torch_autophase import _phantom

ZF, WEIGHT, FREQS = spectral_constants()


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _wrap(d):
    return (np.asarray(d) + 180.0) % 360.0 - 180.0


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------


def sphere(x):
    return ((x - 0.3) ** 2).sum(-1)


def rosenbrock(x):
    return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
            + (1 - x[..., :-1]) ** 2).sum(-1)


def test_sphere_2d():
    res = differential_evolution(sphere, [(-2.0, 2.0), (-2.0, 2.0)], seed=0,
                                 device="cpu")
    assert isinstance(res, DEResult)
    np.testing.assert_allclose(res.x.numpy(), 0.3, atol=1e-3)
    assert bool(res.converged)


def test_rosenbrock_with_polish():
    res = differential_evolution(rosenbrock, [(-2.0, 2.0)] * 2, seed=1,
                                 maxiter=400, tol=1e-8, polish_iters=100,
                                 device="cpu")
    assert float(res.fun) < 1e-3


def test_bounds_respected():
    res = differential_evolution(lambda x: -x.sum(-1),
                                 [(0.0, 1.0), (2.0, 5.0)], seed=2, device="cpu")
    x = res.x.numpy()
    assert x[0] <= 1.0 + 1e-6 and x[1] <= 5.0 + 1e-6
    np.testing.assert_allclose(x, [1.0, 5.0], atol=1e-2)


def test_seed_determinism():
    r1 = differential_evolution(sphere, [(-1.0, 1.0)], seed=7, device="cpu")
    r2 = differential_evolution(sphere, [(-1.0, 1.0)], seed=7, device="cpu")
    assert float(r1.fun) == float(r2.fun)
    np.testing.assert_array_equal(r1.x.numpy(), r2.x.numpy())
    assert int(r1.nit) == int(r2.nit)


def test_generator_seed():
    """A ``torch.Generator`` takes the place of the reference's PRNG key."""
    res = differential_evolution(sphere, [(-1.0, 1.0)],
                                 seed=torch.Generator().manual_seed(3),
                                 device="cpu")
    assert abs(float(res.x[0]) - 0.3) < 1e-2


def test_batched():
    """One independent search per row (the reference's vmapped searches)."""
    targets = torch.tensor([0.1, -0.5, 1.2])
    res = differential_evolution_batched(
        lambda x, rows: (x[..., 0] - targets[rows][:, None]) ** 2,
        [(-2.0, 2.0)], 3, seed=0, device="cpu")
    assert res.x.shape == (3, 1) and res.fun.shape == (3,)
    np.testing.assert_allclose(res.x.numpy()[:, 0], targets.numpy(), atol=5e-3)
    assert bool(res.converged.all())


def test_inf_candidates_are_rejected():
    """+inf regions (the guarded ACME branch) never win selection."""
    def guarded(x):
        val = (x ** 2).sum(-1)
        return torch.where(x[..., 0] < -0.5, torch.full_like(val, math.inf), val)

    res = differential_evolution(guarded, [(-2.0, 2.0)], seed=4, polish_iters=0,
                                 device="cpu")
    assert math.isfinite(float(res.fun))
    assert float(res.x[0]) >= -0.5


def test_search_follows_tensor_bounds_else_runs_on_the_card():
    """Bounds given as a tensor keep the search on their device; other
    bounds put it on the card, which here, without one, raises."""
    res = differential_evolution(sphere, torch.tensor([[-1.0, 1.0]]), seed=7)
    assert res.x.device.type == "cpu"
    assert float(res.fun) == float(differential_evolution(
        sphere, [(-1.0, 1.0)], seed=7, device="cpu").fun)
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds the "
                    "default search there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        differential_evolution(sphere, [(-1.0, 1.0)], seed=7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        differential_evolution_batched(
            lambda x, rows: sphere(x), np.array([[-1.0, 1.0]]), 2, seed=7)


# ---------------------------------------------------------------------------
# autophase(optimizer="de") against the reference
# ---------------------------------------------------------------------------

SHAPE = (4, 4, 2)
SEEDS = (42, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def phantom_grid():
    f, rr, ri = _phantom(n_voxels=int(np.prod(SHAPE)), nf=1024, seed=5)
    spec = (rr + 1j * ri).reshape(SHAPE + (1024,))
    dims = ("x", "y", "z", "frequency")
    ref = xmt.XmrArray(spec, dims=dims,
                       coords={"frequency": JCoord("frequency", f)})
    port = XmrArray(spec, dims=dims, coords={"frequency": Coord("frequency", f)})
    return f, rr, ri, ref, port


def _scores(f, rr, ri, p0, p1, piv):
    """Float64 ACME score of each row at its phases."""
    d = tph._phased_real_planar(_t(rr), _t(ri), _t(f), _t(p0), _t(p1),
                                _t(piv)[..., None], float(f[-1] - f[0]))
    return tph.acme_score_raw(d).numpy()


def _phases(da):
    return (np.ravel(da.attrs["phase_p0"]), np.ravel(da.attrs["phase_p1"]),
            np.ravel(da.attrs["phase_pivot"]))


def _hold(s_port, s_ref):
    """(n_seeds, V) scores of both packages over the same seeds: in the
    best basin the port's score within 1e-3 of the reference's same-seed
    run; the port trapped outside it at most 2 sqrt(ref + 1) more often
    than the reference."""
    best = np.minimum(s_port.min(0), s_ref.min(0))
    port_ok = s_port <= best * (1 + 1e-3)
    ref_ok = s_ref <= best * (1 + 1e-3)
    both = port_ok & ref_ok
    assert np.all(s_port[both] <= s_ref[both] * (1 + 1e-3))
    trapped, trapped_ref = int((~port_ok).sum()), int((~ref_ok).sum())
    assert trapped <= trapped_ref + 2.0 * math.sqrt(trapped_ref + 1.0), (
        trapped, trapped_ref)


@pytest.mark.parametrize("p0_only", [False, True])
def test_autophase_single_de_matches_reference(phantom_grid, p0_only):
    """The default optimizer on the loudest row: the same pivot, p0 within
    1 deg and a score no worse than the reference's by 1e-3."""
    f, _, _, ref_da, port_da = phantom_grid
    ref = jph.autophase(ref_da, p0_only=p0_only)
    got = tph.autophase(port_da, p0_only=p0_only, device="cpu")
    p0, p1, piv = _phases(got)
    p0_r, p1_r, piv_r = _phases(ref)
    assert piv[0] == piv_r[0]
    assert abs(_wrap(p0[0] - p0_r[0])) <= 1.0
    if p0_only:
        assert p1[0] == 0.0
    vals = port_da.values
    row = vals[np.unravel_index(np.argmax(np.abs(vals)), vals.shape)[:3]]
    s = _scores(f, row.real, row.imag, p0, p1, piv)
    s_r = _scores(f, row.real, row.imag, p0_r, p1_r, piv_r)
    assert s[0] <= s_r[0] * (1 + 1e-3)
    np.testing.assert_allclose(got.values, tph.phase(
        port_da, p0=p0[0], p1=p1[0], pivot=piv[0]).values)


def test_autophase_all_de_p0_only_matches_reference(phantom_grid):
    """p0 alone is a one-dimensional search: every voxel reaches the
    reference's optimum."""
    f, rr, ri, ref_da, port_da = phantom_grid
    ref = jph.autophase(ref_da, mode="all", p0_only=True)
    got = tph.autophase(port_da, mode="all", p0_only=True, device="cpu")
    p0, p1, piv = _phases(got)
    p0_r, p1_r, piv_r = _phases(ref)
    np.testing.assert_array_equal(piv, piv_r)
    assert np.all(p1 == 0.0)
    s = _scores(f, rr, ri, p0, p1, piv)
    s_r = _scores(f, rr, ri, p0_r, p1_r, piv_r)
    assert np.all(s <= s_r * (1 + 1e-3))
    assert np.all(np.abs(_wrap(p0 - p0_r)) <= 1.0)


def test_autophase_all_de_matches_reference(phantom_grid):
    """p0 + p1 per voxel over five seeds: in the best basin the port
    holds to the reference, and it is trapped no more often than the
    reference by two standard deviations."""
    f, rr, ri, ref_da, port_da = phantom_grid
    runs = []
    for seed in SEEDS:
        ref = jph.autophase(ref_da, mode="all", seed=seed)
        got = tph.autophase(port_da, mode="all", seed=seed, device="cpu")
        np.testing.assert_array_equal(_phases(got)[2], _phases(ref)[2])
        runs.append((_phases(got), _phases(ref)))
    _hold_runs(runs, lambda ph: _scores(f, rr, ri, *ph))


def _hold_runs(runs, score):
    """:func:`_hold` on ``[(port phases, reference phases) per seed]``."""
    s = np.stack([[score(ph) for ph in run] for run in runs])  # (seed, 2, V)
    _hold(s[:, 0], s[:, 1])


def _recovery_case(**kw):
    """``tests/test_phasing.py::build_spectrum``'s dephased spectrum as a
    port array, with the pristine spectrum."""
    pristine, spec = build_spectrum(**kw)
    port = XmrArray(spec.values, dims=spec.dims,
                    coords={"frequency": Coord(
                        "frequency", spec.coords["frequency"].values)})
    return pristine, spec, port


@pytest.mark.parametrize("p0_only,p0_true,p1_true",
                         [(True, -55.0, 0.0), (False, 30.0, -400.0)])
def test_de_recovers_the_phase(p0_only, p0_true, p1_true):
    """``TestAutophase.test_recovers_p0``/``_p1`` with ``optimizer="de"``,
    and p0 within 1 deg of the reference's DE."""
    pristine, spec, port = _recovery_case(p0_true=p0_true, p1_true=p1_true)
    out = tph.autophase(port, p0_only=p0_only, device="cpu")
    assert real_corr(out.values, pristine.values) > 0.98
    ref = jph.autophase(spec, p0_only=p0_only)
    assert abs(_wrap(out.attrs["phase_p0"] - ref.attrs["phase_p0"])) <= 1.0
    if p0_only:
        assert out.attrs["phase_p1"] == 0.0


def test_de_mode_all_per_voxel_recovers_and_matches_grid():
    """``test_mode_all_per_voxel`` and ``test_mode_all_grid_optimizer``:
    per-voxel DE recovers each voxel's p0, and the grid search lands within
    1 deg of it."""
    builds = [_recovery_case(p0_true=p, seed=s)
              for p, s in [(40.0, 1), (-70.0, 2), (160.0, 3)]]
    port = XmrArray(np.stack([b[2].values for b in builds]),
                    dims=("voxel", "frequency"),
                    coords={"frequency": builds[0][2].coords["frequency"]})
    out_d = tph.autophase(port, mode="all", p0_only=True, device="cpu")
    out_g = tph.autophase(port, mode="all", p0_only=True, optimizer="grid",
                          device="cpu")
    for v, (pristine, _, _) in enumerate(builds):
        assert real_corr(out_d.values[v], pristine.values) > 0.98
    assert out_d.attrs["phase_p0"].shape == (3,)
    np.testing.assert_allclose(out_g.attrs["phase_p0"],
                               out_d.attrs["phase_p0"], atol=1.0)


def test_autophase_de_same_seed_same_result(phantom_grid):
    _, _, _, _, port_da = phantom_grid
    part = port_da.isel(x=0)
    for mode in ("single", "all"):
        a = tph.autophase(part, mode=mode, seed=3, device="cpu")
        b = tph.autophase(part, mode=mode, seed=3, device="cpu")
        np.testing.assert_array_equal(a.values, b.values)
        for key in ("phase_p0", "phase_p1"):
            np.testing.assert_array_equal(a.attrs[key], b.attrs[key])


def test_de_chunks_cover_every_row(phantom_grid):
    """Chunked per-voxel DE: every row gets its own search whatever the
    chunk size, and the chunk default follows the working-set budget."""
    f, rr, ri, _, _ = phantom_grid
    rr, ri = rr[:8], ri[:8]
    args = (_t(rr), _t(ri), _t(f), float(f[-1] - f[0]),
            _t(f[np.argmax(rr ** 2 + ri ** 2, 1)]), True)
    for chunk in (3, 8):
        xs = tph._de_phase_search(*args, chunk=chunk)
        assert xs.shape == (8, 2) and torch.isfinite(xs).all()
    assert tph.de_chunk_rows(16384, 30, 2048) == 8192
    assert tph.de_chunk_rows(100, 30, 2048) == 100
    assert tph.de_chunk_rows(10, 10 ** 9, 10 ** 9) == 1


# ---------------------------------------------------------------------------
# The pipeline at PipelineConfig defaults (DE) against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def de_program(tmp_path_factory):
    fids, t, amp = bench_phantom()
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path_factory.mktemp("pk"))
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    ref = ref_process(*(jnp.asarray(a.numpy()) for a in args),
                      cfg=RefConfig(zero_fill_to=ZF, dft_variant="pallas"),
                      interpret=True, **kw)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    reset_counters()
    got = process_grid_planar_raw(*args, cfg=PipelineConfig(zero_fill_to=ZF),
                                  **kw)
    calls = counters()["plain_calls"]
    unphased = spectral_pipeline_planar_raw(
        *args[:4], PipelineConfig(zero_fill_to=ZF, autophase="none"))
    return ref, got, args, unphased, calls


def test_process_grid_defaults_match_reference(de_program):
    """``PipelineConfig(zero_fill_to=...)`` runs DE on the pivot row: the
    reference's pivot, a score no worse than the reference program's by
    1e-3, p0 within 1 deg + the spread of the reference program's and the
    reference's row solve at seeds 1 and 2, and the fit to
    ``tests/test_process.py:78-84``."""
    ref, got, _, (u_re, u_im, _), calls = de_program
    assert PipelineConfig().ap_optimizer == "de"
    assert all(calls[n] > 0 for n in PATHS["grid_single_pivot_de"])
    assert calls["acme_polish"] == 0
    _, _, (p0_r, p1_r, piv_r), x_r, cost_r, _, sds_r = ref
    _, _, (p0, p1, piv), x, cost, conv, sds = got
    assert float(piv) == float(piv_r)
    m2 = u_re.double() ** 2 + u_im.double() ** 2
    v = int(torch.argmax(m2.max(1).values))
    row_re, row_im = u_re[v].double().numpy(), u_im[v].double().numpy()
    f = FREQS.astype(np.float64)
    s = _scores(f, row_re, row_im, [float(p0)], [float(p1)], [float(piv)])
    s_r = _scores(f, row_re, row_im, [float(p0_r)], [float(p1_r)],
                  [float(piv_r)])
    assert s[0] <= s_r[0] * (1 + 1e-3)
    p0_refs = [float(p0_r)] + [
        float(ref_solve_phase(jnp.asarray(u_re[v].numpy()),
                              jnp.asarray(u_im[v].numpy()), jnp.asarray(FREQS),
                              jnp.asarray(piv_r),
                              RefConfig(zero_fill_to=ZF, de_seed=seed))[0])
        for seed in (1, 2)]
    spread = max(abs(float(_wrap(a - b))) for a in p0_refs for b in p0_refs)
    assert abs(_wrap(float(p0) - float(p0_r))) <= 1.0 + spread
    assert conv.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_r, rtol=2e-2, atol=1e-4)


def test_per_voxel_de_pipeline_matches_reference(de_program):
    """``autophase="all"`` with the default DE: the per-voxel search of
    :func:`_de_phase_search` on the pipeline's own spectra (bit for bit,
    K5 not launched), and over three seeds every search that ends in the
    best basin within 1e-3 of the reference's same-seed score.  The trap
    rate is held in :func:`test_autophase_all_de_matches_reference`."""
    _, _, args, (u_re, u_im, _), _ = de_program
    f = FREQS.astype(np.float64)
    rows = (u_re.double().numpy(), u_im.double().numpy())
    s = []
    for seed in (42, 1, 2):
        ref = ref_spectral(*(jnp.asarray(a.numpy()) for a in args[:4]),
                           RefConfig(zero_fill_to=ZF, autophase="all",
                                     dft_variant="pallas", de_seed=seed))
        reset_counters()
        got = spectral_pipeline_planar_raw(
            *args[:4], PipelineConfig(zero_fill_to=ZF, autophase="all",
                                      de_seed=seed))
        calls = counters()["plain_calls"]
        assert calls["spectrum"] == 1 and calls["acme_polish"] == 0
        p0, p1, piv = got[2]
        np.testing.assert_array_equal(piv.numpy(), np.asarray(ref[2][2]))
        xs = tph._de_phase_search(u_re, u_im, args[3], args[3][-1] - args[3][0],
                                  piv, False, seed=seed, maxiter=200)
        assert torch.equal(xs[:, 0], p0) and torch.equal(xs[:, 1], p1)
        s.append([_scores(f, *rows, *(np.asarray(a, np.float64) for a in ph))
                  for ph in (got[2], ref[2])])
    s = np.asarray(s)
    best = s.reshape(-1, s.shape[-1]).min(0)
    both = (s <= best * (1 + 1e-3)).all(1)
    assert np.all(s[:, 0][both] <= s[:, 1][both] * (1 + 1e-3))
