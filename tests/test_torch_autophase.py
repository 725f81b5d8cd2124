"""The port's ACME objective, the K5 polish's plain twin, per-voxel
``autophase`` and ``process_grid_planar_raw(autophase="all")`` against the
JAX package.

Inputs are made with numpy from a seed; the JAX side runs the Pallas polish
in interpret mode, as ``tests/test_acme_pallas.py`` does.  Tolerances: the
objective and its gradient as ``test_acme_pallas.py:67-73`` (value rtol
1e-8, gradient rtol 1e-5 / atol 1e-7 max|g|, float64); a polish or a
search per voxel either lands within 0.01 deg of the reference's phases or
scores no worse than x1.02 + 1e-9 of the reference's score
(``test_acme_pallas.py:163``; the ACME valleys are flat, so equal-score
optima can sit apart); spectra to 1e-6 max|S|.
"""

import dataclasses

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
from xmris_tpu.ops.kernels.acme_pallas import _acme_value_grad, acme_polish_pallas
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.ops import phasing as tph
from xmris_tpu_torch.ops.kernels import acme_cuda
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

from _torch_parity import (
    BENCH_PK_CSV,
    MHZ,
    bench_phantom,
    load_priors,
    spectral_constants,
)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _wrap(d):
    return (np.asarray(d) + 180.0) % 360.0 - 180.0


# ---------------------------------------------------------------------------
# The objective's subgradient at a tied maximum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", [
    [1.0, 3.0, 3.0, 0.0],
    [0.2, -0.5, 2.0, 1.1, 2.0, -0.3, 2.0, 0.7],
])
def test_acme_gradient_splits_tied_maxima_as_jax(row):
    """jax.grad of the max normalization splits the subgradient evenly
    among tied maxima; the port's autograd must too (``amax``).  The first
    row's tie is also a zero first difference, where ``jnp.abs`` has
    derivative 1."""
    x = np.asarray(row, dtype=np.float64)
    want = np.asarray(jax.grad(jph.acme_score_raw)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    tph.acme_score_raw(xt).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# K5's plain twin against the reference kernel's arithmetic
# ---------------------------------------------------------------------------


def _random_batch(rng, vt=8, nf=256, degenerate=0):
    """``test_acme_pallas._random_batch``: noisy rows with one peak, random
    pivots and phases; ``degenerate`` rows are negative everywhere."""
    f = np.linspace(-2500.0, 2500.0, nf)
    re = rng.normal(0, 1, (vt, nf)) + 5 * np.exp(-(((f[None, :] - 300) / 50) ** 2))
    im = rng.normal(0, 1, (vt, nf))
    for v in range(degenerate):
        re[v] = -np.abs(re[v]) - 1.0
        im[v] = 0.0
    piv = rng.uniform(-1000, 1000, (vt,))
    p = np.stack([rng.uniform(-150, 150, vt), rng.uniform(-3000, 3000, vt)], 1)
    return f, re, im, piv, p


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("trial", range(3))
def test_acme_one_evaluation_matches_reference(trial, p0_only):
    """K5's plain twin with no step (``n_iter=0``): the score and gradient
    at ``p`` against the reference kernel's ``_acme_value_grad``."""
    rng = np.random.default_rng(100 + trial)
    f, re, im, piv, p = _random_batch(rng, degenerate=trial % 2)
    if trial % 2:
        p[0] = 0.0  # the degenerate row stays negative: score +inf
    u = (f[None, :] - piv[:, None]) / float(f[-1] - f[0])
    v_ref, g_ref = _acme_value_grad(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(u), jnp.asarray(p),
        p0_only=p0_only, want_grad=True, mosaic=False,
    )
    v_ref, g_ref = np.asarray(v_ref)[:, 0], np.asarray(g_ref)
    _, v, g = acme_cuda.acme_polish_plain(
        _t(re), _t(im), _t(f), _t(piv), _t(p), float(f[-1] - f[0]), n_iter=0,
        p0_only=p0_only, with_grad=True)
    finite = np.isfinite(v_ref)
    assert (trial % 2 == 0) or not finite[0]
    np.testing.assert_array_equal(np.isfinite(v.numpy()), finite)
    np.testing.assert_allclose(v.numpy()[finite], v_ref[finite], rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5,
                               atol=1e-7 * float(np.abs(g_ref).max()))


def _phantom(n_voxels=12, nf=512, seed=3):
    """``test_acme_pallas.TestFusedPolish._phantom``: two Lorentzians per
    voxel with random zero/first-order phase errors and noise."""
    rng = np.random.default_rng(seed)
    f = np.linspace(-2500.0, 2500.0, nf)
    re = np.zeros((n_voxels, nf))
    for _ in range(2):
        center = rng.uniform(-2000, 2000, (n_voxels, 1))
        lw = rng.uniform(30, 80, (n_voxels, 1))
        amp = rng.uniform(5, 25, (n_voxels, 1))
        re += amp / (1.0 + ((f[None, :] - center) / lw) ** 2)
    p0 = rng.uniform(-120, 120, (n_voxels, 1))
    p1 = rng.uniform(-500, 500, (n_voxels, 1))
    phi = np.deg2rad(p0 + p1 * (f[None, :] - f[0]) / (f[-1] - f[0]))
    rr = re * np.cos(phi) + rng.normal(0, 0.1, (n_voxels, nf))
    ri = -re * np.sin(phi) + rng.normal(0, 0.1, (n_voxels, nf))
    return f, rr, ri


def _scores(f, rr, ri, p, piv):
    """Float64 ACME score of every row at its phases."""
    xr = float(f[-1] - f[0])
    d = tph._phased_real_planar(_t(rr), _t(ri), _t(f), _t(p[:, 0]),
                                _t(p[:, 1]), _t(piv)[:, None], xr)
    return tph.acme_score_raw(d).numpy()


def _agree(f, rr, ri, p, p_ref, piv, piv_ref=None):
    """Each voxel within 0.01 deg of the reference's phases, or scoring no
    worse than x1.02 + 1e-9 of the reference's score."""
    p, p_ref = np.asarray(p), np.asarray(p_ref)
    piv_ref = piv if piv_ref is None else piv_ref
    close = (np.abs(_wrap(p[:, 0] - p_ref[:, 0])) <= 0.01) & (
        np.abs(p[:, 1] - p_ref[:, 1]) <= 0.01)
    s, s_ref = _scores(f, rr, ri, p, piv), _scores(f, rr, ri, p_ref, piv_ref)
    ok = close | (s <= s_ref * 1.02 + 1e-9)
    assert ok.all(), (np.nonzero(~ok)[0], s[~ok], s_ref[~ok])
    return close


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("n_voxels", [12, 11])
def test_acme_polish_plain_matches_reference_kernel(p0_only, n_voxels):
    """The whole 40-step polish against ``acme_polish_pallas`` (interpret),
    from the port's grid-scan seeds, on a batch that is a multiple of the
    reference's voxel tile or not."""
    f, rr, ri = _phantom(n_voxels=n_voxels)
    piv = f[np.argmax(rr ** 2 + ri ** 2, axis=1)]
    xr = float(f[-1] - f[0])
    seeds_only = dataclasses.replace(tph.DISPATCH,
                                     acme_polish=lambda *a, **k: (a[4], None))
    seed = tph._grid_phase_search(_t(rr), _t(ri), _t(f), xr, _t(piv), p0_only,
                                  polish_optimizer="fused", kernels=seeds_only)
    p_ref, s_ref = acme_polish_pallas(
        jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(f), jnp.asarray(piv),
        jnp.asarray(seed.numpy()), xr, p0_only=p0_only, interpret=True,
    )
    p, s = acme_cuda.acme_polish_plain(_t(rr), _t(ri), _t(f), _t(piv), seed,
                                       xr, p0_only=p0_only)
    assert p.shape == (n_voxels, 2) and s.shape == (n_voxels,)
    s_ref = np.asarray(s_ref)
    assert np.all(s.numpy() <= s_ref * 1.02 + 1e-9)
    assert np.all(s_ref <= s.numpy() * 1.02 + 1e-9)
    assert _agree(f, rr, ri, p.numpy(), np.asarray(p_ref), piv).all()


def test_candidate_chunking_keeps_the_first_minimum():
    """The chunked scan picks the same candidates whatever the chunk size
    (a chunk's winner replaces the running best only when strictly better;
    padding repeats the last candidate)."""
    f, rr, ri = _phantom(n_voxels=6, nf=256)
    piv = f[np.argmax(rr ** 2 + ri ** 2, axis=1)]
    outs = [
        tph._grid_phase_search(_t(rr), _t(ri), _t(f), float(f[-1] - f[0]),
                               _t(piv), False, cand_chunk=c)
        for c in (1, 4, 7, 64)
    ]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# ---------------------------------------------------------------------------
# autophase against the reference
# ---------------------------------------------------------------------------

SHAPE = (4, 4, 2)


@pytest.fixture(scope="module")
def phantom_grid():
    """A (4, 4, 2) grid of phase-distorted 1024-point spectra (the stride
    of the decimated scan is 2, so the p0-only polish runs both phases)."""
    f, rr, ri = _phantom(n_voxels=int(np.prod(SHAPE)), nf=1024, seed=5)
    spec = (rr + 1j * ri).reshape(SHAPE + (1024,))
    dims = ("x", "y", "z", "frequency")
    ref = xmt.XmrArray(spec, dims=dims,
                       coords={"frequency": JCoord("frequency", f)})
    port = XmrArray(spec, dims=dims, coords={"frequency": Coord("frequency", f)})
    return f, ref, port


def _work_rows(port, lb):
    """The rows the search scores: the spectra, lb-smoothed for lb > 0."""
    from xmris_tpu_torch.ops.fid import apodize_exp, to_fid, to_spectrum

    work = port
    if lb > 0:
        work = to_spectrum(apodize_exp(to_fid(port, dim="frequency",
                                              out_dim="time"),
                                       dim="time", lb=lb),
                           dim="time", out_dim="frequency")
    return work.values.reshape(-1, port.sizes["frequency"])


@pytest.mark.parametrize("polish,lb,p0_only", [
    ("gd", 0.0, False), ("fused", 0.0, False), ("gd", 3.0, False),
    ("fused", 3.0, False), ("gd", 0.0, True), ("fused", 3.0, True),
])
def test_autophase_all_matches_reference(phantom_grid, polish, lb, p0_only):
    f, ref_da, port_da = phantom_grid
    kw = dict(mode="all", optimizer="grid", polish_optimizer=polish, lb=lb,
              p0_only=p0_only)
    ref = jph.autophase(ref_da, **kw)
    got = tph.autophase(port_da, device="cpu", **kw)
    assert got.dims == ref.dims and got.shape == ref.shape
    assert isinstance(got.data, np.ndarray) and got.dtype == ref.dtype
    assert set(got.attrs) == set(ref.attrs)
    assert got.attrs["phase_pivot_coord"] == "frequency"
    np.testing.assert_array_equal(got.attrs["phase_pivot"],
                                  ref.attrs["phase_pivot"])
    p = np.stack([got.attrs["phase_p0"].ravel(), got.attrs["phase_p1"].ravel()], 1)
    p_ref = np.stack([ref.attrs["phase_p0"].ravel(),
                      ref.attrs["phase_p1"].ravel()], 1)
    if p0_only:
        assert np.all(p[:, 1] == 0.0)
    rows = _work_rows(port_da, lb)
    piv = got.attrs["phase_pivot"].ravel()
    close = _agree(f, rows.real, rows.imag, p, p_ref, piv)
    # Where the phases agree (to 0.01 deg in p0 and in p1), so do the
    # phased spectra.
    v, v_ref = (a.reshape(-1, len(f)) for a in (got.values, ref.values))
    scale = float(np.abs(v_ref).max())
    np.testing.assert_allclose(v[close], v_ref[close], rtol=0,
                               atol=2 * np.deg2rad(0.01) * scale)


def test_autophase_single_matches_reference(phantom_grid):
    f, ref_da, port_da = phantom_grid
    kw = dict(mode="single", optimizer="grid")
    ref = jph.autophase(ref_da, **kw)
    got = tph.autophase(port_da, device="cpu", **kw)
    assert got.attrs["phase_pivot"] == ref.attrs["phase_pivot"]
    assert abs(_wrap(got.attrs["phase_p0"] - ref.attrs["phase_p0"])) <= 0.01
    assert abs(got.attrs["phase_p1"] - ref.attrs["phase_p1"]) <= 0.01
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-6, atol=1e-9)


def test_autophase_keeps_a_tensor_payload(phantom_grid):
    f, _, port_da = phantom_grid
    tens = port_da.to("cpu")
    got = tph.autophase(tens, mode="all", optimizer="grid", device="cpu")
    assert isinstance(got.data, torch.Tensor)
    np.testing.assert_allclose(
        got.values,
        tph.autophase(port_da, mode="all", optimizer="grid", device="cpu").values,
        rtol=1e-12, atol=1e-12)


def test_autophase_default_de_runs(phantom_grid):
    """optimizer="de" (the default), which raised in
    ``test_unported_autophase_options_raise``, runs."""
    _, _, da = phantom_grid
    out = tph.autophase(da, device="cpu")
    assert np.isfinite(out.attrs["phase_p0"]) and out.shape == da.shape


def test_unported_autophase_options_raise(phantom_grid):
    """The options that raised NotImplementedError until item 7 was ported
    (scipy, the ROI methods, the newton/bfgs polishes) now run: finite
    phases of the right shape (parity: ``test_torch_autophase_rest.py``)."""
    _, _, da = phantom_grid
    for kw in (dict(optimizer="scipy"),
               dict(optimizer="grid", method="peak_minima"),
               dict(optimizer="grid", polish_optimizer="newton"),
               dict(optimizer="grid", mode="all", polish_optimizer="bfgs")):
        out = tph.autophase(da, device="cpu", **kw)
        p0 = np.asarray(out.attrs["phase_p0"])
        assert out.shape == da.shape and np.isfinite(p0).all(), kw
        assert p0.shape == (SHAPE if kw.get("mode") == "all" else ())
    with pytest.raises(ValueError, match="Mode"):
        tph.autophase(da, mode="some", optimizer="grid", device="cpu")
    with pytest.raises(ValueError, match="Method"):
        tph.autophase(da, method="entropy", optimizer="grid", device="cpu")


def test_scipy_in_mode_all_raises_the_reference_value_error(phantom_grid):
    """scipy is single-mode only: mode="all" refuses it with the
    reference's ValueError and message, before any check of what is not
    ported."""
    _, ref_da, da = phantom_grid
    with pytest.raises(ValueError) as ref_err:
        jph.autophase(ref_da, mode="all", optimizer="scipy")
    for method in ("acme", "peak_minima"):
        with pytest.raises(ValueError) as port_err:
            tph.autophase(da, mode="all", optimizer="scipy", method=method,
                          device="cpu")
        assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# The per-grid program with per-voxel autophase
# ---------------------------------------------------------------------------

ZF, WEIGHT, FREQS = spectral_constants()


@pytest.fixture(scope="module")
def per_voxel_program(tmp_path_factory):
    fids, t, amp = bench_phantom()
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path_factory.mktemp("pk"))
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    ref_cfg = RefConfig(zero_fill_to=ZF, lb=5.0, autophase="all",
                        dft_variant="pallas", spec_layout="flat",
                        ap_optimizer="grid")
    ref = ref_process(*(jnp.asarray(a.numpy()) for a in args), cfg=ref_cfg,
                      interpret=True, **kw)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    cfg = PipelineConfig(zero_fill_to=ZF, autophase="all", spec_layout="flat",
                         ap_optimizer="grid")
    got = process_grid_planar_raw(*args, cfg=cfg, **kw)
    unphased = spectral_pipeline_planar_raw(
        *args[:4], PipelineConfig(zero_fill_to=ZF, autophase="none"))
    return ref, got, args, unphased


def test_process_grid_per_voxel_matches_reference(per_voxel_program):
    ref, got, _, (u_re, u_im, _) = per_voxel_program
    sr_r, si_r, (p0_r, p1_r, piv_r), x_r, cost_r, conv_r, sds_r = ref
    sr, si, (p0, p1, piv), x, cost, conv, sds = got
    assert p0.shape == p0_r.shape == (len(sr_r),)
    np.testing.assert_array_equal(piv.numpy(), piv_r)
    p = np.stack([p0.numpy(), p1.numpy()], 1)
    p_ref = np.stack([p0_r, p1_r], 1)
    _agree(FREQS.astype(np.float64), u_re.numpy().astype(np.float64),
           u_im.numpy().astype(np.float64), p, p_ref, piv.numpy())
    # The spectra agree once the reference's are rotated onto the port's
    # per-voxel phases.
    x_range = float(FREQS[-1] - FREQS[0])
    f64 = FREQS.astype(np.float64)[None, :]

    def phi(a0, a1, pv):
        return (np.deg2rad(np.asarray(a0, np.float64))[:, None]
                + np.deg2rad(np.asarray(a1, np.float64))[:, None]
                * ((f64 - np.asarray(pv, np.float64)[:, None]) / x_range))

    d = phi(p0, p1, piv) - phi(p0_r, p1_r, piv_r)
    rot_re = sr_r * np.cos(d) - si_r * np.sin(d)
    rot_im = sr_r * np.sin(d) + si_r * np.cos(d)
    scale = float(np.abs(sr_r).max())
    np.testing.assert_allclose(sr.numpy(), rot_re, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(si.numpy(), rot_im, rtol=0, atol=1e-6 * scale)
    assert conv.all() and conv_r.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_r, rtol=2e-2, atol=1e-4)


def test_process_grid_per_voxel_fused_polish_scores(per_voxel_program):
    """The fused polish (K5's plain twin on the CPU) reaches the
    reference gd polish's scores voxel for voxel."""
    ref, _, args, (u_re, u_im, _) = per_voxel_program
    cfg = PipelineConfig(zero_fill_to=ZF, autophase="all", spec_layout="flat",
                         ap_optimizer="grid", ap_polish="fused")
    _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(*args[:4], cfg)
    p = np.stack([p0.numpy(), p1.numpy()], 1)
    p_ref = np.stack([ref[2][0], ref[2][1]], 1)
    _agree(FREQS.astype(np.float64), u_re.numpy().astype(np.float64),
           u_im.numpy().astype(np.float64), p, p_ref, piv.numpy())


def test_per_voxel_pipeline_runs_the_default_de(per_voxel_program):
    """ap_optimizer="de" (the default), which raised in
    ``test_per_voxel_pipeline_unported_options_raise``: one DE per voxel."""
    args = per_voxel_program[2]
    _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(
        *args[:4], PipelineConfig(zero_fill_to=ZF, autophase="all"))
    assert p0.shape == piv.shape == (args[0].shape[0],)
    assert torch.isfinite(p0).all() and torch.isfinite(p1).all()


def test_per_voxel_pipeline_unported_options_raise(per_voxel_program):
    """ap_polish="newton", which raised NotImplementedError until item 7
    was ported, runs per voxel: finite (B,) phases."""
    args = per_voxel_program[2]
    cfg = PipelineConfig(zero_fill_to=ZF, autophase="all",
                         ap_optimizer="grid", ap_polish="newton")
    _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(*args[:4], cfg)
    assert p0.shape == p1.shape == piv.shape == (args[0].shape[0],)
    assert torch.isfinite(p0).all() and torch.isfinite(p1).all()
    assert float(p0.abs().max()) <= 180.0 and float(p1.abs().max()) <= 4000.0
