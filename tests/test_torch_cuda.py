"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere (the
kernels have no CPU mode; on the CPU the wrappers run the plain versions,
which ``test_torch_kernels.py`` holds against the JAX package).  The module
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the reference tests' own (see ``test_torch_kernels.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting.amares import (
    fit_amares,
    seed_plan,
    seeded_fit_grid_raw,
)
from xmris_tpu_torch.fitting.lm import (
    _expand_params_batched,
    hashable_pmap,
    normal_eq_plan,
    slab_to_bff,
)
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import acme_cuda, dft_cuda, lm_cuda, spd
from xmris_tpu_torch.ops.phasing import (
    _grid_phase_search,
    grid_phase_search_graphed,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

pytestmark = pytest.mark.cuda

# The bench prior with every g free (Voigt rows, t^2 coefficient terms).
FREE_G_CSV = bi.PK_CSV.replace("g,0,0,0,0,0", "g,0.1,0.1,0.1,0.1,0.1").replace(
    "g,fixed,fixed,fixed,fixed,fixed",
    'g,"(0, 1)","(0, 1)","(0, 1)","(0, 1)","(0, 1)"',
)
GRID = (4, 4, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _planes(dev, grid=GRID):
    fids, weight, freqs = bi.make_inputs(grid)
    re = torch.as_tensor(np.ascontiguousarray(fids.real), device=dev)
    im = torch.as_tensor(np.ascontiguousarray(fids.imag), device=dev)
    return re, im, torch.as_tensor(weight, device=dev), torch.as_tensor(
        freqs, device=dev)


@pytest.mark.parametrize("stacked", [True, False])
def test_spectrum_kernel_matches_plain(dev, stacked):
    re, im, w, _ = _planes(dev)
    win = w[: bi.N_TIME].contiguous()
    got = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win,
                            with_maxmag=True, stacked_out=stacked)
    ref = dft_cuda.spectrum_plain(re, im, bi.ZERO_FILL, window=win,
                                  with_maxmag=True, stacked_out=stacked)
    assert got[0].shape == ref[0].shape
    scale = float(torch.maximum(ref[0].abs().max(), ref[1].abs().max()))
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
    assert torch.equal(got[3].long(), ref[3].long())


def _normal_eq_inputs(dev, csv_text, seed=0):
    pk = prior_from_csv_text(csv_text)
    ps = hashable_pmap(pk.pmap)
    re, im, _, _ = _planes(dev)
    b, nf = re.shape[0], pk.n_free
    rng = np.random.default_rng(seed)
    x = np.clip(pk.init_free[None] * rng.uniform(0.8, 1.2, (b, nf)),
                pk.lower, pk.upper).astype(np.float32)
    grids = _expand_params_batched(torch.as_tensor(x, device=dev), ps)
    dxdu = torch.as_tensor(rng.uniform(0.5, 1.5, (b, nf)).astype(np.float32),
                           device=dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    return ps, nf, (grids.contiguous(), re, im, t, dxdu)


@pytest.mark.parametrize("prior,factored", [
    ("bench", True), ("bench", False), ("free_g", True), ("free_g", False),
])
def test_normal_equations_kernel_matches_plain(dev, prior, factored):
    csv_text = bi.PK_CSV if prior == "bench" else FREE_G_CSV
    ps, nf, ins = _normal_eq_inputs(dev, csv_text)
    plan = normal_eq_plan(ps, nf, bi.MHZ, factored)
    c, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    c2, g2, h2 = lm_cuda.eq6_normal_equations_plain(*ins, plan)
    torch.testing.assert_close(c, c2, rtol=1e-5, atol=0)
    torch.testing.assert_close(g, g2, rtol=1e-4,
                               atol=1e-3 * float(g2.abs().max()))
    torch.testing.assert_close(h, h2, rtol=1e-4,
                               atol=1e-3 * float(h2.abs().max()))


def test_normal_equations_mask_skips_only_masked_voxels(dev):
    ps, nf, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    b = ins[1].shape[0]
    mask = torch.arange(b, device=dev) % 3 != 0
    c, g, h = lm_cuda.eq6_normal_equations(*ins, plan, voxel_mask=mask)
    c2, g2, h2 = lm_cuda.eq6_normal_equations(*ins, plan)
    assert torch.equal(c[mask], c2[mask])
    assert torch.equal(g[mask], g2[mask])
    assert torch.equal(h[:, mask], h2[:, mask])


def test_spd_kernels_match_plain(dev):
    ps, nf, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    _, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    b = g.shape[0]
    h[0, 3] = -1.0  # voxel 3 is not SPD
    lam = torch.full((b,), 1e-3, device=dev)
    x = spd.spd_solve_damped(h, g, lam)
    x2 = spd.spd_solve_damped_plain(h, g, lam)
    torch.testing.assert_close(x, x2, rtol=2e-6, atol=1e-7, equal_nan=True)
    d = spd.spd_inverse_diag(h, 1e-12)
    d2 = spd.spd_inverse_diag_plain(h, 1e-12)
    torch.testing.assert_close(d, d2, rtol=2e-4, atol=0, equal_nan=True)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad[3] = True
    assert torch.equal(torch.isnan(x).all(1), bad)
    assert torch.equal(torch.isnan(d).all(1), bad)
    assert not torch.isnan(x[~bad]).any()


@pytest.mark.parametrize("p0_only", [False, True])
def test_graphed_phase_search_equals_eager(dev, p0_only):
    """The CUDA-graph replay runs the eager search's kernels: equal results,
    also when a later call brings new data into the captured buffers."""
    re, im, w, freqs = _planes(dev)
    sr, si, mv, mi = dft_cuda.spectrum(re, im, bi.ZERO_FILL,
                                       window=w[: bi.N_TIME].contiguous(),
                                       with_maxmag=True)
    x_range = freqs[-1] - freqs[0]
    for v in (int(torch.argmax(mv)), 7):
        args = (sr[v:v + 1], si[v:v + 1], freqs, x_range,
                freqs[mi[v].long()][None])
        got = grid_phase_search_graphed(*args, p0_only)
        want = _grid_phase_search(*args, p0_only)
        assert torch.equal(got, want)


def test_wrappers_refuse_noncontiguous(dev):
    re, im, _, _ = _planes(dev)
    with pytest.raises(ValueError, match="contiguous"):
        dft_cuda.spectrum(re[:, ::2], im[:, ::2], bi.ZERO_FILL)


def test_grid_fit_runs_on_the_kernels(dev):
    """The seeded grid fit launches K2-K4 (no plain version) and matches the
    plain path on the card."""
    pk = prior_from_csv_text(bi.PK_CSV)
    re, im, _, _ = _planes(dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    x_t = torch.as_tensor(pk.init_free, dtype=torch.float32, device=dev)
    bounds = [torch.as_tensor(a, device=dev) for a in
              (pk.lower.astype(np.float32), pk.upper.astype(np.float32),
               pk.kind)]
    amp_slots, ls_plan = seed_plan(pk)
    kw = dict(pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    K.reset_counters()
    x, cost, conv, sds = seeded_fit_grid_raw(re, im, t, x_t, *bounds, **kw)
    torch.cuda.synchronize()
    counts = K.counters()
    for name in ("eq6_normal_eq_v9", "spd_solve_damped", "spd_inverse_diag"):
        assert counts["launches"][name] > 0
        assert counts["plain_calls"][name] == 0
    x2, cost2, _, _ = seeded_fit_grid_raw(re, im, t, x_t, *bounds, **kw,
                                          kernels=K.PLAIN)
    assert conv.all()
    torch.testing.assert_close(cost, cost2, rtol=1e-4, atol=0)
    truth = torch.as_tensor(bi.pcr_amplitudes(GRID), device=dev,
                            dtype=torch.float32)
    slot = int(pk.pmap.idx[0])
    assert float(((x[:, slot] - truth).abs() / truth).median()) <= 0.05


def _acme_rows(dev, b, n_f, seed=0, nonpositive=(3,)):
    """Unphased K1 spectra of ``b`` bench voxels decimated to ``n_f`` points,
    random pivots and phases; the rows in ``nonpositive`` have a negative
    real part and phases (0, 0), so the phased row is < 0 everywhere
    (score +inf, zero gradient)."""
    fids, weight, freqs = bi.make_inputs((b, 1, 1))
    re = torch.as_tensor(np.ascontiguousarray(fids.real), device=dev)
    im = torch.as_tensor(np.ascontiguousarray(fids.imag), device=dev)
    w = torch.as_tensor(weight[: bi.N_TIME], device=dev)
    sr, si = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=w)
    step = bi.ZERO_FILL // n_f
    sr = sr[:, ::step][:, :n_f].contiguous()
    si = si[:, ::step][:, :n_f].contiguous()
    for v in nonpositive:
        sr[v] = -sr[v].abs() - 1.0
        si[v] = 0.0
    axis = freqs[::step][:n_f].copy()
    coords = torch.as_tensor(axis, device=dev)
    rng = np.random.default_rng(seed)
    piv = torch.as_tensor(rng.choice(axis, b), device=dev)
    p = torch.as_tensor(np.stack([rng.uniform(-150, 150, b),
                                  rng.uniform(-3000, 3000, b)], 1)
                        .astype(np.float32), device=dev)
    p[list(nonpositive)] = 0.0
    return sr, si, coords, piv, p, float(coords[-1] - coords[0])


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("b,n_f", [(37, 2048), (37, 512), (5, 1000)])
def test_acme_value_grad_kernel_matches_plain(dev, p0_only, b, n_f):
    """One evaluation (n_iter=0): score and gradient at the reference test's
    tolerances (``test_acme_pallas.py:67-73``), on a batch that is not a
    multiple of anything, a ragged row length, and an all-negative row."""
    sr, si, crd, piv, p, xr = _acme_rows(dev, b, n_f)
    kw = dict(n_iter=0, p0_only=p0_only, with_grad=True)
    _, f, g = acme_cuda.acme_polish(sr, si, crd, piv, p, xr, **kw)
    _, f2, g2 = acme_cuda.acme_polish_plain(sr, si, crd, piv, p, xr, **kw)
    assert torch.isinf(f[3]) and torch.isinf(f2[3])
    assert torch.equal(g[3], torch.zeros_like(g[3]))
    torch.testing.assert_close(f, f2, rtol=1e-5, atol=0)
    torch.testing.assert_close(g, g2, rtol=1e-5,
                               atol=1e-7 * float(g2.abs().max()))
    if p0_only:
        assert torch.equal(g[:, 1], torch.zeros_like(g[:, 1]))


@pytest.mark.parametrize("p0_only", [False, True])
def test_acme_polish_kernel_matches_plain(dev, p0_only):
    """The whole 40-step polish: every voxel's final score within x1.02 of
    the plain loop's both ways (``test_acme_pallas.py:163``), phases within
    0.01 deg, and the all-negative row left where it started."""
    sr, si, crd, piv, p, xr = _acme_rows(dev, 37, 2048)
    p, f, _ = acme_cuda.acme_polish(sr, si, crd, piv, p, xr, n_iter=0,
                                    with_grad=True)
    start = p.clone()
    pk, fk = acme_cuda.acme_polish(sr, si, crd, piv, p, xr, p0_only=p0_only)
    pp, fp = acme_cuda.acme_polish_plain(sr, si, crd, piv, p, xr,
                                         p0_only=p0_only)
    live = torch.isfinite(fp)
    assert torch.equal(live, torch.isfinite(fk)) and not live[3]
    assert (fk[live] <= fp[live] * 1.02 + 1e-9).all()
    assert (fp[live] <= fk[live] * 1.02 + 1e-9).all()
    dp0 = torch.remainder(pk[:, 0] - pp[:, 0] + 180.0, 360.0) - 180.0
    assert float(dp0.abs().max()) <= 0.01
    assert float((pk[:, 1] - pp[:, 1]).abs().max()) <= 0.01
    assert torch.equal(pk[3], start[3])


def test_acme_polish_refuses_what_the_kernel_cannot_take(dev):
    sr, si, crd, piv, p, xr = _acme_rows(dev, 4, 512, nonpositive=())
    with pytest.raises(TypeError, match="float32"):
        acme_cuda.acme_polish(sr.double(), si.double(), crd.double(),
                              piv.double(), p.double(), xr)
    with pytest.raises(ValueError, match="contiguous"):
        acme_cuda.acme_polish(sr.t().contiguous().t(), si, crd, piv, p, xr)


@pytest.mark.parametrize("b", [37, 64])
def test_spd_inverse_diag_dense_kernel_matches_plain(dev, b):
    """K6b against its plain twin and against K4 on the same matrices in
    slab form (the same arithmetic: bit for bit), with planted non-SPD
    voxels giving exactly their NaN rows."""
    ps, nf, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    _, _, h = lm_cuda.eq6_normal_equations(*ins, plan)
    h = h[:, :b].contiguous()
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad[[2, b - 1]] = True
    h[0, bad] = -1.0
    dense = slab_to_bff(h, nf)
    d = spd.spd_inverse_diag_dense(dense)
    d2 = spd.spd_inverse_diag_dense_plain(dense)
    torch.testing.assert_close(d, d2, rtol=2e-4, atol=0, equal_nan=True)
    assert torch.equal(torch.isnan(d).all(1), bad)
    assert not torch.isnan(d[~bad]).any()
    d4 = spd.spd_inverse_diag(h, 0.0)
    assert torch.equal(d[~bad], d4[~bad])


def test_per_voxel_autophase_runs_on_the_kernels(dev):
    """process_grid_planar_raw(autophase="all") launches K1 and K5 (no plain
    version) and on the same spectra lands on the plain polish's phases."""
    fids, weight, freqs = bi.make_inputs(GRID)
    pk = prior_from_csv_text(bi.PK_CSV)
    amp_slots, ls_plan = seed_plan(pk)
    t = np.arange(bi.N_TIME) / bi.SW
    args = grid_inputs_from_numpy(fids, weight, freqs, t, pk.init_free, pk,
                                  dev)
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                         ap_optimizer="grid", spec_layout="flat")
    kw = dict(cfg=cfg, pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    K.reset_counters()
    out = process_grid_planar_raw(*args, **kw)
    torch.cuda.synchronize()
    counts = K.counters()
    for name in K.PATHS["grid_per_voxel"]:
        assert counts["launches"][name] > 0, name
    assert not any(counts["plain_calls"].values())
    same_spectra = dataclasses.replace(K.PLAIN, spectrum=dft_cuda.spectrum)
    plain = process_grid_planar_raw(*args, **kw, kernels=same_spectra)
    (p0, p1, piv), (p0p, p1p, pivp) = out[2], plain[2]
    assert p0.shape == (len(fids),) and torch.equal(piv, pivp)
    dp0 = torch.remainder(p0 - p0p + 180.0, 360.0) - 180.0
    assert float(dp0.abs().max()) <= 0.01
    assert float((p1 - p1p).abs().max()) <= 0.01


def test_fit_amares_runs_on_the_kernels(dev):
    """fit_amares on the card launches K2, K3 and K6b (no plain version),
    recovers the phantom, and matches the plain path."""
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    K.reset_counters()
    ds = fit_amares(da, pk)
    counts = K.counters()
    for name in K.PATHS["fit_amares"]:
        assert counts["launches"][name] > 0, name
    assert not any(counts["plain_calls"].values())
    assert ds["fit_converged"].values.all()
    amp = ds["amplitude"].values.reshape(-1, pk.n_peaks)[:, 0]
    truth = bi.pcr_amplitudes(GRID)
    assert np.median(np.abs(amp - truth) / truth) <= 0.05
    ds2 = fit_amares(da, pk, kernels=K.PLAIN)
    # The refinement pass keeps the lower of two float32-equal costs, which
    # may differ between the paths: phases (degrees) move along flat
    # valleys by a few thousandths of a degree, far inside their CRLB.
    for name in ("amplitude", "chem_shift", "linewidth"):
        np.testing.assert_allclose(ds[name].values, ds2[name].values,
                                   rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ds["phase"].values, ds2["phase"].values,
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(ds["crlb"].values, ds2["crlb"].values,
                               rtol=2e-2, atol=1e-4)
