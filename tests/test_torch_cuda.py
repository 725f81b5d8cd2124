"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere (the
kernels have no CPU mode; on the CPU the wrappers run the plain versions,
which ``test_torch_kernels.py`` holds against the JAX package).  The module
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the reference tests' own (see ``test_torch_kernels.py``),
except that the normal equations' g and H are held per entry at the scale
of their rows (``_assert_normal_eq_close``).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting.amares import (
    fit_amares,
    g_seed_plan,
    seed_grid,
    seed_plan,
    seeded_fit_grid_raw,
    stage_device_fids,
)
from xmris_tpu_torch.fitting.lm import (
    crlb_batched_pallas,
    hashable_pmap,
    lm_fit_batched_pallas,
    normal_eq_plan,
    slab_to_bff,
)
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.bounds import (
    expand_params_batched,
    internal_to_external_torch,
)
from xmris_tpu_torch.ops.kernels import (
    acme_cuda,
    dft_cuda,
    lm_cuda,
    lm_jac_cuda,
    lm_loop_cuda,
    spd,
)
from xmris_tpu_torch.ops import phasing as tph
from xmris_tpu_torch.ops.phasing import (
    _grid_phase_search,
    grid_phase_search_graphed,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw
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


def _random_planes(dev, b, n_in, seed=0):
    rng = np.random.default_rng(seed)
    re, im = (torch.as_tensor(rng.normal(size=(b, n_in)).astype(np.float32),
                              device=dev) for _ in range(2))
    win = torch.as_tensor(rng.uniform(0.5, 1.0, n_in).astype(np.float32),
                          device=dev)
    return re, im, win


def _assert_spectrum_close(got, ref):
    """K1's card check: spectra within 1e-6 max|S| of the plain version,
    peak values within rtol 1e-5, identical first argmax indices."""
    assert got[0].shape == ref[0].shape
    scale = float(torch.maximum(ref[0].abs().max(), ref[1].abs().max()))
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
    assert torch.equal(got[3].long(), ref[3].long())


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("n_in,n_out", [(256, 512), (1024, 1024), (1024, 2048),
                                        (512, 2048), (4096, 4096)])
def test_spectrum_fft_route_matches_plain(dev, n_in, n_out, stacked):
    """The FFT kernel at several lengths, on 37 voxels (not a multiple of
    the voxels a block takes)."""
    assert dft_cuda.route(n_in, n_out) == "fft"
    re, im, win = _random_planes(dev, 37, n_in)
    K.reset_counters()
    got = dft_cuda.spectrum(re, im, n_out, window=win, with_maxmag=True,
                            stacked_out=stacked)
    assert K.counters()["launches"]["spectrum"] == 1
    _assert_spectrum_close(got, dft_cuda.spectrum_plain(
        re, im, n_out, window=win, with_maxmag=True, stacked_out=stacked))


def test_spectrum_split_route_matches_plain(dev):
    assert dft_cuda.route(768, 1536) == "split"
    re, im, win = _random_planes(dev, 37, 768)
    K.reset_counters()
    got = dft_cuda.spectrum(re, im, 1536, window=win, with_maxmag=True,
                            stacked_out=True)
    assert K.counters()["launches"]["spectrum"] == 1
    _assert_spectrum_close(got, dft_cuda.spectrum_plain(
        re, im, 1536, window=win, with_maxmag=True, stacked_out=True))


@pytest.mark.parametrize("n_in,n_out,want", [
    (500, 1024, "fft"), (1020, 2048, "fft"), (1000, 1500, "dense"),
    (500, 1500, "dense")])
def test_spectrum_without_a_split_matches_plain(dev, n_in, n_out, want):
    """Zero-fills that have no Cooley-Tukey split: a power-of-two output on
    K1's FFT kernel, the others on the dense route (a matmul summed in
    float64, its own counter, no K1 launch), each against the plain
    version."""
    assert dft_cuda.route(n_in, n_out) == want
    assert not dft_cuda.pallas_split_ok(n_in, n_out)
    re, im, win = _random_planes(dev, 37, n_in)
    K.reset_counters()
    got = dft_cuda.spectrum(re, im, n_out, window=win, with_maxmag=True)
    launches = K.counters()["launches"]
    assert (launches["spectrum"], launches["spectrum_dense"]) == (
        (1, 0) if want == "fft" else (0, 1))
    _assert_spectrum_close(got, dft_cuda.spectrum_plain(
        re, im, n_out, window=win, with_maxmag=True))


def test_spectrum_fft_zero_row_and_tied_maxima(dev):
    """An all-zero row gives a zero spectrum, peak 0 at index 0; a row
    alternating 2, 0 has |X| equal at k = 0 and k = n/2 (stored at n/2 and
    0 after the shift) and nowhere else: the first index, 0, wins."""
    n = 2048
    re, im, _ = _random_planes(dev, 5, n)
    re[1] = 0.0
    im[1] = 0.0
    re[3] = torch.as_tensor(np.tile([2.0, 0.0], n // 2).astype(np.float32),
                            device=dev)
    im[3] = 0.0
    sr, si, mv, mi = dft_cuda.spectrum(re, im, n, with_maxmag=True)
    assert not sr[1].any() and not si[1].any()
    assert float(mv[1]) == 0.0 and int(mi[1]) == 0
    mag = sr[3] * sr[3] + si[3] * si[3]
    assert float(mag[0]) == float(mag[n // 2]) == float(mv[3])
    assert int(mi[3]) == 0
    assert float(mag[1:n // 2].max()) < 1e-6 * float(mv[3])


def _normal_eq_inputs(dev, csv_text, seed=0):
    pk = prior_from_csv_text(csv_text)
    ps = hashable_pmap(pk.pmap)
    re, im, _, _ = _planes(dev)
    b, nf = re.shape[0], pk.n_free
    rng = np.random.default_rng(seed)
    x = np.clip(pk.init_free[None] * rng.uniform(0.8, 1.2, (b, nf)),
                pk.lower, pk.upper).astype(np.float32)
    grids = expand_params_batched(torch.as_tensor(x, device=dev), ps)
    dxdu = torch.as_tensor(rng.uniform(0.5, 1.5, (b, nf)).astype(np.float32),
                           device=dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    return ps, nf, (grids.contiguous(), re, im, t, dxdu)


def _assert_normal_eq_close(got, ref):
    """``(cost, g, h (B, R, R))`` against the plain version's: cost within
    rtol 1e-5; g and H within rtol 1e-4 plus an atol per entry of 1e-3 of
    its Cauchy-Schwarz bound (``sqrt(|H_ii H_jj|)`` for H_ij,
    ``sqrt(|H_ii| cost)`` for g_i), so that rows of every size (shifts
    ~1e6, phases ~1) are held at their own scale."""
    (c, g, h), (c2, g2, h2) = got, ref
    torch.testing.assert_close(c, c2, rtol=1e-5, atol=0)
    d = torch.diagonal(h2, dim1=-2, dim2=-1).double().abs().sqrt()
    for name, x, x2, atol in (
        ("g", g, g2, 1e-3 * d * c2.double().abs().sqrt()[:, None]),
        ("H", h, h2, 1e-3 * d[:, :, None] * d[:, None, :]),
    ):
        err = (x.double() - x2.double()).abs()
        over = err > atol + 1e-4 * x2.double().abs()
        assert not over.any(), (
            f"{name}: {int(over.sum())} entries out of tolerance, max err "
            f"{float(err[over].max()):.3e}")


@pytest.mark.parametrize("prior,factored", [
    ("bench", True), ("bench", False), ("free_g", True), ("free_g", False),
])
def test_normal_equations_kernel_matches_plain(dev, prior, factored):
    csv_text = bi.PK_CSV if prior == "bench" else FREE_G_CSV
    ps, nf, ins = _normal_eq_inputs(dev, csv_text)
    plan = normal_eq_plan(ps, nf, bi.MHZ, factored)
    c, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    c2, g2, h2 = lm_cuda.eq6_normal_equations_plain(*ins, plan)
    _assert_normal_eq_close((c, g, slab_to_bff(h, nf)),
                            (c2, g2, slab_to_bff(h2, nf)))


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
    _assert_bits(x, spd.spd_solve_damped_plain(h, g, lam))
    d = spd.spd_inverse_diag(h, 1e-12)
    _assert_bits(d, spd.spd_inverse_diag_plain(h, 1e-12))
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
    zf = max(bi.ZERO_FILL, n_f)
    sr, si = dft_cuda.spectrum(re, im, zf, window=w)
    step = zf // n_f
    sr = sr[:, ::step][:, :n_f].contiguous()
    si = si[:, ::step][:, :n_f].contiguous()
    for v in nonpositive:
        sr[v] = -sr[v].abs() - 1.0
        si[v] = 0.0
    if zf > bi.ZERO_FILL:  # the same band on the finer grid
        freqs = np.linspace(freqs[0], freqs[-1], zf).astype(np.float32)
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
@pytest.mark.parametrize("b,n_f", [(37, 2048), (37, 512), (5, 1000),
                                 (37, 4096)])
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
    0.01 deg on at least 99 % of voxels, and the all-negative row left
    where it started.  Phases are held by share, as ``chip_smoke.py`` holds
    them: kernel and twin are held to each other by tolerance, not to the
    last bit, and a backtracking accept test turns an ulp into another
    trajectory."""
    sr, si, crd, piv, p, xr = _acme_rows(dev, 256, 2048)
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
    ok = (dp0.abs() <= 0.01) & ((pk[:, 1] - pp[:, 1]).abs() <= 0.01)
    assert float(ok.float().mean()) >= 0.99
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


def test_spd_solve_damped_dense_kernel_matches_plain(dev):
    """K6a against its plain twin and against K3 on the same matrices in
    slab form: bit for bit, with NaN rows exactly at non-SPD voxels."""
    ps, nf, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    _, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    b = g.shape[0]
    h[0, [3, b - 1]] = -1.0
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad[[3, b - 1]] = True
    lam = torch.logspace(-5, -1, b, device=dev)
    dense = slab_to_bff(h, nf)
    x = spd.spd_solve_damped_dense(dense, g, lam)
    assert torch.equal(torch.isnan(x).all(1), bad)
    assert not torch.isnan(x[~bad]).any()
    assert torch.equal(x[~bad], spd.spd_solve_damped_dense_plain(dense, g, lam)[~bad])
    assert torch.equal(x[~bad], spd.spd_solve_damped(h, g, lam)[~bad])


def _spd_dense_case(dev, b, f, seed):
    """b seeded SPD (F, F) matrices (rows six orders of magnitude apart on
    every third voxel, as a Gauss-Newton H), two of them made non-SPD (a
    negative first pivot at voxel 1, a negative last pivot at voxel b - 1),
    with g, lam = logspace(-5, -1) and the slab form (F*F, B)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(b, f, f))
    h = m @ m.transpose(0, 2, 1) + 0.1 * f * np.eye(f)
    d = np.logspace(-3, 3, f)
    h[::3] = d[:, None] * h[::3] * d[None, :]
    h = h.astype(np.float32)
    bad = np.zeros(b, bool)
    bad[[1, b - 1]] = True
    h[1, 0, 0] = -1.0
    h[b - 1, f - 1, f - 1] = -4.0 * abs(h[b - 1, f - 1, f - 1]) - 1.0
    dense = torch.as_tensor(h, device=dev)
    slab = dense.permute(1, 2, 0).reshape(f * f, b).contiguous()
    g = torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32), device=dev)
    lam = torch.logspace(-5, -1, b, device=dev)
    return dense, slab, g, lam, torch.as_tensor(bad, device=dev)


def _assert_bits(got, ref):
    """Equal bit for bit: NaN exactly where ``ref`` is NaN, every other
    entry's float32 bits (the sign of a zero included) the same."""
    assert got.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))


@pytest.mark.parametrize("f", [1, 3, 20, 21, 32])
def test_spd_dense_warp_kernels_match_plain_and_slab(dev, f):
    """K6a/K6b (dense) and K3/K4 (slab, through the shared tile), one warp
    a voxel, rows padded to a multiple of 4, at B = 37, not a multiple of
    a block's 8 (K4: 16) voxels: bit for bit their plain versions and each other
    (K4 with no Tikhonov term against K6b), K4 with the CRLB's 1e-12 ridge
    against its plain version, NaN rows exactly at the non-SPD voxels, one
    launch each."""
    dense, slab, g, lam, bad = _spd_dense_case(dev, 37, f, seed=f)
    K.reset_counters()
    x = spd.spd_solve_damped_dense(dense, g, lam)
    d = spd.spd_inverse_diag_dense(dense)
    x3 = spd.spd_solve_damped(slab, g, lam)
    d4 = spd.spd_inverse_diag(slab, 0.0)
    torch.cuda.synchronize()
    launches = K.counters()["launches"]
    for name in ("spd_solve_damped_dense", "spd_inverse_diag_dense",
                 "spd_solve_damped", "spd_inverse_diag"):
        assert launches[name] == 1, name
    for out in (x, d, x3, d4):
        assert torch.equal(torch.isnan(out).all(1), bad)
        assert not torch.isnan(out[~bad]).any()
    _assert_bits(x, spd.spd_solve_damped_dense_plain(dense, g, lam))
    _assert_bits(d, spd.spd_inverse_diag_dense_plain(dense))
    _assert_bits(x3, spd.spd_solve_damped_plain(slab, g, lam))
    _assert_bits(d4, spd.spd_inverse_diag_plain(slab, 0.0))
    _assert_bits(x3, x)
    _assert_bits(d4, d)
    d4r = spd.spd_inverse_diag(slab, 1e-12)
    assert torch.equal(torch.isnan(d4r).all(1), bad)
    _assert_bits(d4r, spd.spd_inverse_diag_plain(slab, 1e-12))


def test_spd_dense_warp_kernels_take_an_empty_batch_and_refuse_f_33(dev):
    for f in (1, 20, 32):
        dense = torch.zeros((0, f, f), device=dev)
        K.reset_counters()
        x = spd.spd_solve_damped_dense(dense, torch.zeros((0, f), device=dev),
                                       torch.zeros(0, device=dev))
        d = spd.spd_inverse_diag_dense(dense)
        torch.cuda.synchronize()
        assert x.shape == d.shape == (0, f)
        assert not any(K.counters()["launches"].values())
    dense = torch.eye(33, device=dev).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="exceeds"):
        spd.spd_solve_damped_dense(dense, torch.ones((2, 33), device=dev),
                                   torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="exceeds"):
        spd.spd_inverse_diag_dense(dense)


def test_spd_slab_warp_kernels_take_an_empty_batch_and_refuse_f_33(dev):
    for f in (1, 20, 32):
        slab = torch.zeros((f * f, 0), device=dev)
        K.reset_counters()
        x = spd.spd_solve_damped(slab, torch.zeros((0, f), device=dev),
                                 torch.zeros(0, device=dev))
        d = spd.spd_inverse_diag(slab, 1e-12)
        torch.cuda.synchronize()
        assert x.shape == d.shape == (0, f)
        assert not any(K.counters()["launches"].values())
    slab = torch.eye(33, device=dev).reshape(33 * 33, 1).repeat(1, 2)
    with pytest.raises(ValueError, match="exceeds"):
        spd.spd_solve_damped(slab, torch.ones((2, 33), device=dev),
                             torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="exceeds"):
        spd.spd_inverse_diag(slab, 1e-12)


@pytest.mark.parametrize("b", [37, 64])
def test_jac_normal_equations_kernels_match_plain(dev, b):
    """K7 and K12 against their plain twins, each entry at its own rows'
    scale, and K12 equal to K7's active rows bit for bit (one kernel on two
    row sets)."""
    pk = prior_from_csv_text(FREE_G_CSV)
    ps, nf, ins = _normal_eq_inputs(dev, FREE_G_CSV)
    grids, re, im, t = (a[:b].contiguous() if a.dim() == 2 and a.shape[0] > b
                        else a for a in ins[:4])
    k = pk.n_peaks
    active = tuple(j for j in range(5 * k) if j % 5 != 3)  # phases fixed
    c3, g3, h3 = lm_jac_cuda.eq6_normal_equations_v3(grids, re, im, t, k, bi.MHZ)
    c5, g5, h5 = lm_jac_cuda.eq6_normal_equations_v5(grids, re, im, t, k,
                                                     bi.MHZ, active)
    _assert_normal_eq_close((c3, g3, h3), lm_jac_cuda.eq6_normal_equations_v3_plain(
        grids, re, im, t, k, bi.MHZ))
    _assert_normal_eq_close((c5, g5, h5), lm_jac_cuda.eq6_normal_equations_v5_plain(
        grids, re, im, t, k, bi.MHZ, active))
    sel = list(active)
    assert torch.equal(c5, c3)
    assert torch.equal(g5, g3[:, sel])
    assert torch.equal(h5, h3[:, sel][:, :, sel])


def _wide_jac_inputs(dev, n_rows, n_t, b=37):
    """Physical grids, planes and t for the explicit-Jacobian kernel at R =
    ``n_rows``: the bench prior's active rows (20), its 5 peaks' rows (25),
    or 8 peaks (the 5 and copies of the first 3 moved by 0.5 ppm; 40 rows).
    ``n_t`` < 1024 cuts the axis (a ragged last chunk)."""
    ps, _, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    grids, re, im, t = (a[:b] if a.dim() == 2 else a for a in ins[:4])
    k = 5
    rows = tuple(range(25))
    if n_rows == 20:
        from xmris_tpu_torch.fitting.lm import active_param_rows

        rows = tuple(active_param_rows(ps))
    elif n_rows == 40:
        extra = grids[:, :15].clone().view(b, 3, 5)
        extra[:, :, 1] += 0.5
        grids = torch.cat([grids, extra.reshape(b, 15)], 1)
        k, rows = 8, tuple(range(40))
    assert len(rows) == n_rows
    re, im, t = re[:, :n_t], im[:, :n_t], t[:n_t]
    return (grids.contiguous(), re.contiguous(), im.contiguous(),
            t.contiguous()), k, rows


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_t", [1000, 1024])
@pytest.mark.parametrize("n_rows", [20, 25, 40])
def test_tiled_jac_kernel_matches_plain(dev, n_rows, n_t, masked):
    """The register-tiled explicit-Jacobian kernel at R = 20, 25 and 40 (one,
    one and three tile rounds a lane), on a uniform (1024) and a ragged
    (1000) axis: against its plain twin per entry, and, masked (K11), equal
    bit for bit to the unmasked launch on the voxels the mask keeps."""
    ins, k, rows = _wide_jac_inputs(dev, n_rows, n_t)
    b = ins[1].shape[0]
    full = lm_jac_cuda.eq6_normal_equations_v5(*ins, k, bi.MHZ, rows)
    torch.cuda.synchronize()
    _assert_normal_eq_close(full, lm_jac_cuda.eq6_normal_equations_v5_plain(
        *ins, k, bi.MHZ, rows))
    if masked:
        keep = torch.arange(b, device=dev) % 3 != 1
        part = lm_jac_cuda.eq6_normal_equations_v6(*ins, k, bi.MHZ, rows,
                                                   voxel_mask=keep)
        for x, y in zip(part, full):
            assert torch.equal(x[keep], y[keep])


def _phys_inputs(dev, csv_text, b=37):
    """Grids, planes and t of ``_normal_eq_inputs`` for the first ``b``
    voxels, the prior's peak count, active rows and g == 0 flags."""
    from xmris_tpu_torch.fitting.lm import active_param_rows, lorentzian_env_flags

    ps, _, ins = _normal_eq_inputs(dev, csv_text)
    grids, re, im, t = (a[:b].contiguous() if a.dim() == 2 else a
                        for a in ins[:4])
    return ((grids, re, im, t), ps[3], active_param_rows(ps),
            lorentzian_env_flags(ps))


def test_v1_v2_kernels_are_k7(dev):
    """K14 and K13 launch K7's kernel: bit for bit K7, and within the
    per-entry tolerance of their plain versions."""
    ins, k, _, _ = _phys_inputs(dev, FREE_G_CSV)
    c3, g3, h3 = lm_jac_cuda.eq6_normal_equations_v3(*ins, k, bi.MHZ)
    for fn, plain in (
        (lm_jac_cuda.eq6_normal_equations_v1,
         lm_jac_cuda.eq6_normal_equations_v1_plain),
        (lm_jac_cuda.eq6_normal_equations_v2,
         lm_jac_cuda.eq6_normal_equations_v2_plain),
    ):
        c, g, h = fn(*ins, k, bi.MHZ)
        assert torch.equal(c, c3) and torch.equal(g, g3) and torch.equal(h, h3)
        _assert_normal_eq_close((c, g, h), plain(*ins, k, bi.MHZ))


def test_v6_kernel_is_k12_on_unmasked_voxels(dev):
    """K11 without a mask, and on the voxels its mask keeps, equals K12 bit
    for bit; it matches its plain version per entry."""
    ins, k, active, _ = _phys_inputs(dev, bi.PK_CSV)
    b = ins[1].shape[0]
    mask = torch.arange(b, device=dev) % 2 == 0
    ref = lm_jac_cuda.eq6_normal_equations_v5(*ins, k, bi.MHZ, active)
    full = lm_jac_cuda.eq6_normal_equations_v6(*ins, k, bi.MHZ, active)
    part = lm_jac_cuda.eq6_normal_equations_v6(*ins, k, bi.MHZ, active,
                                               voxel_mask=mask)
    for a, f, p in zip(ref, full, part):
        assert torch.equal(f, a) and torch.equal(p[mask], a[mask])
    _assert_normal_eq_close(full, lm_jac_cuda.eq6_normal_equations_v6_plain(
        *ins, k, bi.MHZ, active))


@pytest.mark.parametrize("prior", ["bench", "free_g"])
def test_v7_kernel_matches_plain(dev, prior):
    """K10 (every basis factored on the bench prior; the angle only on the
    free-g prior) against its plain version, and against K11 (the direct
    basis, another rounding) at the same per-entry tolerance."""
    ins, k, active, flags = _phys_inputs(
        dev, bi.PK_CSV if prior == "bench" else FREE_G_CSV)
    assert all(flags) == (prior == "bench")
    got = lm_jac_cuda.eq6_normal_equations_v7(*ins, k, bi.MHZ, active, flags)
    _assert_normal_eq_close(got, lm_jac_cuda.eq6_normal_equations_v7_plain(
        *ins, k, bi.MHZ, active, flags))
    _assert_normal_eq_close(got, lm_jac_cuda.eq6_normal_equations_v6(
        *ins, k, bi.MHZ, active))


def test_v8_kernel_matches_plain(dev):
    """K9 on the bench prior (every g fixed at 0) against its plain version
    and against K12 (the explicit Jacobian) per entry; masked voxels are
    skipped, the others unchanged."""
    ins, k, active, _ = _phys_inputs(dev, bi.PK_CSV)
    got = lm_cuda.eq6_normal_equations_v8(*ins, k, bi.MHZ, active)
    _assert_normal_eq_close(got, lm_cuda.eq6_normal_equations_v8_plain(
        *ins, k, bi.MHZ, active))
    _assert_normal_eq_close(got, lm_jac_cuda.eq6_normal_equations_v5(
        *ins, k, bi.MHZ, active))
    mask = torch.arange(ins[1].shape[0], device=dev) % 3 != 0
    part = lm_cuda.eq6_normal_equations_v8(*ins, k, bi.MHZ, active,
                                           voxel_mask=mask)
    for a, p in zip(got, part):
        assert torch.equal(p[mask], a[mask])


def test_normal_equations_gate_skips_only_rejected_voxels(dev):
    """K2 with ``cost_prev``: the cost bit for bit the ungated one on every
    voxel, g and H on every voxel whose cost improved."""
    ps, nf, ins = _normal_eq_inputs(dev, bi.PK_CSV)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    c, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    b = c.shape[0]
    factor = torch.where(torch.arange(b, device=dev) % 2 == 0, 1.01, 0.99)
    c2, g2, h2 = lm_cuda.eq6_normal_equations(*ins, plan,
                                              cost_prev=(c * factor).contiguous())
    better = c2 < c * factor
    assert torch.equal(c2, c) and 0 < int(better.sum()) < b
    assert torch.equal(g2[better], g[better])
    assert torch.equal(h2[:, better], h[:, better])


def _prior_csv(n_peaks, free_g):
    """A seeded-shape prior of ``n_peaks`` peaks; with ``free_g`` every g is
    free (the t^2 rows, q_n = 2).  Phases are fixed where the free count
    would pass the kernels' 32."""
    shifts = np.linspace(-16.0, 5.0, n_peaks) if n_peaks > 1 else [0.0]

    def row(name, vals):
        return name + "," + ",".join(str(v) for v in vals)

    phase = ("fixed" if n_peaks * (4 + free_g) > lm_cuda.MAX_FREE
             else '"(-180, 180)"')
    return "\n".join([
        "Index," + ",".join(f"P{i}" for i in range(n_peaks)),
        "Initial Values" + "," * n_peaks,
        row("amplitude", [10.0 - i for i in range(n_peaks)]),
        row("chemicalshift", [round(float(x), 2) for x in shifts]),
        row("linewidth", [15.0 + 2 * i for i in range(n_peaks)]),
        row("phase", [0] * n_peaks),
        row("g", [0.1 if free_g else 0] * n_peaks),
        "Bounds" + "," * n_peaks,
        row("amplitude", ['"(0, "'] * n_peaks),
        row("chemicalshift",
            [f'"({x - 0.5:.2f}, {x + 0.5:.2f})"' for x in shifts]),
        row("linewidth", ['"(5.0, 45.0)"'] * n_peaks),
        row("phase", [phase] * n_peaks),
        row("g", ['"(0, 1)"' if free_g else "fixed"] * n_peaks),
    ]) + "\n"


def _shape_inputs(dev, csv_text, n_t, b=37):
    """``_normal_eq_inputs`` for the first ``b`` voxels (a partial last
    block of 8) and the first ``n_t`` samples."""
    ps, nf, ins = _normal_eq_inputs(dev, csv_text)
    grids, re, im, t, dxdu = ins
    return ps, nf, (grids[:b].contiguous(), re[:b, :n_t].contiguous(),
                    im[:b, :n_t].contiguous(), t[:n_t].contiguous(),
                    dxdu[:b].contiguous())


@pytest.mark.parametrize("n_peaks,free_g,factored,n_t", [
    (1, True, True, 1024), (1, False, False, 1000), (8, True, True, 1024),
    (8, True, False, 1000), (8, False, False, 1000), (5, True, False, 1000),
])
def test_normal_equations_shapes_mask_gate(dev, n_peaks, free_g, factored,
                                           n_t):
    """K2 at K = 1 and 8, with a g row (q_n = 2: up to four moment passes)
    and n_t = 1000 on the direct basis, against its plain version per
    entry; masked voxels skipped and the rest bit for bit; the gate's cost
    bit for bit on every voxel, g and H on the improving ones."""
    ps, nf, ins = _shape_inputs(dev, _prior_csv(n_peaks, free_g), n_t)
    plan = normal_eq_plan(ps, nf, bi.MHZ, factored)
    assert plan.q_n == (2 if free_g else 1) and plan.n_peaks == n_peaks
    c, g, h = lm_cuda.eq6_normal_equations(*ins, plan)
    c2, g2, h2 = lm_cuda.eq6_normal_equations_plain(*ins, plan)
    _assert_normal_eq_close((c, g, slab_to_bff(h, nf)),
                            (c2, g2, slab_to_bff(h2, nf)))
    b = c.shape[0]
    mask = torch.arange(b, device=dev) % 3 != 0
    cm, gm, hm = lm_cuda.eq6_normal_equations(*ins, plan, voxel_mask=mask)
    assert torch.equal(cm[mask], c[mask]) and torch.equal(gm[mask], g[mask])
    assert torch.equal(hm[:, mask], h[:, mask])
    factor = torch.where(torch.arange(b, device=dev) % 2 == 0, 1.01, 0.99)
    c_prev = (c * factor).contiguous()
    cg, gg, hg = lm_cuda.eq6_normal_equations(*ins, plan, cost_prev=c_prev)
    better = cg < c_prev
    assert torch.equal(cg, c) and 0 < int(better.sum()) < b
    assert torch.equal(gg[better], g[better])
    assert torch.equal(hg[:, better], h[:, better])


@pytest.mark.parametrize("n_peaks,n_t", [(1, 1024), (8, 1000), (5, 1000)])
def test_v8_kernel_shapes_match_plain(dev, n_peaks, n_t):
    """K9 at K = 1 and 8 (three passes, each re-forming the direct bases)
    and n_t = 1000 against its plain version; masked voxels skipped."""
    from xmris_tpu_torch.fitting.lm import active_param_rows

    ps, _, ins = _shape_inputs(dev, _prior_csv(n_peaks, False), n_t)
    active = active_param_rows(ps)
    args = (*ins[:4], n_peaks, bi.MHZ, active)
    got = lm_cuda.eq6_normal_equations_v8(*args)
    _assert_normal_eq_close(got, lm_cuda.eq6_normal_equations_v8_plain(*args))
    mask = torch.arange(ins[1].shape[0], device=dev) % 3 != 0
    part = lm_cuda.eq6_normal_equations_v8(*args, voxel_mask=mask)
    for a, p in zip(got, part):
        assert torch.equal(p[mask], a[mask])


@pytest.mark.parametrize("spd_pallas", [True, False])
@pytest.mark.parametrize("version", [9, 10])
def test_gated_lm_equals_the_open_lm(dev, version, spd_pallas):
    """gate_rejects runs the v9 loop (K2 with its gate, never K8) on the
    slab and the dense path, and the fit is the ungated one bit for bit."""
    pk = prior_from_csv_text(bi.PK_CSV)
    re, im, _, _ = _planes(dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    lo, hi = (torch.as_tensor(a.astype(np.float32), device=dev)
              for a in (pk.lower, pk.upper))
    kind = torch.as_tensor(pk.kind, device=dev)
    x_t = torch.as_tensor(pk.init_free, dtype=torch.float32, device=dev)
    amp_slots, ls_plan = seed_plan(pk)
    ps = hashable_pmap(pk.pmap)
    u0 = seed_grid(re, im, t, x_t, lo, hi, kind, pmap_static=ps, mhz=bi.MHZ,
                   amp_slots=amp_slots, ls_plan=ls_plan)
    args = (re, im, t, u0, lo, hi, kind, ps, bi.MHZ)
    kw = dict(max_iter=24, spd_pallas=spd_pallas)
    open_ = lm_fit_batched_pallas(*args, **kw)
    K.reset_counters()
    gated = lm_fit_batched_pallas(*args, **kw, kernel_version=version,
                                  gate_rejects=True)
    launches = K.counters()["launches"]
    assert launches["eq6_normal_eq_v9"] > 0 and launches["lm_loop_v10"] == 0
    for a, b in zip(gated, open_):
        assert torch.equal(a, b)


def test_lm_loop_v10_kernel_matches_plain(dev):
    """K8 against its plain twin on the seeded bench voxels: per voxel, x
    within rtol/atol 1e-4 and cost within rtol 1e-5
    (``test_lm_pallas_v10.py:99-111``) for >= 95 % of the voxels (an accept
    test turns last-bit differences of the evaluation into other stopping
    points), and every voxel done."""
    pk = prior_from_csv_text(bi.PK_CSV)
    ps = hashable_pmap(pk.pmap)
    re, im, _, _ = _planes(dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    lo, hi = (torch.as_tensor(a.astype(np.float32), device=dev)
              for a in (pk.lower, pk.upper))
    kind = torch.as_tensor(pk.kind, device=dev)
    x_t = torch.as_tensor(pk.init_free, dtype=torch.float32, device=dev)
    amp_slots, ls_plan = seed_plan(pk)
    u0 = seed_grid(re, im, t, x_t, lo, hi, kind, pmap_static=ps, mhz=bi.MHZ,
                   amp_slots=amp_slots, ls_plan=ls_plan)
    plan = normal_eq_plan(ps, pk.n_free, bi.MHZ, True)
    args = (u0, re, im, t, lo, hi, kind, plan, ps)
    u, cost, n_acc, done, h, trips = lm_loop_cuda.lm_loop_v10(
        *args, max_iter=24, with_trips=True)
    u2, cost2, n_acc2, done2, h2, trips2 = lm_loop_cuda.lm_loop_v10_plain(
        *args, max_iter=24, with_trips=True)
    assert done.all() and done2.all() and (trips > 0).all()
    x, _ = internal_to_external_torch(u, lo, hi, kind)
    x2, _ = internal_to_external_torch(u2, lo, hi, kind)
    ok = ((x - x2).abs() <= 1e-4 + 1e-4 * x2.abs()).all(1)
    ok &= (cost - cost2).abs() <= 1e-5 * cost2.abs()
    assert float(ok.float().mean()) >= 0.95
    assert torch.isfinite(h).all()


@pytest.mark.parametrize("version", [10, 3, 5, 8, 6, 7, 2, 1])
def test_grid_versions_run_on_the_kernels(dev, version):
    """process_grid_planar_raw at every kernel_version but 9 launches every
    kernel of its path (no plain version), recovers the phantom and lands
    within the reference's tolerances of the v9 grid
    (``test_lm_pallas_v10.py`` for 10, ``test_lm_pallas.py:1363`` for the
    others)."""
    fids, weight, freqs = bi.make_inputs(GRID)
    pk = prior_from_csv_text(bi.PK_CSV)
    amp_slots, ls_plan = seed_plan(pk)
    t = np.arange(bi.N_TIME) / bi.SW
    args = grid_inputs_from_numpy(fids, weight, freqs, t, pk.init_free, pk,
                                  dev)
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                         ap_optimizer="grid", spec_layout="stacked")
    kw = dict(cfg=cfg, pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    K.reset_counters()
    out = process_grid_planar_raw(*args, **kw, kernel_version=version)
    torch.cuda.synchronize()
    counts = K.counters()
    path = K.PATHS[f"grid_single_pivot_v{version}"]
    for name in K.LAUNCHES:
        assert (counts["launches"][name] > 0) == (name in path), name
    assert not any(counts["plain_calls"].values())
    *_, x, cost, conv, sds = out
    *_, x9, cost9, _, _ = process_grid_planar_raw(*args, **kw)
    assert conv.all()
    truth = torch.as_tensor(bi.pcr_amplitudes(GRID), device=dev,
                            dtype=torch.float32)
    slot = int(pk.pmap.idx[0])
    assert float(((x[:, slot] - truth).abs() / truth).median()) <= 0.05
    tol = 1e-4 if version == 10 else 0.02
    ok = ((x - x9).abs() <= tol + tol * x9.abs()).all(1)
    assert float(ok.float().mean()) >= 0.95


def test_fit_amares_v10_runs_on_the_kernels(dev):
    """fit_amares(kernel_version=10) launches K8 and K6b only and matches
    the v9 engine's maps."""
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    K.reset_counters()
    ds = fit_amares(da, pk, kernel_version=10, return_curves=False)
    counts = K.counters()
    path = K.PATHS["fit_amares_v10"]
    for name in K.LAUNCHES:
        assert (counts["launches"][name] > 0) == (name in path), name
    assert not any(counts["plain_calls"].values())
    assert ds["fit_converged"].values.all()
    ds9 = fit_amares(da, pk, return_curves=False)
    for name in ("amplitude", "chem_shift", "linewidth"):
        np.testing.assert_allclose(ds[name].values, ds9[name].values,
                                   rtol=2e-3, atol=2e-3)


def test_fit_amares_v8_runs_on_the_kernels(dev):
    """fit_amares(kernel_version=8) launches K9, K6a and K6b only and
    matches the v9 engine's maps."""
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    K.reset_counters()
    ds = fit_amares(da, pk, kernel_version=8, return_curves=False)
    counts = K.counters()
    path = K.PATHS["fit_amares_v8"]
    for name in K.LAUNCHES:
        assert (counts["launches"][name] > 0) == (name in path), name
    assert not any(counts["plain_calls"].values())
    assert ds["fit_converged"].values.all()
    ds9 = fit_amares(da, pk, return_curves=False)
    for name in ("amplitude", "chem_shift", "linewidth"):
        np.testing.assert_allclose(ds[name].values, ds9[name].values,
                                   rtol=2e-3, atol=2e-3)


def test_dense_v9_path_runs_on_the_kernels(dev):
    """v9 without the kernel SPD solve (the dense path: K2's slab made
    dense, the plain ``spd_solve_small`` step, the plain inverse diagonal)
    launches K2 only and lands on the slab path's fit."""
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
    x, cost, conv, sds = seeded_fit_grid_raw(re, im, t, x_t, *bounds, **kw,
                                             spd_pallas=False)
    torch.cuda.synchronize()
    counts = K.counters()
    for name in K.LAUNCHES:
        assert (counts["launches"][name] > 0) == (name == "eq6_normal_eq_v9"), name
    assert not any(counts["plain_calls"].values())
    x2, cost2, _, sds2 = seeded_fit_grid_raw(re, im, t, x_t, *bounds, **kw)
    assert conv.all()
    torch.testing.assert_close(cost, cost2, rtol=1e-4, atol=0)
    torch.testing.assert_close(x, x2, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(sds, sds2, rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("version", [1, 2, 3, 5, 6, 7, 8, 9, 10])
def test_crlb_batched_pallas_runs_on_the_kernels(dev, version):
    """crlb_batched_pallas on the card (the version's normal-equations
    kernel, then K6b) against the same function on the plain versions."""
    pk = prior_from_csv_text(bi.PK_CSV)
    re, im, _, _ = _planes(dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    x = torch.as_tensor(np.clip(pk.init_free[None] * np.random.default_rng(1)
                                .uniform(0.9, 1.1, (re.shape[0], pk.n_free)),
                                pk.lower, pk.upper).astype(np.float32),
                        device=dev)
    ps = hashable_pmap(pk.pmap)
    K.reset_counters()
    sds, s2 = crlb_batched_pallas(re, im, t, x, ps, bi.MHZ,
                                  kernel_version=version)
    torch.cuda.synchronize()
    counts = K.counters()
    evals = f"eq6_normal_eq_v{min(version, 9)}"
    for name in K.LAUNCHES:
        assert (counts["launches"][name] > 0) == (
            name in (evals, "spd_inverse_diag_dense")), name
    sds_p, s2_p = crlb_batched_pallas(re, im, t, x, ps, bi.MHZ,
                                      kernel_version=version, kernels=K.PLAIN)
    torch.testing.assert_close(s2, s2_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(sds, sds_p, rtol=1e-3, atol=0)


def _free_g_array(dev):
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    return XmrArray(fids.reshape(GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                    coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})


def test_free_g_fit_amares_runs_on_the_kernels(dev):
    """A free-g prior (g scan, VARPRO override) through fit_amares: K2 at
    q_n = 2, K3 and K6b launch, no plain version runs, the fit converges,
    and staged planes (pinned memory, side stream, event) give the same
    dataset bit for bit."""
    da = _free_g_array(dev)
    pk = prior_from_csv_text(FREE_G_CSV)
    K.reset_counters()
    ds = fit_amares(da, pk)
    counts = K.counters()
    for name in K.PATHS["fit_amares"]:
        assert counts["launches"][name] > 0, name
    assert not any(counts["plain_calls"].values())
    assert ds["fit_converged"].values.mean() >= 0.95
    staged = stage_device_fids(da)
    assert staged.ready is not None and staged.re.is_cuda
    ds2 = fit_amares(da, pk, device_fids=staged)
    for name in ds.data_vars:
        np.testing.assert_array_equal(ds2[name].values, ds[name].values)


@pytest.mark.parametrize("version", [9, 10])
def test_free_g_grid_runs_on_the_kernels(dev, version):
    """seeded_fit_grid_raw with the g scan on the card: the v9 loop (K2 +
    K3, never K8 at 10) and K4, converged, with the VARPRO override."""
    pk = prior_from_csv_text(FREE_G_CSV)
    fids, weight, freqs = bi.make_inputs(GRID)
    t = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    args = grid_inputs_from_numpy(fids, weight, freqs, t, pk.init_free, pk, dev)
    amp_slots, ls_plan = seed_plan(pk)
    K.reset_counters()
    x, cost, conv, sds = seeded_fit_grid_raw(
        args[0], args[1], *args[4:], pmap_static=hashable_pmap(pk.pmap),
        mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan,
        g_scan=(0.0, 0.2, 0.4, 0.6, 0.8), g_plan=g_seed_plan(pk),
        uniform_t_ok=True, kernel_version=version)
    counts = K.counters()
    want = K.PATHS["seeded_fit"] if version == 9 else (
        "eq6_normal_eq_v9", "spd_solve_damped", "spd_inverse_diag_dense")
    assert {n for n, c in counts["launches"].items() if c} == set(want)
    assert not any(counts["plain_calls"].values())
    assert float(conv.float().mean()) >= 0.95
    assert torch.isfinite(x).all() and torch.isfinite(cost).all()


@pytest.mark.parametrize("mode", ["single", "all"])
def test_de_autophase_runs_on_the_card(dev, mode):
    """autophase's default DE on a CUDA tensor: finite phases, and the same
    seed gives the same result twice on the card."""
    fids, weight, freqs = bi.make_inputs(GRID)
    spec = np.fft.fftshift(np.fft.fft(fids, n=bi.ZERO_FILL, axis=-1), axes=-1)
    da = XmrArray(spec.reshape(GRID + (bi.ZERO_FILL,)),
                  dims=("x", "y", "z", "frequency"),
                  coords={"frequency": Coord("frequency", freqs.astype(np.float64))})
    a = tph.autophase(da, mode=mode, seed=5)
    b = tph.autophase(da, mode=mode, seed=5)
    assert np.isfinite(np.asarray(a.attrs["phase_p0"])).all()
    np.testing.assert_array_equal(a.values, b.values)


def test_default_de_search_runs_on_the_card(dev):
    """``differential_evolution`` with list bounds and no ``device`` searches
    on the card, and the same seed gives the same result twice there."""
    from xmris_tpu_torch.ops.optim import differential_evolution

    def sphere(x):
        return ((x - 0.3) ** 2).sum(-1)

    a = differential_evolution(sphere, [(-2.0, 2.0), (-2.0, 2.0)], seed=0)
    b = differential_evolution(sphere, [(-2.0, 2.0), (-2.0, 2.0)], seed=0)
    assert a.x.device.type == "cuda" and a.fun.device.type == "cuda"
    np.testing.assert_allclose(a.x.cpu().numpy(), 0.3, atol=1e-3)
    np.testing.assert_array_equal(a.x.cpu().numpy(), b.x.cpu().numpy())


def _labeled_bench(grid=GRID):
    fids, _, _ = bi.make_inputs(grid)
    t = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32).astype(np.float64)
    return fids, XmrArray(fids.reshape(grid + (bi.N_TIME,)),
                          dims=("x", "y", "z", "time"),
                          coords={"time": Coord("time", t)})


@pytest.mark.parametrize("autophase,path", [
    ("single", "mrsi_pipeline"), ("all", "mrsi_pipeline_per_voxel")])
def test_mrsi_pipeline_runs_on_the_kernels(dev, autophase, path):
    """mrsi_pipeline on the card by default: one launch of each kernel of
    its path, no plain version, and bit for bit its raw pipeline."""
    from xmris_tpu_torch.parallel import mrsi_pipeline
    from xmris_tpu_torch.parallel.pipeline import spectral_constants

    fids, da = _labeled_bench()
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase=autophase,
                         ap_optimizer="grid")
    K.reset_counters()
    out = mrsi_pipeline(da, cfg=cfg)
    torch.cuda.synchronize()
    counts = K.counters()
    assert {n for n, c in counts["launches"].items() if c} == set(K.PATHS[path])
    assert all(counts["launches"][n] == 1 for n in K.PATHS[path])
    assert not any(counts["plain_calls"].values())
    _, weight, freqs = spectral_constants(da.coords["time"].values, cfg)
    sr, si, (p0, _, piv) = spectral_pipeline_planar_raw(
        *(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                          device=dev)
          for a in (fids.real, fids.imag, weight, freqs)), cfg)
    spec = out.values.reshape(len(fids), bi.ZERO_FILL)
    np.testing.assert_array_equal(spec.real, sr.cpu().numpy())
    np.testing.assert_array_equal(spec.imag, si.cpu().numpy())
    np.testing.assert_array_equal(
        np.ravel(out.attrs["phase_p0"]).astype(np.float32),
        np.ravel(p0.cpu().numpy()))
    np.testing.assert_array_equal(
        np.ravel(out.attrs["phase_pivot"]).astype(np.float32),
        np.ravel(piv.cpu().numpy()))


@pytest.mark.parametrize("polish", ["newton", "bfgs"])
def test_second_order_polish_runs_on_the_card(dev, polish):
    """The per-voxel grid search with the Newton / BFGS polish on the card:
    no K5 launch, phases in the box, the scores as the reference's own
    polishes stand to its gd (median within x1.001 of gd's, at most one
    voxel above x1.02)."""
    re, im, weight, freqs = _planes(dev)
    scores = {}
    for pol in ("gd", polish):
        cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                             ap_optimizer="grid", ap_polish=pol)
        K.reset_counters()
        _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(re, im, weight,
                                                           freqs, cfg)
        torch.cuda.synchronize()
        assert K.counters()["launches"]["acme_polish"] == 0
        assert float(p0.abs().max()) <= 180.0
        assert float(p1.abs().max()) <= 4000.0
        sr, si = dft_cuda.spectrum(re, im, bi.ZERO_FILL,
                                   window=weight[:bi.N_TIME].contiguous())
        d = tph._phased_real_planar(sr.double(), si.double(), freqs.double(),
                                    p0.double(), p1.double(),
                                    piv.double()[:, None],
                                    float(freqs[-1] - freqs[0]))
        scores[pol] = tph.acme_score_raw(d)
    r = scores[polish] / scores["gd"]
    assert float(r.median()) <= 1.001
    assert int((scores[polish] > scores["gd"] * 1.02 + 1e-9).sum()) <= 1


def test_asls_cr_on_the_card_matches_the_cpu_scan(dev):
    """solver="auto" is CR on the card (float64), within 1e-7 max|z| of the
    scan on the CPU; an explicit "scan" runs on the card too."""
    from xmris_tpu_torch.ops.baseline import als_baseline_batched

    rng = np.random.default_rng(0)
    x = np.linspace(-1.0, 1.0, 512)
    rows = (2.0 + 1.5 * x + 5.0 * np.exp(-((x - rng.uniform(-0.5, 0.5, (8, 1)))
                                          ** 2) / 2e-4)
            + rng.normal(0.0, 0.02, (8, 512)))
    z = als_baseline_batched(torch.as_tensor(rows, device=dev), 1e5, 0.001, 10)
    z_cpu = als_baseline_batched(torch.as_tensor(rows), 1e5, 0.001, 10)
    assert z.device.type == "cuda" and z.dtype == torch.float64
    err = float((z.cpu() - z_cpu).abs().max())
    assert err <= 1e-7 * float(z_cpu.abs().max())
    z_scan = als_baseline_batched(torch.as_tensor(rows[:2, :128], device=dev),
                                  1e5, 0.001, 3, solver="scan")
    ref = als_baseline_batched(torch.as_tensor(rows[:2, :128]), 1e5, 0.001, 3)
    np.testing.assert_allclose(z_scan.cpu().numpy(), ref.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_slice_entry_points_default_to_the_card(dev):
    """mrsi_pipeline, baseline_als and als_baseline_batched with no device
    run on the card (an array payload comes back as an array)."""
    from xmris_tpu_torch.ops.baseline import als_baseline_batched, baseline_als
    from xmris_tpu_torch.parallel import mrsi_pipeline

    _, da = _labeled_bench((2, 2, 2))
    K.reset_counters()
    out = mrsi_pipeline(da, cfg=PipelineConfig(zero_fill_to=bi.ZERO_FILL,
                                               autophase="none"))
    torch.cuda.synchronize()
    assert K.counters()["launches"]["spectrum"] == 1
    assert isinstance(out.data, np.ndarray)
    rows = np.asarray(out.values.real.reshape(8, -1), dtype=np.float64)
    assert als_baseline_batched(rows, 1e4, 0.01, 2).device.type == "cuda"
    base = baseline_als(out.isel(x=0))
    assert isinstance(base.data, np.ndarray) and np.isfinite(base.values).all()


# ---------------------------------------------------------------------------
# Slice 12: k-space recon, the accessor chain, on the card
# ---------------------------------------------------------------------------


def _mrsi_kspace(grid=GRID, n_coils=4):
    """The bench FIDs over ``grid`` times unit-RSS coil maps, to centered
    k-space over (x, y, z): (coil, kx, ky, kz, time) complex64."""
    fids, _, _ = bi.make_inputs(grid)
    f = fids.reshape(grid + (bi.N_TIME,)).astype(np.complex128)
    maps = bi.unit_rss_coil_maps(grid, n_coils)
    k = bi.centered_fftn(maps[..., None] * f[None], (1, 2, 3))
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(k.astype(np.complex64), dims=("coil", "kx", "ky", "kz", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    return da, maps, f


def test_recon_on_tensor_payloads_stays_on_the_card(dev):
    """kspace_to_image -> sense_combine with the true maps recovers the FIDs
    (1e-5 of max|FID|), rss_reconstruct gives |FID|, and the maps estimate
    from time 0 matches the float64 host estimate, all as tensors on the
    card."""
    from xmris_tpu_torch.recon import (
        estimate_sensitivities,
        kspace_to_image,
        rss_reconstruct,
        sense_combine,
    )

    da, maps, f = _mrsi_kspace()
    k = da.to(dev)
    img = kspace_to_image(k)
    assert img.dims == ("coil", "x", "y", "z", "time") and img.data.is_cuda
    m = torch.as_tensor(maps.astype(np.complex64), device=dev)
    sens = XmrArray(m[..., None].expand(img.shape), dims=img.dims)
    rec = sense_combine(img, sens)
    assert rec.data.is_cuda and rec.data.dtype == torch.complex64
    scale = float(np.abs(f).max())
    assert float(np.abs(rec.values - f).max()) <= 1e-5 * scale
    rss = rss_reconstruct(k)
    assert rss.data.is_cuda and rss.data.dtype == torch.float32
    assert float(np.abs(rss.values - np.abs(f)).max()) <= 1e-5 * scale
    k0 = da.isel(time=0)
    est = estimate_sensitivities(k0.to(dev))
    assert est.data.is_cuda
    host = estimate_sensitivities(k0.astype(np.complex128), device="cpu")
    np.testing.assert_allclose(est.values, host.values, atol=1e-4)


def test_staged_recon_defaults_to_the_card(dev):
    """A numpy payload with no device is staged on the card and comes back
    as the host array of the reference's dtype, equal to the host's in the
    object (outside it the low-resolution image is dark, and the unit-RSS
    division turns float32 rounding into any direction)."""
    from xmris_tpu_torch.recon import estimate_sensitivities, sense_reconstruct

    k, phantom, _ = bi.coil_kspace_phantom((64, 64), 4)
    da = XmrArray(k.astype(np.complex64), dims=("coil", "ky", "kx"))
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.max_memory_allocated(dev)
    est = estimate_sensitivities(da)
    assert torch.cuda.max_memory_allocated(dev) > before
    assert isinstance(est.data, np.ndarray) and est.dtype == np.complex64
    host = estimate_sensitivities(da, device="cpu")
    mask = phantom > 0.5
    np.testing.assert_allclose(est.values[:, mask], host.values[:, mask], atol=1e-5)
    out = sense_reconstruct(da, calib_frac=0.4)
    assert isinstance(out.data, np.ndarray) and out.dtype == np.complex64


def test_config3_recon_on_the_card(dev):
    """BASELINE config 3 at 8 x 256 x 256 on the card: RSS within 1e-5 of a
    float64 numpy recon, SENSE within tests/test_recon.py's 5 % and the
    adaptive combine within its 2 % of RSS inside the object."""
    from xmris_tpu_torch.recon import kspace_to_image, rss_reconstruct, sense_reconstruct
    from xmris_tpu_torch.recon.sense import adaptive_combine_planar_raw

    k, phantom, sens = bi.coil_kspace_phantom((256, 256), 8)
    da = XmrArray(k.astype(np.complex64), dims=("coil", "ky", "kx")).to(dev)
    img64 = np.fft.fftshift(np.fft.ifftn(np.fft.ifftshift(k, axes=(1, 2)),
                                         axes=(1, 2), norm="ortho"), axes=(1, 2))
    rss64 = np.sqrt(np.sum(np.abs(img64) ** 2, axis=0))
    rss = rss_reconstruct(da)
    assert rss.data.is_cuda
    assert float(np.abs(rss.values - rss64).max()) <= 1e-5 * float(rss64.max())
    out = sense_reconstruct(da, calib_frac=0.4)
    assert out.data.is_cuda
    mask = phantom > 0.5
    expected = phantom * np.sqrt(np.sum(np.abs(sens) ** 2, axis=0))
    rel = np.abs(np.abs(out.values) - expected)[mask] / expected[mask].max()
    assert rel.mean() < 0.05
    img = kspace_to_image(da).data
    o_re, o_im = adaptive_combine_planar_raw(img.real, img.imag)
    assert o_re.is_cuda
    mag = torch.sqrt(o_re**2 + o_im**2).cpu().numpy()
    np.testing.assert_allclose(mag[mask], rss64[mask], rtol=0.02)


def test_accessor_chain_runs_on_the_card(dev, tmp_path):
    """The Quick Start on a tensor payload with the default device: the
    result stays on the card with its peak at the simulated 4.7 ppm; and
    ``.xmr.fit_amares`` on the labeled bench grid launches its kernels."""
    import xmris_tpu_torch as xt

    fid = xt.simulate_fid(amplitudes=[10.0, 3.0], chemical_shifts=[4.7, 1.3],
                          reference_frequency=127.6, carrier_ppm=4.7,
                          spectral_width=5000.0, n_points=1024,
                          dampings=[30.0, 20.0], target_snr=50.0, seed=0)
    out = (fid.to(dev).xmr.zero_fill(target_points=2048).xmr.apodize_exp(lb=5.0)
           .xmr.to_spectrum().xmr.autophase().xmr.to_ppm())
    assert out.data.is_cuda
    ppm = out.coords["chemical_shift"].values
    assert abs(ppm[int(np.argmax(np.abs(out.values)))] - 4.7) <= abs(ppm[1] - ppm[0])
    path = tmp_path / "pk.csv"
    path.write_text(bi.PK_CSV)
    _, da = _labeled_bench()
    da = da.assign_attrs(MHz=bi.MHZ).to(dev)
    K.reset_counters()
    ds = da.xmr.fit_amares(path)
    torch.cuda.synchronize()
    counts = K.counters()
    for name in K.PATHS["fit_amares"]:
        assert counts["launches"][name] > 0, name
    assert float(ds["fit_converged"].values.mean()) >= 0.95


# ---------------------------------------------------------------------------
# The voxel mesh on one card (cuda:0 named twice) and the serve CLI
# ---------------------------------------------------------------------------


def _mesh_grid_case(dev):
    from xmris_tpu_torch.fitting.amares import template_optimum

    fids, weight, freqs = bi.make_inputs(GRID)
    pk = prior_from_csv_text(bi.PK_CSV)
    t = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_t = template_optimum(fids, pk, torch.as_tensor(t, device=dev), bi.MHZ)
    args = grid_inputs_from_numpy(fids, weight, freqs, t, x_t, pk, dev)
    amp_slots, ls_plan = seed_plan(pk)
    kw = dict(pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    return pk, args, kw


def _assert_same_bits(got, ref):
    for a, b in zip(got, ref):
        if isinstance(a, tuple):
            _assert_same_bits(a, b)
        else:
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("autophase", ["single", "all"])
def test_sharded_grid_equals_the_one_device_program(dev, autophase):
    """``process_grid_sharded`` over ``Mesh([cuda:0] * 2)``: every output
    bit for bit the one-device program's (at 32 voxels a shard the seed's
    matrix products round as at 64); K1 and K4 (K5 per voxel) launch once
    per shard, and no plain version runs."""
    from xmris_tpu_torch.parallel.mesh import Mesh
    from xmris_tpu_torch.parallel.process import process_grid_sharded

    _, args, kw = _mesh_grid_case(dev)
    cfg = (PipelineConfig(zero_fill_to=bi.ZERO_FILL, ap_optimizer="grid",
                          spec_layout="stacked") if autophase == "single" else
           PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                          ap_optimizer="grid"))
    one = process_grid_planar_raw(*args, cfg=cfg, **kw)
    K.reset_counters()
    sh = process_grid_sharded(*args, mesh=Mesh([dev] * 2), cfg=cfg, **kw)
    torch.cuda.synchronize()
    counts = K.counters()
    assert not any(counts["plain_calls"].values())
    launches = counts["launches"]
    assert launches["spectrum"] == 2 and launches["spd_inverse_diag"] == 2
    assert launches["acme_polish"] == (2 if autophase == "all" else 0)
    assert launches["eq6_normal_eq_v9"] >= 2
    _assert_same_bits(sh, one)


@pytest.mark.parametrize("version", [9, 8, 10])
def test_sharded_lm_equals_the_single_launch(dev, version):
    """``lm_fit_batched_pallas_sharded`` over ``Mesh([cuda:0] * 2)`` from
    the grid seeds: x, cost, trips, flags and the Hessian bit for bit the
    single launch's (the kernels work voxel by voxel)."""
    from xmris_tpu_torch.parallel import lm_fit_batched_pallas_sharded
    from xmris_tpu_torch.parallel.mesh import Mesh

    pk, args, kw = _mesh_grid_case(dev)
    re, im, _, _, t, x_t, lower, upper, kind = args
    u0 = seed_grid(re, im, t, x_t, lower, upper, kind, pmap_static=kw["pmap_static"],
                   mhz=bi.MHZ, amp_slots=kw["amp_slots"], ls_plan=kw["ls_plan"])
    lm_args = (re, im, t, u0, lower, upper, kind, kw["pmap_static"], bi.MHZ)
    one = lm_fit_batched_pallas(*lm_args, max_iter=24, kernel_version=version,
                                return_hessian=True)
    K.reset_counters()
    sh = lm_fit_batched_pallas_sharded(*lm_args, mesh=Mesh([dev] * 2), max_iter=24,
                                       kernel_version=version, return_hessian=True)
    torch.cuda.synchronize()
    assert not any(K.counters()["plain_calls"].values())
    if version == 10:
        assert K.counters()["launches"]["lm_loop_v10"] == 2
    _assert_same_bits(sh, one)


def test_fit_amares_mesh_equals_one_device(dev):
    """``fit_amares(mesh=Mesh([cuda:0] * 2))`` on 64 voxels: the maps bit
    for bit the one-device fit's, one K6b launch on the gathered Hessian."""
    from xmris_tpu_torch.parallel.mesh import Mesh

    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    one = fit_amares(da, pk, return_curves=False)
    K.reset_counters()
    sh = fit_amares(da, pk, return_curves=False, mesh=Mesh([dev] * 2))
    assert K.counters()["launches"]["spd_inverse_diag_dense"] == 1
    for name in ("amplitude", "chem_shift", "linewidth", "phase", "crlb", "snr",
                 "fit_converged"):
        np.testing.assert_array_equal(sh[name].values, one[name].values, err_msg=name)


def test_a_failing_shard_fails_the_call_on_the_card(dev):
    """Shards on cuda:0 run in turn under it; a shard that raises fails
    the call."""
    from xmris_tpu_torch.parallel.mesh import Mesh, map_shards

    def fn(x):
        assert torch.cuda.current_device() == x.device.index
        if float(x[0]) == 4.0:
            raise RuntimeError("shard 2 failed")
        return x * 2

    x = torch.arange(8.0, device=dev)
    with pytest.raises(RuntimeError, match="shard 2"):
        map_shards(fn, Mesh([dev] * 4), (x,))
    assert torch.equal(map_shards(fn, Mesh([dev] * 4), (x + 1,)), (x + 1) * 2)


def test_serve_once_on_the_card(dev, tmp_path, capsys):
    """``serve --once`` with the default device on two small grids, serial
    and ``--pipeline`` (planes staged on the card one grid ahead): the same
    records, each grid's maps bit for bit ``fit_amares``'s on the card."""
    import json

    from xmris_tpu_torch.interop.io import load_dataset_npz, save_npz
    from xmris_tpu_torch.runtime.cli import serve_main

    _, da = _labeled_bench()
    da = da.assign_attrs(MHz=bi.MHZ)
    pk_path = tmp_path / "pk.csv"
    pk_path.write_text(bi.PK_CSV)
    watch = tmp_path / "in"
    watch.mkdir()
    for i in range(2):
        save_npz(da, watch / f"g{i}.npz")
    want = fit_amares(da, prior_from_csv_text(bi.PK_CSV), return_curves=False)
    capsys.readouterr()
    runs = {}
    for mode, extra in (("serial", []), ("pipeline", ["--pipeline"])):
        rc = serve_main([str(watch), str(pk_path), "-o", str(tmp_path / mode),
                         "--once"] + extra)
        records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                   if ln.startswith("{")]
        assert [r["status"] for r in records] == ["ok", "ok"]
        for r in records:
            got = load_dataset_npz(tmp_path / mode / r["output"])
            for name in ("amplitude", "crlb", "fit_converged"):
                np.testing.assert_array_equal(got[name].values, want[name].values)
            r.pop("wall_s")
        runs[mode] = (rc, records)
    assert runs["serial"] == runs["pipeline"]


# ---------------------------------------------------------------------------
# The visualization layer (item 13) on CUDA payloads
# ---------------------------------------------------------------------------


def _viz_payloads():
    """A fit-like dataset over (voxel, time) x Metabolite and its spectra,
    complex128, one CRLB NaN and one above 20 %."""
    from xmris_tpu_torch.core.array import XmrDataset

    rng = np.random.default_rng(14)
    t = np.arange(256) / 4000.0
    fids = (rng.normal(size=(6, 256)) + 1j * rng.normal(size=(6, 256))) * 0.1
    fids += np.exp((2j * np.pi * 300.0 - 30.0) * t) * np.arange(1, 7)[:, None]
    fit = np.exp((2j * np.pi * 300.0 - 30.0) * t) * np.arange(1, 7)[:, None]
    attrs = {"MHz": 100.0, "reference_frequency": 100.0, "carrier_ppm": 4.7}

    def arr(x, dims, **kw):
        return XmrArray(x, dims=dims, **kw)

    fid_da = arr(fids, ("voxel", "time"), coords={"time": Coord("time", t)},
                 attrs=attrs)
    metab = {"Metabolite": np.array(["a", "b"], dtype=object)}
    crlb = rng.uniform(1.0, 10.0, (6, 2))
    crlb[2, 1], crlb[4, 0] = np.nan, 25.0
    ds = XmrDataset({
        "raw_data": fid_da,
        "fit_data": fid_da.copy(data=fit),
        "residuals": fid_da.copy(data=fids - fit),
        "crlb": arr(crlb, ("voxel", "Metabolite"), coords=metab),
        "amplitude": arr(rng.uniform(1.0, 5.0, (6, 2)), ("voxel", "Metabolite"),
                         coords=metab)})
    return fid_da, fid_da.xmr.to_spectrum(), ds


def _on(ds, device):
    from xmris_tpu_torch.core.array import XmrDataset

    return XmrDataset({k: v.to(device) for k, v in ds.items()}, ds.attrs)


def test_drawn_host_data_on_the_card_is_the_cpu_copys(dev, monkeypatch):
    """What each figure and widget draws (``visualization._host``, which
    runs without matplotlib and traitlets) is the same from a CUDA payload
    as from its CPU copy, with one device-to-host copy per drawn array."""
    from xmris_tpu_torch.core import array as carrier
    from xmris_tpu_torch.visualization import _host

    fid_da, spec, ds = _viz_payloads()
    copies = {"n": 0}
    to_numpy = carrier._to_numpy

    def counting(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            copies["n"] += 1
        return to_numpy(x)

    monkeypatch.setattr(carrier, "_to_numpy", counting)
    scale = float(np.abs(np.fft.fft(fid_da.values, norm="ortho")).max())
    calls = [
        ("qc_panels", lambda d: _host.qc_panels(d, "voxel", 4), ds, 4),
        ("trajectory_lines", lambda d: _host.trajectory_lines(d, "voxel"), ds, 2),
        ("stack_view", lambda d: _host.stack_view(d), spec.real, 1),
        ("phase_traits", _host.phase_traits, spec.isel(voxel=3), 1),
        ("scroll_traits", lambda d: _host.scroll_traits(d, part="abs"), spec, 1),
        ("apodize_traits", _host.apodize_traits, fid_da.isel(voxel=1)
         .isel(time=slice(0, 200)), 1),
    ]
    for name, fn, payload, bound in calls:
        card = _on(payload, dev) if hasattr(payload, "data_vars") else payload.to(dev)
        copies["n"] = 0
        got = fn(card)
        assert copies["n"] <= bound, (name, copies["n"])
        want = fn(_on(payload, "cpu") if hasattr(payload, "data_vars")
                  else payload.to("cpu"))
        if name == "qc_panels":
            assert list(got.indices) == list(want.indices)
            np.testing.assert_array_equal(got.freq, want.freq)
            np.testing.assert_array_equal(got.crlb.values, want.crlb.values)
            for part in ("raw", "fit", "res"):
                np.testing.assert_allclose(getattr(got, part).values,
                                           getattr(want, part).values,
                                           rtol=0, atol=1e-12 * scale)
        elif name == "trajectory_lines":
            for (m, a, h), (m2, a2, h2) in zip(got.lines, want.lines):
                assert m == m2
                np.testing.assert_array_equal(a, a2)
                np.testing.assert_array_equal(h, h2)
        elif name == "stack_view":
            np.testing.assert_array_equal(got.values, want.values)
            assert got[:2] == want[:2]
        else:
            assert got == want, name


def test_plots_and_widgets_on_the_card_draw_the_cpu_drawing(dev):
    """Each plot and widget from a CUDA payload draws what its CPU copy
    draws: exactly, but for the QC grid's spectra (cuFFT against the CPU
    FFT) at 1e-12 of max|S|.  Needs the viz and widgets extras."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("traitlets")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fid_da, spec, ds = _viz_payloads()
    scale = float(np.abs(np.fft.fft(fid_da.values, norm="ortho")).max())

    def lines(obj):
        fig = obj if isinstance(obj, matplotlib.figure.Figure) else obj.get_figure()
        out = [np.asarray(ln.get_xydata()) for ax in fig.axes for ln in ax.lines]
        out += [np.asarray(p.vertices) for ax in fig.axes for c in ax.collections
                for p in c.get_paths()]
        out += [np.asarray(c.get_array()) for ax in fig.axes for c in ax.collections
                if c.get_array() is not None]
        faces = [ax.get_facecolor() for ax in fig.axes]
        plt.close(fig)
        return out, faces

    for draw, payload, atol in (
            (lambda d: d.xmr.plot.qc_grid("voxel"), ds, 1e-12 * scale),
            (lambda d: d.xmr.plot.trajectory("voxel"), ds, 0.0),
            (lambda d: d.xmr.plot.waterfall(), spec.real, 0.0),
            (lambda d: d.xmr.plot.carpet(), spec.real, 0.0)):
        card = _on(payload, dev) if hasattr(payload, "data_vars") else payload.to(dev)
        got, got_faces = lines(draw(card))
        want, want_faces = lines(draw(payload))
        assert got_faces == want_faces and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    for make, payload in (
            (lambda d: d.xmr.widget.phase_spectrum(), spec.isel(voxel=2)),
            (lambda d: d.xmr.widget.scroll_spectra(), spec),
            (lambda d: d.xmr.widget.apodize(), fid_da.isel(voxel=0))):
        assert make(payload.to(dev)).trait_values() == make(payload).trait_values()


@contextlib.contextmanager
def _tf32_on():
    """TF32 on for float32 matmuls around the body, the flags restored
    after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


@pytest.mark.parametrize("variant", ["einsum", "flat", "block", "full", "rect"])
def test_matmul_dft_on_the_card_ignores_tf32(dev, variant):
    """The matmul DFT in float32 on the card against numpy's float64 FFT at
    5e-6 max|S| (``tests/test_planar.py``'s float32 bar), forward and
    inverse, and bit for bit the same with TF32 turned on."""
    from xmris_tpu_torch.ops.kernels import dft

    rng = np.random.default_rng(4)
    for n in (13, 100, 2048):
        z = rng.normal(size=(8, n)) + 1j * rng.normal(size=(8, n))
        xr, xi = (torch.as_tensor(a.astype(np.float32), device=dev)
                  for a in (z.real, z.imag))
        for inverse in ((False,) if variant == "rect" else (False, True)):
            if variant == "rect":
                def run():
                    return dft.dft_rect_shifted_planar(xr, xi, 2 * n)
                want = np.fft.fftshift(np.fft.fft(z, 2 * n, norm="ortho"),
                                       axes=-1)
            else:
                def run():
                    return dft.dft_planar(xr, xi, n, inverse=inverse,
                                          variant=variant)
                want = (np.fft.ifft if inverse else np.fft.fft)(z, norm="ortho")
            got = run()
            with _tf32_on():
                got_tf32 = run()
            torch.cuda.synchronize()
            assert got[0].is_cuda and got[0].dtype == torch.float32
            err = np.abs(got[0].double().cpu().numpy()
                         + 1j * got[1].double().cpu().numpy() - want).max()
            assert err <= 5e-6 * np.abs(want).max(), (n, inverse, err)
            for a, b in zip(got, got_tf32):
                assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["fused", "einsum", "full"])
def test_grid_at_a_matmul_variant_launches_no_spectrum_kernel(dev, variant):
    """process_grid_planar_raw at a matmul ``dft_variant``: the fit's
    kernels and no K1; the spectra within 5e-6 max|S| of K1's run."""
    re, im, w, f = _planes(dev)
    fids, _, _ = bi.make_inputs(GRID)
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    amp_slots, ls_plan = seed_plan(pk)
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    from xmris_tpu_torch.fitting.amares import template_optimum

    xt = template_optimum(fids, pk, torch.from_numpy(t_np).to(dev), bi.MHZ)
    args = grid_inputs_from_numpy(fids, np.asarray(w.cpu()), np.asarray(f.cpu()),
                                  t_np, xt, pk, dev)
    kw = dict(pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    base = dict(zero_fill_to=bi.ZERO_FILL, autophase="none")
    ref = process_grid_planar_raw(*args, cfg=PipelineConfig(**base), **kw)
    K.reset_counters()
    got = process_grid_planar_raw(
        *args, cfg=PipelineConfig(**base, dft_variant=variant), **kw)
    torch.cuda.synchronize()
    counts = K.counters()
    path = K.PATHS["grid_single_pivot_dft"]
    assert {n for n, c in counts["launches"].items() if c} == set(path)
    assert not any(counts["plain_calls"].values())
    scale = float(torch.maximum(ref[0].abs().max(), ref[1].abs().max()))
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6 * scale)
    # The fit reads the FIDs, not the spectra (repeated grids may differ
    # in the last bits: test_torch_slice's bars).
    torch.testing.assert_close(got[3], ref[3], rtol=2e-3, atol=2e-3)
