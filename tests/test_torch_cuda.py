"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere (the
kernels have no CPU mode; on the CPU the wrappers run the plain versions,
which ``test_torch_kernels.py`` holds against the JAX package).  The module
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the reference tests' own (see ``test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.fitting.amares import seed_plan, seeded_fit_grid_raw
from xmris_tpu_torch.fitting.lm import (
    _expand_params_batched,
    hashable_pmap,
    normal_eq_plan,
)
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import dft_cuda, lm_cuda, spd
from xmris_tpu_torch.ops.phasing import (
    _grid_phase_search,
    grid_phase_search_graphed,
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
