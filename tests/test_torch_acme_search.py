"""K5s's plain twin (``acme_cuda.acme_search_plain``): the single-pivot
grid search in the kernel's arithmetic, against the torch search and the
JAX package's.

The scan must pick the torch scan's winner at ``cand_chunk`` 16 (ties to
the first candidate, a chunk that holds a NaN never replaces the best, a
stage with no finite score keeps 0), shown with planted scores on both
sides and with the real scores on real rows.  The searched phases are held
to the JAX package's single-pivot search by the ACME score they reach, as
``test_torch_slice.py`` holds the torch search (1e-5 relative), on the
bench pivot row and on rows turned by a random receiver phase.  On the CPU
``_solve_phase_on_row`` keeps the torch search, bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.planar_pipeline import (
    _solve_phase_on_row as ref_solve_phase,
)

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops import phasing
from xmris_tpu_torch.ops.kernels import acme_cuda, dft_cuda
from xmris_tpu_torch.ops.phasing import (
    _de_phase_search,
    _grid_phase_search,
    _phased_real_planar,
    acme_score_raw,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import _solve_phase_on_row
from xmris_tpu_torch.runtime import profiling


@pytest.fixture(scope="module")
def spectra():
    """Unphased flat bench spectra (32, 2048) of the plain K1, the freqs
    and the pivot ``(voxel, bin)`` of the loudest voxel."""
    fids, w, f = bi.make_inputs((4, 4, 2))
    re, im = (torch.as_tensor(np.ascontiguousarray(x))
              for x in (fids.real, fids.imag))
    sr, si, mv, mi = dft_cuda.spectrum_plain(
        re, im, bi.ZERO_FILL, window=torch.as_tensor(w[: bi.N_TIME]),
        with_maxmag=True)
    v = int(torch.argmax(mv))
    return sr, si, torch.as_tensor(f), (v, int(mi[v]))


def _turned(spectra, seed):
    """The pivot row as a (1, n) batch, turned by the phases (p0, p1) drawn
    from ``seed`` (p0 in +-180, p1 in +-2000 deg; seed None: not turned)."""
    sr, si, f, (v, k) = spectra
    row = sr[v].double() + 1j * si[v].double()
    if seed is not None:
        rng = np.random.default_rng(seed)
        p0, p1 = rng.uniform(-180, 180), rng.uniform(-2000, 2000)
        fd = f.double()
        phi = torch.deg2rad(torch.tensor(p0) + p1 * (fd - fd[k])
                            / (fd[-1] - fd[0]))
        row = row * torch.exp(-1j * phi)
    return (row.real.float()[None].contiguous(),
            row.imag.float()[None].contiguous(), f, k)


def _peak(k):
    return torch.tensor(0), torch.tensor(k)


def _score(re, im, f, k, p):
    """ACME score in float64 of a (1, n) row at the (1, 2) phases."""
    fd = f.double()
    d = _phased_real_planar(re[0].double(), im[0].double(), fd,
                            p[0, 0].double(), p[0, 1].double(), fd[k],
                            float(fd[-1] - fd[0]))
    return float(acme_score_raw(d))


ROWS = {"bench": None, "turned_1": 1, "turned_2": 2}


def test_the_search_constants_are_the_torch_searchs():
    meshes = phasing._search_constants(torch.float32, "cpu")
    for (first, step, count), want in zip(acme_cuda.SEARCH_MESHES, meshes):
        got = first + step * torch.arange(count, dtype=torch.float32)
        assert torch.equal(got, want)
    assert acme_cuda.SEARCH_ITERS == phasing.POLISH_ITERS
    assert (phasing.N_P0, phasing.N_P1) == tuple(
        m[2] for m in acme_cuda.SEARCH_MESHES[:2])
    for n in (2, 511, 512, 1000, 1023, 1024, 1535, 2048, 4096):
        for p0_only in (False, True):
            dec, coarse, fine = acme_cuda.search_plan(n, p0_only)
            assert dec == max(1, n // 512)
            two_phase = p0_only and dec > 1
            assert fine == (max(phasing.POLISH_ITERS // 3, 8) if two_phase
                            else phasing.POLISH_ITERS)
            assert coarse + fine == phasing.POLISH_ITERS


def _planted(case, rng):
    """Scores of the three stages' candidates (36, 41, 7)."""
    e = [rng.uniform(1.0, 2.0, c).astype(np.float32)
         for _, _, c in acme_cuda.SEARCH_MESHES]
    if case == "tie":
        # In a chunk, across chunks (the earlier chunk keeps it), and in a
        # last, partial chunk.
        e[0][[3, 7, 18]] = 0.5
        e[1][[33, 35]] = 0.25
        e[1][[2, 20]] = 0.75
        e[2][[1, 4]] = 0.5
    elif case == "nan":
        # A chunk whose minimum sits beside a NaN loses to a worse chunk; a
        # stage whose every chunk holds a NaN keeps 0.
        e[0][2], e[0][5] = 0.1, np.nan
        e[0][20], e[0][34] = 0.3, 0.2
        e[1][0], e[1][40] = np.nan, 0.05
        e[2][:] = np.nan
    elif case == "inf":
        for x in e:
            x[:] = np.inf
    return e


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("case", ["tie", "nan", "inf", "random"])
def test_scan_winner_follows_the_torch_scan_rule(spectra, monkeypatch, case,
                                                 p0_only):
    """The same planted scores on both sides: the torch scan (chunks of 16,
    the last padded with its last candidate) with a polish that cannot
    move, and the twin's scan."""
    re, im, f, k = _turned(spectra, None)
    planted = _planted(case, np.random.default_rng(7))
    chunks = [(s, c) for s, (_, _, n) in enumerate(acme_cuda.SEARCH_MESHES)
              for c in range(math.ceil(n / 16))]
    calls = []

    def torch_scores(d, t_idx, width):
        zero = 0.0 * d.sum(-1)
        if d.dim() == 2:  # the polish: a constant score, no step is taken
            return zero
        stage, chunk = chunks[len(calls)]
        calls.append(stage)
        n = len(planted[stage])
        idx = np.minimum(np.arange(16 * chunk, 16 * chunk + 16), n - 1)
        return torch.as_tensor(planted[stage][idx]) + zero

    monkeypatch.setitem(phasing._SCORES, "acme", torch_scores)
    want = _grid_phase_search(re, im, f, f[-1] - f[0], f[k][None], p0_only,
                              cand_chunk=16)
    assert calls == ([0] * 3 if p0_only else [0] * 3 + [1] * 3 + [2])

    stages = []

    def twin_scores(re_, im_, u_, p0, p1):
        stages.append(len(stages))
        assert p0.shape == (len(planted[stages[-1]]),)
        return torch.as_tensor(planted[stages[-1]])

    monkeypatch.setattr(acme_cuda, "_scan_scores", twin_scores)
    dec = acme_cuda.search_plan(f.shape[0], p0_only)[0]
    u = (f - f[k]) / (f[-1] - f[0])
    got = acme_cuda._scan_plain(re[:, ::dec], im[:, ::dec], u[None, ::dec],
                                p0_only)
    assert stages == ([0] if p0_only else [0, 1, 2])
    assert torch.equal(got, want)
    if case == "inf":
        assert torch.equal(got, torch.zeros((1, 2)))
    if case == "nan" and not p0_only:
        # p0 from chunk 2 (candidate 34), p1 from the last chunk, and the
        # refinement, all NaN, gives 0.
        assert float(got[0, 1]) == -4000.0 + 200.0 * 40
        assert float(got[0, 0]) == 0.0


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("row", list(ROWS))
def test_scan_winner_on_rows_is_the_torch_scans(spectra, monkeypatch, row,
                                                p0_only):
    """With the real scores (the twin's float64 sums, the torch scan's
    float32 ones) both scans pick the same candidates."""
    re, im, f, k = _turned(spectra, ROWS[row])
    monkeypatch.setattr(phasing, "POLISH_ITERS", 0)
    monkeypatch.setitem(phasing._SCORES, "acme",
                        lambda d, t, w: acme_score_raw(d) if d.dim() == 3
                        else 0.0 * d.sum(-1))
    want = _grid_phase_search(re, im, f, f[-1] - f[0], f[k][None], p0_only,
                              cand_chunk=16)
    dec = acme_cuda.search_plan(f.shape[0], p0_only)[0]
    u = acme_cuda._div(f[None] - f[k], f[-1] - f[0])
    got = acme_cuda._scan_plain(re[:, ::dec], im[:, ::dec], u[:, ::dec],
                                p0_only)
    assert torch.equal(got, want)
    assert torch.equal(acme_cuda.acme_search_plain(
        re, im, f, *_peak(k), p0_only=p0_only, n_iter=0), got)


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("row", list(ROWS))
def test_search_matches_the_reference_search(spectra, row, p0_only):
    """The twin's phases against the JAX package's single-pivot grid search
    by the float64 ACME score they reach (no worse by 1e-5 relative), and
    against the port's torch search likewise."""
    re, im, f, k = _turned(spectra, ROWS[row])
    got = acme_cuda.acme_search_plain(re, im, f, *_peak(k), p0_only=p0_only)
    ref_cfg = RefConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                        ap_optimizer="grid", p0_only=p0_only)
    p0_r, p1_r = ref_solve_phase(
        jnp.asarray(re[0].numpy()), jnp.asarray(im[0].numpy()),
        jnp.asarray(f.numpy()), jnp.asarray(f[k].numpy()), ref_cfg)
    ref = torch.tensor([[float(p0_r), float(p1_r)]])
    port = _grid_phase_search(re, im, f, f[-1] - f[0], f[k][None], p0_only,
                              cand_chunk=16)
    s = _score(re, im, f, k, got)
    assert math.isfinite(s)
    assert s <= _score(re, im, f, k, ref) * (1 + 1e-5)
    assert s <= _score(re, im, f, k, port) * (1 + 1e-5)
    if p0_only:
        assert float(got[0, 1]) == 0.0
        assert abs(float(got[0, 0]) - float(p0_r)) <= 0.5


def test_an_all_inf_row_keeps_zero(spectra):
    """A zero row: every candidate scores +inf (its maximum is not
    positive) and the gradient is 0, so (0, 0), as the torch search
    gives."""
    _, _, f, k = _turned(spectra, None)
    re = torch.zeros((1, f.shape[0]))
    im = torch.zeros_like(re)
    for p0_only in (False, True):
        got = acme_cuda.acme_search_plain(re, im, f, *_peak(k),
                                          p0_only=p0_only)
        want = _grid_phase_search(re, im, f, f[-1] - f[0], f[k][None],
                                  p0_only, cand_chunk=16)
        assert torch.equal(got, torch.zeros((1, 2)))
        assert torch.equal(want, torch.zeros((1, 2)))


def test_the_search_reads_the_row_in_any_layout(spectra):
    """Flat, stacked (B, n2, n1) and voxel-strided spectra give the same
    phases; the CPU wrapper runs the twin (one plain call, no launch)."""
    sr, si, f, (v, k) = spectra
    n2, n1 = dft_cuda.stacked_spec_shape(bi.N_TIME, bi.ZERO_FILL)
    wide = torch.cat([sr, si], dim=1)  # rows of 2n: the views have stride 2n
    layouts = {
        "stacked": (sr.reshape(-1, n2, n1), si.reshape(-1, n2, n1)),
        "strided": (wide[:, : bi.ZERO_FILL], wide[:, bi.ZERO_FILL:]),
    }
    K.reset_counters()
    want = acme_cuda.acme_search(sr, si, f, *map(torch.tensor, (v, k)))
    counts = K.counters()
    assert counts["plain_calls"]["acme_search"] == 1
    assert counts["launches"]["acme_search"] == 0
    for name, (re_l, im_l) in layouts.items():
        got = acme_cuda.acme_search_plain(re_l, im_l, f,
                                          *map(torch.tensor, (v, k)))
        assert torch.equal(got, want), name
    assert layouts["strided"][0].stride(0) == 2 * bi.ZERO_FILL


@pytest.mark.parametrize("p0_only", [False, True])
@pytest.mark.parametrize("polish", ["auto", "gd", "newton"])
def test_solve_phase_on_row_keeps_the_torch_search_on_the_cpu(
        spectra, polish, p0_only):
    """On CPU rows the solve is the torch grid search at cand_chunk 16, bit
    for bit (K5s takes CUDA rows only): no twin call, no kernel count."""
    sr, si, f, (v, k) = spectra
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                         ap_optimizer="grid", ap_polish=polish,
                         p0_only=p0_only)
    K.reset_counters()
    with profiling.recording() as rec:
        p0, p1 = _solve_phase_on_row(sr, si, f, (torch.tensor(v),
                                                  torch.tensor(k)), cfg)
    assert "spectral.phase_search.kernel" not in rec.snapshot()["counters"]
    assert K.counters()["plain_calls"]["acme_search"] == 0
    want = _grid_phase_search(sr[v][None], si[v][None], f, f[-1] - f[0],
                              f[k][None], p0_only, polish_optimizer=polish,
                              cand_chunk=16)
    assert torch.equal(p0, want[0, 0])
    assert torch.equal(p1, torch.zeros_like(p0) if p0_only else want[0, 1])


def test_solve_phase_on_row_keeps_de(spectra):
    """The DE pivot search is the torch DE on the gathered row, as before."""
    sr, si, f, (v, k) = spectra
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                         de_maxiter=20)
    p0, p1 = _solve_phase_on_row(sr, si, f, (torch.tensor(v),
                                              torch.tensor(k)), cfg)
    want = _de_phase_search(sr[v][None], si[v][None], f, f[-1] - f[0],
                            f[k][None], False, seed=cfg.de_seed,
                            popsize=cfg.de_popsize, maxiter=20)
    assert torch.equal(torch.stack([p0, p1]), want[0])
