"""The port's spectral stage, single-pivot autophase and whole per-grid
program against the JAX package.

The JAX side runs the Pallas spectrum kernel and the LM kernels in
interpret mode with ``dft_variant="pallas"``, ``ap_optimizer="grid"`` and
``uniform_t_ok=True``; the port runs its plain kernel versions.  Spectra
are held to 1e-6 * max|S|, the pivot must be identical, |dp0| <= 0.5 deg
(``test_dft_pallas.py:161``) with the port's ACME score no worse than the
reference's by more than 1e-5 relative, and the fit to
``tests/test_process.py:78-84``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.planar_pipeline import (
    _solve_phase_on_row as ref_solve_phase,
    spectral_pipeline_planar_raw as ref_spectral,
)
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from xmris_tpu_torch.ops.phasing import _phased_real_planar, acme_score_raw
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import (
    _solve_phase_on_row,
    spectral_pipeline_planar_raw,
)
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

from _torch_parity import (
    BENCH_PK_CSV,
    MHZ,
    N_T,
    bench_phantom,
    load_priors,
    spectral_constants,
)

ZF, WEIGHT, FREQS = spectral_constants()


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _ref_cfg(autophase, layout="stacked"):
    return RefConfig(zero_fill_to=ZF, lb=5.0, autophase=autophase,
                     dft_variant="pallas", spec_layout=layout,
                     ap_optimizer="grid")


def _port_cfg(autophase, layout="stacked"):
    return PipelineConfig(zero_fill_to=ZF, autophase=autophase,
                          spec_layout=layout, ap_optimizer="grid")


@pytest.fixture(scope="module")
def phantom():
    fids, t, amp = bench_phantom()
    return fids, t, amp


@pytest.fixture(scope="module")
def ref_unphased(phantom):
    """Reference spectral stage without autophase, stacked layout."""
    fids = phantom[0]
    out = ref_spectral(
        jnp.asarray(np.ascontiguousarray(fids.real)),
        jnp.asarray(np.ascontiguousarray(fids.imag)),
        jnp.asarray(WEIGHT), jnp.asarray(FREQS), _ref_cfg("none"),
    )
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("layout", ["stacked", "flat"])
def test_spectral_stage_without_autophase(phantom, ref_unphased, layout):
    fids = phantom[0]
    sr, si, (p0, p1, pivot) = spectral_pipeline_planar_raw(
        _t(fids.real), _t(fids.imag), _t(WEIGHT), _t(FREQS),
        _port_cfg("none", layout),
    )
    ref_re, ref_im = ref_unphased
    if layout == "flat":
        ref_re, ref_im = ref_re.reshape(len(fids), ZF), ref_im.reshape(
            len(fids), ZF)
    assert tuple(sr.shape) == ref_re.shape
    for a, b in ((sr, ref_re), (si, ref_im)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * float(np.abs(b).max()))
    assert float(p0) == float(p1) == float(pivot) == 0.0


def _loudest_row(spec_re, spec_im):
    m2 = (spec_re.astype(np.float64) ** 2 + spec_im.astype(np.float64) ** 2)
    m2 = m2.reshape(len(spec_re), -1)
    v, k = np.unravel_index(np.argmax(m2), m2.shape)
    return (spec_re.reshape(len(spec_re), -1)[v],
            spec_im.reshape(len(spec_im), -1)[v], k)


def _score(row_re, row_im, p0, p1, pivot):
    """ACME score in float64 of one row at the given phases."""
    f = torch.as_tensor(FREQS, dtype=torch.float64)
    d = _phased_real_planar(
        torch.tensor(np.asarray(row_re), dtype=torch.float64),
        torch.tensor(np.asarray(row_im), dtype=torch.float64), f,
        torch.tensor(float(p0), dtype=torch.float64),
        torch.tensor(float(p1), dtype=torch.float64), float(pivot),
        float(f[-1] - f[0]),
    )
    return float(acme_score_raw(d))


@pytest.mark.parametrize("p0_only", [False, True])
def test_single_pivot_phase_solve(ref_unphased, p0_only):
    row_re, row_im, k = _loudest_row(*ref_unphased)
    pivot = FREQS[k]
    ref_cfg = RefConfig(zero_fill_to=ZF, autophase="single",
                        ap_optimizer="grid", p0_only=p0_only)
    p0_r, p1_r = ref_solve_phase(
        jnp.asarray(row_re), jnp.asarray(row_im), jnp.asarray(FREQS),
        jnp.asarray(pivot), ref_cfg,
    )
    p0, p1 = _solve_phase_on_row(
        _t(row_re)[None], _t(row_im)[None], _t(FREQS),
        (torch.tensor(0), torch.tensor(k)),
        PipelineConfig(zero_fill_to=ZF, autophase="single",
                       ap_optimizer="grid", p0_only=p0_only),
    )
    assert abs(float(p0) - float(p0_r)) <= 0.5
    if p0_only:
        assert float(p1) == 0.0
    s_port = _score(row_re, row_im, p0, p1, pivot)
    s_ref = _score(row_re, row_im, p0_r, p1_r, pivot)
    assert s_port <= s_ref * (1 + 1e-5)


@pytest.fixture(scope="module")
def whole_program(phantom, tmp_path_factory):
    fids, t, amp = phantom
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path_factory.mktemp("pk"))
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    ref = ref_process(
        *(jnp.asarray(a.numpy()) for a in args),
        cfg=_ref_cfg("single"), interpret=True, **kw,
    )
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = process_grid_planar_raw(*args, cfg=_port_cfg("single"), **kw)
    return ref, got, pk, amp


def test_process_grid_matches_reference(whole_program):
    ref, got, pk, amp = whole_program
    sr_r, si_r, (p0_r, p1_r, piv_r), x_r, cost_r, conv_r, sds_r = ref
    sr, si, (p0, p1, pivot), x, cost, conv, sds = got
    assert tuple(sr.shape) == sr_r.shape == (len(amp),) + sr_r.shape[1:]
    assert float(pivot) == float(piv_r)
    assert abs(float(p0) - float(p0_r)) <= 0.5
    # The spectra agree once the reference's are rotated onto the port's
    # phases (the phase search is held separately).
    x_range = FREQS[-1] - FREQS[0]

    def phi(a0, a1):
        return (np.deg2rad(float(a0)) + np.deg2rad(float(a1))
                * ((FREQS.astype(np.float64) - float(pivot)) / x_range))

    d = (phi(p0, p1) - phi(p0_r, p1_r)).reshape(sr_r.shape[1:])[None]
    rot_re = sr_r * np.cos(d) - si_r * np.sin(d)
    rot_im = sr_r * np.sin(d) + si_r * np.cos(d)
    scale = float(np.abs(sr_r).max())
    np.testing.assert_allclose(sr.numpy(), rot_re, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(si.numpy(), rot_im, rtol=0, atol=1e-6 * scale)

    assert conv.all() and conv_r.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_r, rtol=2e-2, atol=1e-4)
    slot = int(pk.pmap.idx[0])
    assert np.median(np.abs(x.numpy()[:, slot] - amp) / amp) <= 0.05


def test_process_grid_phases_score(whole_program, ref_unphased):
    """The whole program's phase solution scores at least as well as the
    reference's on the reference's own pivot row."""
    ref, got, _, _ = whole_program
    row_re, row_im, k = _loudest_row(*ref_unphased)
    _, _, (p0_r, p1_r, piv_r), *_ = ref
    _, _, (p0, p1, pivot), *_ = got
    assert float(FREQS[k]) == float(piv_r) == float(pivot)
    s_port = _score(row_re, row_im, p0, p1, pivot)
    s_ref = _score(row_re, row_im, p0_r, p1_r, piv_r)
    assert math.isfinite(s_port) and s_port <= s_ref * (1 + 1e-5)


def test_pipeline_runs_the_default_de(phantom):
    """Item 7's DE, which raised in ``test_unported_options_raise``: both
    autophase modes run at the default ap_optimizer="de"."""
    fids = phantom[0]
    args = (_t(fids.real), _t(fids.imag), _t(WEIGHT), _t(FREQS))
    for autophase, shape in (("all", (len(fids),)), ("single", ())):
        _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(
            *args, PipelineConfig(zero_fill_to=ZF, autophase=autophase))
        assert p0.shape == piv.shape == shape
        assert torch.isfinite(p0).all() and torch.isfinite(p1).all()


def test_unported_options_raise(phantom):
    """ap_polish="newton" on the pivot row, which raised
    NotImplementedError until item 7 was ported, runs; a zero-fill below
    n_time still raises the reference's ValueError."""
    fids = phantom[0]
    args = (_t(fids.real), _t(fids.imag), _t(WEIGHT), _t(FREQS))
    _, _, (p0, p1, piv) = spectral_pipeline_planar_raw(*args, PipelineConfig(
        zero_fill_to=ZF, ap_optimizer="grid", ap_polish="newton"))
    assert p0.shape == p1.shape == piv.shape == ()
    assert torch.isfinite(p0) and torch.isfinite(p1)
    with pytest.raises(ValueError, match="split"):
        spectral_pipeline_planar_raw(
            *args, PipelineConfig(zero_fill_to=N_T // 2, autophase="none"))


@pytest.mark.parametrize("bad", [
    dict(autophase="sometimes"), dict(ap_optimizer="bfgs"),
    dict(ap_polish="adam"), dict(spec_layout="ragged"),
    dict(spec_layout="stacked", autophase="all"),
])
def test_pipeline_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**bad)
    with pytest.raises(ValueError) as port_err:
        PipelineConfig(**bad)
    assert str(port_err.value) == str(ref_err.value)
