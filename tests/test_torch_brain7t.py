"""The 12-line 7 T brain 31P prior (K = 12, F = 48, g fixed; the
benchmark's ``p31_brain7t_k12``) through the port's normal paths on the
CPU, against the JAX package, and the kernel wrappers' caps it needs.

The port runs its kernel engine (``engine="pallas"``: the plain twins of
K1-K4 on the CPU); the reference runs its ``"xla"`` engine, whose LM and
CRLB need no Pallas interpreter (at K = 12 the interpreted v9 kernels take
minutes to trace), with the Pallas spectrum in interpret mode for the
stacked layout.

On the card K2 takes such a prior to its wide build (``csrc/lm_v9_wide.cu``)
and K3/K4/K6a/K6b to the wide warp factor (two rows a lane);
``test_torch_cuda.py`` holds those against their plain twins there, and
``test_torch_spd_warp.py`` / ``test_torch_lm_v9_warp.py`` their schedules
here.  The fits are held to ``tests/test_process.py:78-84`` (cost rtol
1e-4, x rtol/atol 2e-3, CRLB rtol 2e-2 / atol 1e-4), as the bench prior's
are in ``test_torch_slice.py`` and ``test_torch_fit_amares.py``; phases,
which two LM formulations stop at different points of a flat valley, at
2e-3 + 0.1 of their CRLB, as ``test_torch_fit_amares.py`` holds them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xmris_tpu as xmt
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.fitting.amares import fit_amares as ref_fit_amares
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting.amares import fit_amares
from xmris_tpu_torch.fitting.lm import (
    crlb_batched_planar,
    hashable_pmap,
    normal_eq_plan,
)
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops.kernels import lm_cuda, spd
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

from _torch_parity import (
    BRAIN7T,
    MHZ,
    brain7t_phantom,
    load_priors,
    spectral_constants,
)

ZF, WEIGHT, FREQS = spectral_constants()
N_VOX = 8
GRID = (2, 2, 2)
DIMS = ("x", "y", "z", "time")
PARAMS = ("amplitude", "chem_shift", "linewidth", "phase")


def test_the_kernel_wrappers_take_the_12_line_plan():
    """K2's caps take the plan (to its wide build, past the narrow caps
    that K8 and K9 keep) and refuse one past them; the SPD wrappers' check
    takes F = 33 and 48 and refuses 49, the same message form as before."""
    pk = prior_from_csv_text(BRAIN7T["prior_csv"])
    assert (pk.n_peaks, pk.n_free) == (12, 48)
    plan = normal_eq_plan(hashable_pmap(pk.pmap), pk.n_free, MHZ, True)
    assert len(plan.active) == 48 and plan.q_n == 1
    lm_cuda._check_bounds(plan)
    lm_cuda.check_warp_plan(plan, BRAIN7T["n_time"])
    assert lm_cuda.is_wide(plan)
    with pytest.raises(ValueError, match="prior too large for the kernel"):
        lm_cuda._check_bounds(plan, lm_cuda.NARROW_CAPS)
    with pytest.raises(ValueError, match="prior too large for the kernel"):
        lm_cuda.check_plan(plan, BRAIN7T["n_time"])
    for f in (33, 48):
        h = torch.zeros((f * f, 3))
        spd._launch_checks(h, f, torch.zeros((3, f)), torch.zeros(3))
    with pytest.raises(ValueError, match="F=49 exceeds the kernel maximum 48"):
        spd._launch_checks(torch.zeros((49 * 49, 3)), 49)


@pytest.fixture(scope="module")
def grid_fits(tmp_path_factory):
    fids, t, amp = brain7t_phantom(N_VOX)
    pk, pkt = load_priors(BRAIN7T["prior_csv"], tmp_path_factory.mktemp("pk"))
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt, "cpu")
    ref = ref_process(
        *(jnp.asarray(a.numpy()) for a in args),
        cfg=RefConfig(zero_fill_to=ZF, lb=5.0, autophase="single",
                      dft_variant="pallas", spec_layout="stacked",
                      ap_optimizer="grid"),
        interpret=True, engine="xla", **kw)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = process_grid_planar_raw(
        *args, cfg=PipelineConfig(zero_fill_to=ZF, autophase="single",
                                  spec_layout="stacked", ap_optimizer="grid"),
        **kw)
    return ref, got, pk, amp


def test_grid_program_matches_reference_at_12_lines(grid_fits):
    """``process_grid_planar_raw`` at the bench protocol (v9, slab solve,
    slab CRLB) on the 12-line prior: the pivot and phases as the
    reference's, the fit at the oracle tolerances, PCr recovered."""
    ref, got, pk, amp = grid_fits
    *_, (p0_r, p1_r, piv_r), x_r, cost_r, conv_r, sds_r = ref
    *_, (p0, p1, pivot), x, cost, conv, sds = got
    assert float(pivot) == float(piv_r)
    assert abs(float(p0) - float(p0_r)) <= 0.5
    assert x.shape == (N_VOX, 48) and conv.all() and conv_r.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    phase = np.arange(48) % 4 == 3
    x, sds = x.numpy(), sds.numpy()
    np.testing.assert_allclose(x[:, ~phase], x_r[:, ~phase], rtol=2e-3,
                               atol=2e-3)
    assert np.all(np.abs(x[:, phase] - x_r[:, phase])
                  <= 2e-3 + 0.1 * sds[:, phase])
    np.testing.assert_allclose(sds, sds_r, rtol=2e-2, atol=1e-4)
    slot = int(pk.pmap.idx[5 * 6])  # PCr, the seventh line
    assert np.median(np.abs(x[:, slot] - amp) / amp) <= 0.05


def _sds(ds, pk, fids, t):
    """The Jacobian CRLB SD of every map entry at ``ds``'s solution, (x, y,
    z, Metabolite) per parameter name (``test_torch_fit_amares._phase_sds``
    for every parameter)."""
    n_peaks = pk.n_peaks
    x = np.zeros((int(np.prod(GRID)), pk.n_free))
    for c, name in enumerate(PARAMS):
        vals = ds[name].values.reshape(-1, n_peaks)
        for k in range(n_peaks):
            x[:, pk.pmap.idx[5 * k + c]] = vals[:, k]

    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64))

    sds, _ = crlb_batched_planar(f64(fids.real), f64(fids.imag), f64(t),
                                 f64(x), hashable_pmap(pk.pmap), MHZ)
    return {name: sds.numpy()[:, [pk.pmap.idx[5 * k + c]
                                  for k in range(n_peaks)]].reshape(
                                      GRID + (n_peaks,))
            for c, name in enumerate(PARAMS)}


def test_fit_amares_matches_reference_at_12_lines(tmp_path):
    """The public ``fit_amares`` on the kernel engine (plain twins on the
    CPU: K2, K3, K6b) against the reference's: every map within 2e-3 +
    0.1 of its CRLB (the two engines' LM formulations may stop a voxel at
    another point of a flat valley, ROADMAP's "Flat valleys"), CRLB % at
    2e-2."""
    path = tmp_path / "pk.csv"
    path.write_text(BRAIN7T["prior_csv"])
    fids, t, amp = brain7t_phantom(N_VOX, seed=1)
    data = fids.reshape(GRID + (-1,)).astype(np.complex128)
    tt = t.astype(np.float64)
    ref = ref_fit_amares(
        xmt.XmrArray(data, dims=DIMS, coords={"time": JCoord("time", tt)},
                     attrs={"MHz": MHZ}), path, engine="xla")
    got = fit_amares(
        XmrArray(data, dims=DIMS, coords={"time": Coord("time", tt)},
                 attrs={"MHz": MHZ}), path, engine="pallas", device="cpu")
    assert got["fit_converged"].values.all() and ref["fit_converged"].values.all()
    sds = _sds(got, prior_from_csv_text(BRAIN7T["prior_csv"]), fids, tt)
    for name in PARAMS:
        a, b = got[name].values, ref[name].values
        assert np.all(np.abs(a - b) <= 2e-3 + 2e-3 * np.abs(b)
                      + 0.1 * sds[name]), name
    np.testing.assert_allclose(got["crlb"].values, ref["crlb"].values,
                               rtol=2e-2, atol=1e-4)
    pcr = got["amplitude"].values.reshape(-1, 12)[:, 6]
    assert np.median(np.abs(pcr - amp) / amp) <= 0.05
