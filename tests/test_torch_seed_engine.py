"""Two repairs of the port against the JAX package: the template seed's
``linear_seed`` switch with its warn-and-keep fallback, and the grid
program's ``engine``.

``template_seeded_x0`` takes ``linear_seed`` tenth, before ``g_scan``, as
the reference does: ``False`` keeps the scaled template seed, and a seed
solve that fails warns (``RuntimeWarning``) and keeps it too.
``process_grid_planar_raw(engine=)`` forwards to ``seeded_fit_grid_raw``:
any engine but ``"pallas"`` runs the pure-tensor LM, held to the
reference's ``"planar"`` engine at the whole-program tolerances of
``test_torch_slice.py`` (x 2e-3, cost rtol 1e-4, CRLB rtol 2e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.ops.bounds import external_to_internal_torch
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
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
import test_process

ZF, WEIGHT, FREQS = spectral_constants()


@pytest.fixture(scope="module")
def seed_inputs(tmp_path_factory):
    fids, t, _ = bench_phantom(n_voxels=8)
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path_factory.mktemp("pk"))
    return fids, t, pk, pkt


def _seeds(fids, t, pk, pkt, **kw):
    ref = jam.template_seeded_x0(fids, pk, jnp.asarray(t), MHZ,
                                 fit_template=False, **kw)
    got = tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ,
                                 fit_template=False, **kw)
    return ref, got


def test_linear_seed_false_is_the_scaled_template(seed_inputs):
    fids, t, pk, pkt = seed_inputs
    ref, got = _seeds(fids, t, pk, pkt, linear_seed=False)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    slots = list(tam.seed_plan(pkt)[0])
    total = np.sum(np.abs(pkt.init_free[slots]))
    scale = np.clip(np.abs(fids[:, 0]) / total, 0.1, 100.0)
    want = np.broadcast_to(pkt.init_free, got.shape).copy()
    want[:, slots] *= scale[:, None]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    seeded, _ = _seeds(fids, t, pk, pkt)
    assert not np.allclose(seeded, ref)
    # Tenth positionally, as in the reference: before g_scan.
    pos = tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ, None,
                                 False, True, 60, False, False)
    np.testing.assert_array_equal(pos, got)
    # A string g_scan raises only where the LS seed runs, as there.
    tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ,
                           fit_template=False, linear_seed=False,
                           g_scan="auto")
    with pytest.raises(TypeError, match="g_scan"):
        tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ,
                               fit_template=False, g_scan="auto")


def test_failed_seed_solve_warns_and_keeps_the_template(seed_inputs,
                                                        monkeypatch):
    fids, t, pk, pkt = seed_inputs
    want, kept = _seeds(fids, t, pk, pkt, linear_seed=False)

    def fail(*a, **k):
        raise np.linalg.LinAlgError("singular seed system")

    monkeypatch.setattr(jam, "_linear_amp_phase_seed", fail)
    monkeypatch.setattr(tam, "_linear_seed_solve", fail)
    with pytest.warns(RuntimeWarning, match="linear seed skipped") as w_ref:
        ref = jam.template_seeded_x0(fids, pk, jnp.asarray(t), MHZ,
                                     fit_template=False)
    with pytest.warns(RuntimeWarning, match="linear seed skipped") as w_port:
        got = tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ,
                                     fit_template=False)
    assert str(w_port[0].message) == str(w_ref[0].message)
    np.testing.assert_array_equal(got, kept)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("case", ["bench", "free_g_scan"])
def test_template_seed_is_seed_grid(case, seed_inputs, tmp_path):
    """One seeding for both fits: without the template fit, the labeled
    fit's seed (``template_seeded_x0``, float64) through the bound
    transform is the grid program's ``seed_grid`` u0 (float32) within
    float32 rounding, on the bench prior and with the g scan on a free-g
    prior."""
    if case == "bench":
        fids, t, _, pkt = seed_inputs
        g_scan = None
    else:
        _, pkt = load_priors(test_process.PK_CSV_FREE_G, tmp_path)
        fids, t = test_process.TestGScanSeed()._voigt_phantom()
        g_scan = (0.0, 0.25, 0.5, 0.75)
    x0 = tam.template_seeded_x0(fids, pkt, torch.from_numpy(t), MHZ,
                                fit_template=False, g_scan=g_scan)
    lower, upper, kind = (torch.from_numpy(np.asarray(a)) for a in
                          (pkt.lower, pkt.upper, pkt.kind))
    u_labeled = external_to_internal_torch(torch.from_numpy(x0), lower,
                                           upper, kind)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    amp_slots, ls_plan = tam.seed_plan(pkt)
    u_grid = tam.seed_grid(
        f32(fids.real), f32(fids.imag), f32(t), f32(pkt.init_free),
        f32(pkt.lower), f32(pkt.upper), kind,
        pmap_static=jlm.hashable_pmap(pkt.pmap), mhz=MHZ,
        amp_slots=amp_slots, ls_plan=ls_plan, g_scan=g_scan or (),
        g_plan=tam.g_seed_plan(pkt))
    assert u_grid.dtype == torch.float32 and x0.dtype == np.float64
    np.testing.assert_allclose(u_grid.numpy(), u_labeled.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_grid_program_engine_xla_matches_reference_planar(tmp_path):
    fids, t, amp = bench_phantom(n_voxels=6)
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path)
    x_template = pk.init_free.astype(np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    cfg = PipelineConfig(zero_fill_to=ZF, autophase="none")
    got = process_grid_planar_raw(*args, cfg=cfg, engine="xla", **kw)
    fit = tam.seeded_fit_grid_raw(*args[:2], *args[4:], engine="xla", **kw)
    for a, b in zip(got[3:], fit):
        assert torch.equal(a, b)
    ref = ref_process(*(jnp.asarray(a.numpy()) for a in args),
                      cfg=RefConfig(zero_fill_to=ZF, autophase="none"),
                      engine="planar", **kw)
    _, _, _, x_r, cost_r, conv_r, sds_r = jax.tree_util.tree_map(np.asarray,
                                                                 ref)
    _, _, _, x, cost, conv, sds = got
    assert conv.all() and conv_r.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_r, rtol=2e-2, atol=1e-4)
    slot = int(pk.pmap.idx[0])
    assert np.median(np.abs(x.numpy()[:, slot] - amp) / amp) <= 0.05
