"""The port's voxel mesh (``xmris_tpu_torch.parallel``) against the JAX
package and against the port's own unsharded programs.

The JAX side shards over the eight virtual CPU devices of ``conftest.py``
(Pallas in interpret mode); the port over ``Mesh([cpu] * 8)``, a mesh that
names the CPU eight times, whose shards run in turn.  Held
against JAX: ``lm_fit_batched_pallas_sharded`` (x rtol/atol 1e-4, cost rtol
1e-5, as ``test_torch_lm_family.py`` holds the unsharded LM),
``fit_amares(mesh=8)`` (parameters rtol/atol 2e-3, CRLB % 2e-2, as
``test_torch_fit_amares.py``), ``mrsi_pipeline(mesh=)`` (the elected pivot
equal, spectra 1e-6 max|S|, p0 within 0.5 deg, as
``test_torch_mrsi_pipeline.py``) and ``spectral_pipeline_raw``.
``process_grid_sharded`` is held against the port's unsharded program
(which ``test_torch_slice.py`` holds against the JAX program): a JAX
sharded grid program takes 29-42 s to compile on this CPU.  Port against
port, at the reference tests' own bars (``tests/test_parallel.py:172-232,
413-459``, ``tests/test_public_mesh.py:144-165``).
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.fitting import lm as jlm
from xmris_tpu.fitting.amares import fit_amares as ref_fit_amares
from xmris_tpu.fitting.prior import load_prior_knowledge as ref_load_prior
from xmris_tpu.parallel import PipelineConfig as RefConfig
from xmris_tpu.parallel import lm_fit_batched_pallas_sharded as ref_lm_sharded
from xmris_tpu.parallel import make_mesh as ref_make_mesh
from xmris_tpu.parallel import mrsi_pipeline as ref_mrsi_pipeline
from xmris_tpu.parallel import spectral_pipeline_raw as ref_spectral_raw
from xmris_tpu.parallel.mesh import pad_to_multiple as ref_pad_to_multiple

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting.amares import (
    fit_amares,
    seed_plan,
    stage_device_fids,
    template_optimum,
)
from xmris_tpu_torch.fitting.lm import (
    crlb_from_hessian,
    external_to_internal,
    hashable_pmap,
    lm_fit_batched_pallas,
)
from xmris_tpu_torch.fitting.prior import load_prior_knowledge, prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.parallel import (
    GRID_AXIS,
    PipelineConfig,
    lm_fit_batched_pallas_sharded,
    make_mesh,
    mrsi_pipeline,
    pinned_grid_program,
    process_grid_planar_raw,
    replicated,
    shard_voxels,
    spectral_pipeline_raw,
    voxel_sharding,
)
from xmris_tpu_torch.parallel import mesh as mesh_mod
from xmris_tpu_torch.parallel.mesh import Mesh, edge_pad_rows, map_shards, pad_to_multiple
from xmris_tpu_torch.parallel.process import grid_inputs_from_numpy, process_grid_sharded

from test_parallel import make_grid
from test_public_mesh import PK_CSV as MESH_PK_CSV
from test_public_mesh import make_phantom as mesh_phantom

CPU8 = Mesh([torch.device("cpu")] * 8)
MAPS = ("amplitude", "chem_shift", "linewidth", "phase", "crlb", "fit_converged")
# The maps tests/test_public_mesh.py compares.
PUBLIC_MESH_MAPS = ("amplitude", "chem_shift", "crlb", "fit_converged")


def _port(da):
    return XmrArray(np.asarray(da.values), dims=da.dims,
                    coords={k: Coord(c.dim, np.asarray(c.values), dict(c.attrs))
                            for k, c in da.coords.items()},
                    attrs=dict(da.attrs))


@pytest.fixture(scope="module")
def mesh_pk(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_pk") / "pk.csv"
    path.write_text(MESH_PK_CSV)
    return path


# ---------------------------------------------------------------------------
# The mesh substrate
# ---------------------------------------------------------------------------


def test_make_mesh_on_the_cpu_and_its_records():
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape == {GRID_AXIS: 8} and mesh.size == 8
    assert mesh.axis_names == (GRID_AXIS,)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    assert voxel_sharding(mesh, 3).spec == (GRID_AXIS, None, None)
    assert replicated(mesh).spec == () and replicated(mesh).mesh is mesh


def test_make_mesh_past_the_device_count_raises():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} available"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(0, device="cpu")


def test_mesh_needs_one_name_per_axis():
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], dtype=object), ("grid",))
    assert Mesh([["cpu", "cpu"]], ("a", "b")).shape == {"a": 1, "b": 2}


def test_shard_voxels_pads_and_splits_in_mesh_order():
    x = torch.arange(24.0).reshape(12, 2)
    parts = shard_voxels(x, make_mesh(4, device="cpu"))
    assert [p.shape for p in parts] == [(3, 2)] * 4
    assert torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="divide"):
        shard_voxels(x, CPU8)
    for n, m in ((11, 8), (16, 8), (1, 3)):
        assert pad_to_multiple(n, m) == ref_pad_to_multiple(n, m)
    padded = edge_pad_rows(x[:11], 16)
    assert padded.shape == (16, 2)
    assert torch.equal(padded[11:], x[10:11].expand(5, 2))
    assert edge_pad_rows(x, 12) is x


@pytest.mark.parametrize("devices,per_shard,n_threads", [
    ([torch.device("cpu")] * 4, False, 0),
    # Two distinct devices (``cpu`` and ``cpu:0`` compare unequal): a host
    # thread for each, running its two shards in turn.
    ([torch.device("cpu"), torch.device("cpu", 0)] * 2, False, 2),
    # The ablation's runner: a host thread per shard, even on one device.
    ([torch.device("cpu")] * 4, True, 4),
], ids=["one device", "two devices", "thread per shard"])
def test_a_failing_shard_fails_the_call(devices, per_shard, n_threads,
                                        monkeypatch):
    """Shards on one device run in turn on the calling thread, each
    distinct device in a thread of its own (each shard with
    ``THREAD_PER_SHARD``); the results come back in mesh order, and a
    shard that raises fails the call."""
    monkeypatch.setattr(mesh_mod, "THREAD_PER_SHARD", per_shard)
    calls = []

    def fn(x):
        calls.append(threading.current_thread())  # idents may be reused
        if float(x[0]) == 6.0:
            raise RuntimeError("shard 3 failed")
        return x * 2

    mesh = Mesh(devices)
    with pytest.raises(RuntimeError, match="shard 3"):
        map_shards(fn, mesh, (torch.arange(8.0),))
    calls.clear()
    out = map_shards(fn, mesh, (torch.arange(1.0, 9.0),))
    assert torch.equal(out, torch.arange(1.0, 9.0) * 2)
    threads = set(calls)
    if n_threads == 0:
        assert threads == {threading.current_thread()}
    else:
        assert len(threads) == n_threads
        assert threading.current_thread() not in threads


# ---------------------------------------------------------------------------
# lm_fit_batched_pallas_sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_case(mesh_pk):
    """The fixed-g two-peak phantom of ``test_public_mesh.py`` at 16
    voxels, 128 points, from the prior's initial values."""
    pk = load_prior_knowledge(mesh_pk)
    da = mesh_phantom(16, n_points=128)
    fids = np.asarray(da.values).astype(np.complex64)
    u0 = np.broadcast_to(external_to_internal(
        pk.init_free, pk.lower, pk.upper, pk.kind).astype(np.float32)[None, :],
        (16, pk.n_free)).copy()
    t = (np.arange(128) / 10000.0).astype(np.float32)
    arrays = (np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag),
              t, u0, pk.lower, pk.upper, pk.kind)
    return pk, arrays


def _port_lm_args(pk, arrays):
    re, im, t, u0, lo, hi, kind = (torch.as_tensor(a) for a in arrays)
    return (re, im, t, u0, lo, hi, kind, hashable_pmap(pk.pmap), 120.0)


def test_sharded_lm_matches_reference(lm_case, mesh_pk):
    pk, arrays = lm_case
    rpk = ref_load_prior(mesh_pk)
    re, im, t, u0, lo, hi, kind = (jnp.asarray(a) for a in arrays)
    ref, h_ref = ref_lm_sharded(
        re, im, t, u0, lo, hi, kind, jlm.hashable_pmap(rpk.pmap), 120.0,
        mesh=ref_make_mesh(8), max_iter=25, interpret=True, return_hessian=True)
    res, h = lm_fit_batched_pallas_sharded(
        *_port_lm_args(pk, arrays), mesh=CPU8, max_iter=25, return_hessian=True)
    np.testing.assert_allclose(res.x_free.numpy(), np.asarray(ref.x_free),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    sds, _ = crlb_from_hessian(h, res.cost, 128)
    sds_ref, _ = jlm.crlb_from_hessian(h_ref, ref.cost, 128)
    np.testing.assert_allclose(sds.numpy(), np.asarray(sds_ref), rtol=2e-2,
                               atol=1e-4)


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("version", [9, 8, 10])
def test_sharded_lm_matches_the_single_launch(lm_case, version, n_shards):
    """Every shard's loop stops with its own voxels; converged voxels stop
    updating.  At 8 voxels a shard the solutions are the single launch's
    at ``tests/test_parallel.py:172-232``'s bars (rtol 1e-6, converged
    equal; the Hessian rtol/atol 1e-6).  At 2 voxels a shard this CPU's
    vector loops round the plain twins' small per-voxel tensors otherwise
    (a scalar tail) and the stopping rule turns that into moves of ~1e-5
    along flat valleys, so 8 shards are held to the bars the port meets
    against JAX (x rtol/atol 1e-4, cost rtol 1e-5).  Each shard runs its
    own LM: K2 (or K9, K8) runs per shard, a plain call each here."""
    pk, arrays = lm_case
    args = _port_lm_args(pk, arrays)
    one, h1 = lm_fit_batched_pallas(*args, max_iter=25, kernel_version=version,
                                    return_hessian=True)
    K.reset_counters()
    sh, hs = lm_fit_batched_pallas_sharded(
        *args, mesh=make_mesh(n_shards, device="cpu"), max_iter=25,
        kernel_version=version, return_hessian=True)
    plain = K.counters()["plain_calls"]
    if version == 10:
        assert plain["lm_loop_v10"] == n_shards
    else:
        assert plain[f"eq6_normal_eq_v{version}"] >= n_shards
    tight = n_shards == 2
    np.testing.assert_allclose(sh.x_free.numpy(), one.x_free.numpy(),
                               rtol=1e-6 if tight else 1e-4,
                               atol=1e-7 if tight else 1e-4)
    np.testing.assert_allclose(sh.cost.numpy(), one.cost.numpy(),
                               rtol=1e-6 if tight else 1e-5)
    assert torch.equal(sh.converged, one.converged)
    np.testing.assert_allclose(hs.numpy(), h1.numpy(),
                               rtol=1e-6 if tight else 1e-3, atol=1e-6)


def test_sharded_lm_refuses_what_the_reference_refuses(lm_case):
    pk, arrays = lm_case
    args = _port_lm_args(pk, arrays)
    with pytest.raises(ValueError, match="slab"):
        lm_fit_batched_pallas_sharded(*args, mesh=CPU8, return_hessian="slab")
    with pytest.raises(ValueError, match="divide"):
        lm_fit_batched_pallas_sharded(*(a[:6] for a in args[:2]), *args[2:],
                                      mesh=CPU8)
    bent = args[2].clone()
    bent[5] += 1e-5
    with pytest.raises(ValueError, match="uniformly sampled"):
        lm_fit_batched_pallas_sharded(*args[:2], bent, *args[3:], mesh=CPU8,
                                      kernel_version=7)


# ---------------------------------------------------------------------------
# process_grid_sharded and pinned_grid_program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid_case():
    """The bench phantom cut to 4x4x2 voxels (32), the bench prior."""
    fids, weight, freqs = bi.make_inputs((4, 4, 2))
    pk = prior_from_csv_text(bi.PK_CSV, "bench")
    t = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_template = template_optimum(fids, pk, torch.from_numpy(t), bi.MHZ)
    args = grid_inputs_from_numpy(fids, weight, freqs, t, x_template, pk, "cpu")
    amp_slots, ls_plan = seed_plan(pk)
    kw = dict(pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    return args, kw


CFGS = {
    "single grid stacked": PipelineConfig(zero_fill_to=bi.ZERO_FILL,
                                          ap_optimizer="grid",
                                          spec_layout="stacked"),
    "single DE": PipelineConfig(zero_fill_to=bi.ZERO_FILL, de_maxiter=30),
    "all grid": PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                               ap_optimizer="grid", ap_polish="fused"),
    "none": PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="none"),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_sharded_grid_matches_the_single_device_program(grid_case, name):
    """``tests/test_parallel.py:413-459``'s bars: the same pivot, p0 within
    0.1 deg, p1 within 2, spectra within 5e-3 max|S|, x rtol/atol 1e-4,
    cost rtol 1e-5, converged equal, CRLB rtol 1e-3; K1 and K4 (K5 per
    voxel) once per shard."""
    args, kw = grid_case
    cfg = CFGS[name]
    one = process_grid_planar_raw(*args, cfg=cfg, **kw)
    K.reset_counters()
    sh = process_grid_sharded(*args, mesh=CPU8, cfg=cfg, **kw)
    plain = K.counters()["plain_calls"]
    assert plain["spectrum"] == 8 and plain["spd_inverse_diag"] == 8
    assert plain["acme_polish"] == (8 if name == "all grid" else 0)
    s_sr, s_si, s_ph, s_x, s_cost, s_conv, s_sds = one
    d_sr, d_si, d_ph, d_x, d_cost, d_conv, d_sds = sh
    assert d_sr.shape == s_sr.shape and d_ph[0].shape == s_ph[0].shape
    np.testing.assert_array_equal(d_ph[2].numpy(), s_ph[2].numpy())
    np.testing.assert_allclose(d_ph[0].numpy(), s_ph[0].numpy(), rtol=0, atol=0.1)
    np.testing.assert_allclose(d_ph[1].numpy(), s_ph[1].numpy(), rtol=0, atol=2.0)
    scale = float(s_sr.abs().max())
    for a, b in ((d_sr, s_sr), (d_si, s_si)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-3 * scale)
    np.testing.assert_allclose(d_x.numpy(), s_x.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_cost.numpy(), s_cost.numpy(), rtol=1e-5)
    assert torch.equal(d_conv, s_conv)
    np.testing.assert_allclose(d_sds.numpy(), s_sds.numpy(), rtol=1e-3, atol=1e-5)


def test_sharded_grid_batch_must_divide(grid_case):
    args, kw = grid_case
    with pytest.raises(ValueError, match="divide"):
        process_grid_sharded(*(a[:12] for a in args[:2]), *args[2:],
                             mesh=CPU8, cfg=CFGS["none"], **kw)


def test_pinned_grid_program_is_the_program(grid_case):
    args, kw = grid_case
    cfg = CFGS["single grid stacked"]
    run = pinned_grid_program(device="cpu", cfg=cfg, **kw)
    got = run(*args)
    want = process_grid_planar_raw(*args, cfg=cfg, **kw)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


# ---------------------------------------------------------------------------
# mrsi_pipeline(mesh=) and spectral_pipeline_raw
# ---------------------------------------------------------------------------


def test_mrsi_pipeline_mesh_matches_reference():
    """The reference's GSPMD-sharded front-end (its single pivot is a
    global argmax) against the port's election over ``Mesh([cpu] * 8)``:
    the same pivot, p0 within 0.5 deg, and the port's own unsharded call
    bit for bit."""
    da = make_grid(nx=8, ny=2)
    kw = dict(zero_fill_to=512, lb=5.0, autophase="single", ap_optimizer="grid")
    ref = ref_mrsi_pipeline(da, cfg=RefConfig(**kw), engine="planar",
                            mesh=ref_make_mesh(8))
    out = mrsi_pipeline(_port(da), cfg=PipelineConfig(**kw), mesh=CPU8,
                        device="cpu")
    assert out.attrs["phase_pivot"] == pytest.approx(ref.attrs["phase_pivot"],
                                                     rel=1e-6)
    d = (out.attrs["phase_p0"] - ref.attrs["phase_p0"] + 180.0) % 360.0 - 180.0
    assert abs(d) <= 0.5
    one = mrsi_pipeline(_port(da), cfg=PipelineConfig(**kw), device="cpu")
    np.testing.assert_array_equal(out.values, one.values)
    for k in ("phase_p0", "phase_p1", "phase_pivot"):
        assert out.attrs[k] == one.attrs[k]


@pytest.mark.parametrize("autophase", ["single", "all", "none"])
def test_mrsi_pipeline_mesh_pads_and_trims(autophase):
    """12 voxels over 8 shards: zero rows pad to 16, never win the
    election, and are trimmed; the result is the unsharded call's."""
    da = _port(make_grid(nx=4, ny=3, n=128))
    cfg = PipelineConfig(zero_fill_to=256, lb=3.0, autophase=autophase,
                         ap_optimizer="grid", p0_only=autophase == "all")
    out = mrsi_pipeline(da, cfg=cfg, mesh=CPU8, device="cpu")
    one = mrsi_pipeline(da, cfg=cfg, device="cpu")
    assert out.dims == one.dims and out.shape == one.shape
    np.testing.assert_array_equal(out.values, one.values)
    for k in ("phase_p0", "phase_p1", "phase_pivot"):
        if autophase != "none":
            np.testing.assert_array_equal(out.attrs[k], one.attrs[k])


def test_spectral_pipeline_raw_matches_reference():
    """The complex batch in, complex spectra out: within 1e-6 max|S| of
    the reference's (float32 planes here, complex128 there)."""
    rows = np.asarray(make_grid(nx=4, ny=4, n=128).values).reshape(16, 128)
    t = np.arange(256) / 4000.0
    weight = np.exp(-np.pi * 5.0 * t)
    freqs = np.fft.fftshift(np.fft.fftfreq(256, d=t[1] - t[0]))
    kw = dict(zero_fill_to=256, lb=5.0, autophase="none")
    ref, _ = ref_spectral_raw(jnp.asarray(rows), jnp.asarray(weight),
                              jnp.asarray(freqs), RefConfig(**kw))
    spec, (p0, _, _) = spectral_pipeline_raw(rows, weight, freqs,
                                             PipelineConfig(**kw), device="cpu")
    assert spec.dtype == torch.complex128 and spec.shape == (16, 256)
    ref = np.asarray(ref)
    assert np.max(np.abs(spec.numpy() - ref)) <= 1e-6 * np.max(np.abs(ref))
    assert float(p0) == 0.0


# ---------------------------------------------------------------------------
# fit_amares(mesh=)
# ---------------------------------------------------------------------------


def _maps(ds, names=MAPS):
    return {n: np.asarray(ds[n].values, dtype=np.float64) for n in names}


def test_fit_amares_mesh_matches_reference(mesh_pk):
    """11 voxels over 8 devices (edge-padded to 16, trimmed), the tensor
    engine in both packages: parameters rtol/atol 2e-3, CRLB % 2e-2."""
    da = mesh_phantom(11)
    ref = _maps(ref_fit_amares(da, mesh_pk, engine="xla", return_curves=False,
                               mesh=8))
    got = _maps(fit_amares(_port(da), mesh_pk, engine="xla", return_curves=False,
                           mesh=8, device="cpu"))
    np.testing.assert_array_equal(got.pop("fit_converged"), ref.pop("fit_converged"))
    crlb, crlb_ref = got.pop("crlb"), ref.pop("crlb")
    np.testing.assert_allclose(crlb, crlb_ref, rtol=2e-2, atol=1e-4)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fit_amares_mesh_matches_one_device(mesh_pk, engine):
    """``tests/test_public_mesh.py``'s bar (rtol 2e-6 on its maps): the
    padded, sharded fit against the one-device fit, by a count, a mesh
    object, ``"auto"`` (one device on the CPU) and with staged planes."""
    da = _port(mesh_phantom(11, n_points=128))
    kw = dict(engine=engine, return_curves=False, device="cpu")
    ref = _maps(fit_amares(da, mesh_pk, **kw), PUBLIC_MESH_MAPS)
    staged = stage_device_fids(da, device="cpu")
    for mesh, extra in ((8, {}), (make_mesh(4, device="cpu"), {}),
                        ("auto", {}), (8, {"device_fids": staged})):
        got = _maps(fit_amares(da, mesh_pk, mesh=mesh, **kw, **extra),
                    PUBLIC_MESH_MAPS)
        for name, want in ref.items():
            np.testing.assert_allclose(got[name], want, rtol=2e-6, atol=1e-8,
                                       err_msg=f"{mesh}: {name}")


def test_fit_amares_mesh_errors(mesh_pk):
    """``tests/test_public_mesh.py:109-142``: a bad string, a bad object
    and a multi-axis mesh raise ``ValueError`` before any work."""
    da = _port(mesh_phantom(4))
    kw = dict(engine="xla", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        fit_amares(da, mesh_pk, mesh="everything", **kw)
    with pytest.raises(ValueError, match="expected a Mesh"):
        fit_amares(da, mesh_pk, mesh=2.0, **kw)
    two_axes = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("a", "b"))
    with pytest.raises(ValueError, match="1-D mesh"):
        fit_amares(da, mesh_pk, mesh=two_axes, **kw)
