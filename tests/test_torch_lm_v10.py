"""The port's whole-loop LM (K8, ``kernel_version=10``) against the JAX
package, and the grid program at versions 10 and 3.

* The plain K8 against the reference's ``lm_loop_pallas_v10`` in interpret
  mode.  That program segfaults XLA:CPU late in a long compile history
  (``docs/xla_cpu_segfault.md``), so it runs in a fresh subprocess, at the
  size of ``tests/test_lm_pallas_v10.py`` (3 voxels, 512 points,
  ``v_tile=2``), which writes its outputs to a file.
* The ``kernel_version=10`` driver against the reference's v9 driver,
  in-process, on the five cases of ``test_lm_pallas_v10.py`` with its
  tolerances (x rtol/atol 1e-4, cost rtol 1e-5, equal accepted-step counts,
  H rtol 1e-3 / atol 1e-4 * max).
* ``process_grid_planar_raw`` at versions 10 and 3 against the reference
  program (v9 for the whole loop, in-process; v3 itself) with
  ``test_torch_slice.py``'s tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from test_fitting import PK_CSV as FREE_G_CSV, make_phantom
from test_torch_lm_family import LORENTZ_CSV

from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import lm_loop_cuda
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

ROOT = Path(__file__).resolve().parents[1]

_REF_V10 = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from xmris_tpu.fitting import lm
from xmris_tpu.fitting.prior import load_prior_knowledge
from xmris_tpu.ops.kernels.lm_pallas import lm_loop_pallas_v10

d = np.load(sys.argv[1])
pk = load_prior_knowledge(sys.argv[2])
ps = lm.hashable_pmap(pk.pmap)
active = lm.active_param_rows(ps)
kw = dict(
    n_peaks=ps[3], mhz=float(d["mhz"]), active=active,
    g_zero=lm.lorentzian_env_flags(ps), n_free=pk.n_free,
    fold_slots=tuple(int(ps[0][j]) for j in active),
    fold_scales=tuple(float(ps[1][j]) for j in active),
    pmap_idx=tuple(int(v) for v in ps[0]),
    pmap_scale=tuple(float(v) for v in ps[1]),
    pmap_offset=tuple(float(v) for v in ps[2]),
    max_iter=int(d["max_iter"]), v_tile=2, interpret=True,
)
args = (jnp.asarray(d["u0"]), jnp.asarray(d["re"]), jnp.asarray(d["im"]),
        jnp.asarray(d["t"]), jnp.asarray(pk.lower), jnp.asarray(pk.upper),
        jnp.asarray(pk.kind))
out = {}
for fac in (True, False):
    u, cost, n_acc, done, h = lm_loop_pallas_v10(*args, factored_t=fac, **kw)
    for name, a in (("u", u), ("cost", cost), ("n_acc", n_acc),
                    ("done", done), ("h", h)):
        out[f"{name}_{int(fac)}"] = np.asarray(a)
np.savez(sys.argv[3], **out)
"""


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


@pytest.fixture(scope="module")
def reference_v10(tmp_path_factory):
    """The reference kernel's outputs (factored and direct basis), from a
    fresh subprocess, with its inputs."""
    tmp = tmp_path_factory.mktemp("v10")
    pk, _ = load_priors(LORENTZ_CSV, tmp)
    n_points = 512
    da = make_phantom(n_voxels=3, n_points=n_points)
    fids = np.asarray(da.transpose("voxel", "time").values).astype(np.complex64)
    u0 = jlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    ins = dict(re=np.ascontiguousarray(fids.real),
               im=np.ascontiguousarray(fids.imag),
               t=(np.arange(n_points) / 10000.0).astype(np.float32),
               u0=np.broadcast_to(u0.astype(np.float32), (3, pk.n_free)).copy(),
               mhz=np.float64(120.0), max_iter=np.int64(25))
    np.savez(tmp / "in.npz", **ins)
    env = dict(os.environ, XMT_NO_COMPILE_CACHE="1")
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_V10, str(tmp / "in.npz"),
         str(tmp / "pk.csv"), str(tmp / "out.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return pk, ins, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("factored", [True, False])
def test_lm_loop_v10_plain_matches_reference_kernel(reference_v10, factored):
    pk, ins, ref = reference_v10
    ps = tlm.hashable_pmap(pk.pmap)
    plan = tlm.normal_eq_plan(ps, pk.n_free, 120.0, factored)
    f32 = lambda a: _t(np.asarray(a, np.float32))  # noqa: E731
    u, cost, n_acc, done, h = lm_loop_cuda.lm_loop_v10(
        _t(ins["u0"]), _t(ins["re"]), _t(ins["im"]), _t(ins["t"]),
        f32(pk.lower), f32(pk.upper), _t(pk.kind), plan, ps, max_iter=25)
    k = int(factored)
    np.testing.assert_allclose(u.numpy(), ref[f"u_{k}"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cost.numpy(), ref[f"cost_{k}"], rtol=1e-5)
    np.testing.assert_array_equal(n_acc.numpy(), ref[f"n_acc_{k}"])
    np.testing.assert_array_equal(done.numpy(), ref[f"done_{k}"])
    assert done.all()
    h_ref = ref[f"h_{k}"]
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(h_ref).max())


_CASES = {
    "lorentzian": (LORENTZ_CSV, 512, {}, 0.0),
    "voigt_fixed_g": (LORENTZ_CSV.replace("g,0,0", "g,0.3,0.3"), 512, {}, 0.0),
    "tied_amplitude": (LORENTZ_CSV.replace("amplitude,10.0,5.0",
                                           "amplitude,10.0,0.5*PCr"), 256, {},
                       0.0),
    "direct_basis": (LORENTZ_CSV, 320, {}, 0.0),
    "loose_ftol": (LORENTZ_CSV, 512, {"ftol": 0.5}, 0.5),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_v10_driver_matches_reference_v9_driver(tmp_path, case):
    csv, n_points, kw, u0_shift = _CASES[case]
    pk, _ = load_priors(csv, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    da = make_phantom(n_voxels=3, n_points=n_points)
    fids = np.asarray(da.transpose("voxel", "time").values).astype(np.complex64)
    t = (np.arange(n_points) / 10000.0).astype(np.float32)
    u0 = jlm.external_to_internal(pk.init_free, pk.lower, pk.upper,
                                  pk.kind) + u0_shift
    args = (np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag),
            t, u0, pk.lower, pk.upper, pk.kind)
    r9, h9 = jlm.lm_fit_batched_pallas(
        *(jnp.asarray(a) for a in args), ps, 120.0, max_iter=25, v_tile=2,
        interpret=True, kernel_version=9, return_hessian=True, **kw)
    K.reset_counters()
    r10, h10 = tlm.lm_fit_batched_pallas(
        *(_t(a) for a in args), ps, 120.0, max_iter=25, kernel_version=10,
        return_hessian=True, **kw)
    assert K.counters()["plain_calls"]["lm_loop_v10"] == 1
    np.testing.assert_allclose(r10.x_free.numpy(), np.asarray(r9.x_free),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r10.cost.numpy(), np.asarray(r9.cost), rtol=1e-5)
    np.testing.assert_array_equal(r10.n_iter.numpy(), np.asarray(r9.n_iter))
    assert r10.converged.all()
    h9 = np.asarray(h9)
    np.testing.assert_allclose(h10.numpy(), h9, rtol=1e-3,
                               atol=1e-4 * np.abs(h9).max())


def test_v10_refuses_the_varpro_prior(tmp_path):
    """The v10 whole loop (K8) refuses a free-g prior: the VARPRO override
    it turns on is a launch-loop step, so at 10 the fit goes to the v9 loop
    as in the reference (``whole_loop`` is off): the port runs K2 and K3
    (their plain versions here), never K8, and matches its own v9 fit bit
    for bit."""
    pk, _ = load_priors(FREE_G_CSV, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    fids, t, _ = bench_phantom(n_voxels=2, n_t=128)
    u0 = jlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    args = (_t(fids.real), _t(fids.imag), _t(t), _t(u0), _t(pk.lower),
            _t(pk.upper), _t(pk.kind))
    K.reset_counters()
    r10 = tlm.lm_fit_batched_pallas(*args, ps, MHZ, kernel_version=10)
    plain = K.counters()["plain_calls"]
    assert plain["lm_loop_v10"] == 0 and plain["eq6_normal_eq_v9"] > 0
    r9 = tlm.lm_fit_batched_pallas(*args, ps, MHZ, kernel_version=9)
    for a, b in zip(r10, r9):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The grid program at versions 10 and 3
# ---------------------------------------------------------------------------

ZF, WEIGHT, FREQS = spectral_constants()


@pytest.fixture(scope="module")
def grid_case(tmp_path_factory):
    fids, t, amp = bench_phantom(n_voxels=12)
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path_factory.mktemp("pk"))
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    return pk, amp, args, kw


@pytest.mark.parametrize("version,ref_version", [(10, 9), (3, 3)])
def test_process_grid_matches_reference(grid_case, version, ref_version):
    pk, amp, args, kw = grid_case
    ref_cfg = RefConfig(zero_fill_to=ZF, lb=5.0, autophase="single",
                        dft_variant="pallas", spec_layout="stacked",
                        ap_optimizer="grid")
    ref = ref_process(*(jnp.asarray(a.numpy()) for a in args), cfg=ref_cfg,
                      interpret=True, kernel_version=ref_version, **kw)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    cfg = PipelineConfig(zero_fill_to=ZF, autophase="single",
                         spec_layout="stacked", ap_optimizer="grid")
    K.reset_counters()
    got = process_grid_planar_raw(*args, cfg=cfg, kernel_version=version, **kw)
    plain = K.counters()["plain_calls"]
    # On the CPU the pivot search is the torch search, not K5s's twin.
    path = set(K.PATHS[f"grid_single_pivot_v{version}"]) - {"acme_search"}
    assert all(plain[name] > 0 for name in path)
    assert all(plain[name] == 0 for name in plain if name not in path)
    *_, x_r, cost_r, conv_r, sds_r = ref
    *_, x, cost, conv, sds = got
    assert conv.all() and conv_r.all()
    np.testing.assert_allclose(cost.numpy(), cost_r, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_r, rtol=2e-2, atol=1e-4)
    slot = int(pk.pmap.idx[0])
    assert np.median(np.abs(x.numpy()[:, slot] - amp) / amp) <= 0.05


def test_seeded_fit_spd_pallas_false_matches_kernel_step(grid_case):
    """v9 without the kernel SPD solve is the dense path (the plain
    spd_solve_small step, K2's slab made dense, the plain inverse
    diagonal): the same fit as the slab path."""
    _, _, args, kw = grid_case
    fit_args = (args[0], args[1], *args[4:])
    K.reset_counters()
    x, cost, conv, sds = tam.seeded_fit_grid_raw(*fit_args, **kw,
                                                 spd_pallas=False)
    plain = K.counters()["plain_calls"]
    assert plain["eq6_normal_eq_v9"] > 0
    assert plain["spd_solve_damped"] == plain["spd_solve_damped_dense"] == 0
    assert plain["spd_inverse_diag"] == plain["spd_inverse_diag_dense"] == 0
    x2, cost2, conv2, sds2 = tam.seeded_fit_grid_raw(*fit_args, **kw)
    assert conv.all() and conv2.all()
    np.testing.assert_allclose(cost.numpy(), cost2.numpy(), rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x2.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds2.numpy(), rtol=2e-2, atol=1e-4)


def test_fit_amares_v10_matches_v9(tmp_path):
    """fit_amares(kernel_version=10) on the CPU (the plain K8) lands on the
    v9 engine's maps (held against the reference in
    test_torch_fit_amares.py) at the v10 tolerances."""
    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.amares import fit_amares

    grid = (2, 2, 1)
    fids, _, _ = bi.make_inputs(grid)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(grid + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    K.reset_counters()
    ds10 = fit_amares(da, pk, device="cpu", engine="pallas", kernel_version=10,
                      return_curves=False)
    assert K.counters()["plain_calls"]["lm_loop_v10"] == 2  # two LM passes
    ds9 = fit_amares(da, pk, device="cpu", engine="pallas", return_curves=False)
    assert ds10["fit_converged"].values.all()
    for name in ("amplitude", "chem_shift", "linewidth", "phase"):
        np.testing.assert_allclose(ds10[name].values, ds9[name].values,
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(ds10["crlb"].values, ds9["crlb"].values,
                               rtol=1e-3)
