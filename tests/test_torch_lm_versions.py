"""The rest of the LM kernel family against the JAX package: K14/K13 (v1/v2),
K11 (v6), K10 (v7), K9 (v8) and K2's accept gate, the LM driver at each of
those versions and with ``gate_rejects``, and the grid program at v8 and v7.

On the CPU each wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do.  Inputs: 2-3 peaks,
n_t = 256 (v7's two 128-sample blocks), B = 13 voxels (the reference pads
its tile of 4).  Tolerances are the reference tests':

* every kernel against its reference kernel: cost rtol 1e-5, g/H rtol
  1e-4 with atol 1e-3 * max (``test_lm_pallas.py:53-86`` for v1/v2,
  ``:403-438`` for v7, ``:575-607`` for v8), and g and H also per entry at
  1e-3 of their Cauchy-Schwarz bound
  (``test_torch_lm_family._assert_rows_at_their_scale``);
* v1/v2 also, each side on its own, against a float64 evaluation at the
  reference test's yardstick (cost rtol 1e-5, g/H rtol 1e-4 with atol
  1e-3 * max); the port's side runs in a fresh subprocess;
* v6: the reference holds it against v3's subset at cost rtol 1e-6, g
  rtol 1e-5 / atol 1e-4, H rtol 1e-5 (``:277-304``), two kernels sharing
  every elementwise operation.  Across the packages exp/sin/cos and the
  sums round differently (g entries differ by up to 2e-4 relative), so v6
  is held to the reference v6 at the tolerance above and to the port's v5
  bit for bit; masked runs keep their unmasked voxels exact (the reference
  at rtol 1e-6, ``:306-333``; the port bit for bit);
* the v7 and v8 ``ValueError``s (``:482-546``, ``:609-641``);
* the gate: the gated cost equals the open one (``:1246-1273``);
* the LM driver: ``test_torch_lm_family.py``'s (x rtol/atol 1e-4, cost rtol
  1e-5, equal accepted steps, H rtol 1e-3 / atol 1e-4 * max);
* the grid: ``test_torch_slice.py``'s (cost rtol 1e-4, x rtol/atol 2e-3,
  CRLB rtol 2e-2 / atol 1e-4).

``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
a card.
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
from xmris_tpu.ops.kernels import lm_pallas as jlp
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.process import process_grid_planar_raw as ref_process

from test_fitting import make_phantom
from test_lm_pallas import sane_grids
from test_torch_lm_family import (
    LORENTZ_CSV,
    _assert_rows_at_their_scale,
    _driver_inputs,
)

from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import lm_cuda, lm_jac_cuda
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.process import (
    grid_inputs_from_numpy,
    process_grid_planar_raw,
)

from _torch_parity import MHZ, load_priors, spectral_constants

B, N_T, V_TILE = 13, 256, 4
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _inputs(k, seed, b=B, n_t=N_T):
    grids = sane_grids(b, k, seed=seed)
    rng = np.random.default_rng(seed)
    yre = rng.normal(size=(b, n_t)).astype(np.float32)
    yim = rng.normal(size=(b, n_t)).astype(np.float32)
    t = (np.arange(n_t) / 5000.0).astype(np.float32)
    return grids, yre, yim, t


def _both(arrays):
    return tuple(jnp.asarray(a) for a in arrays), tuple(_t(a) for a in arrays)


def _assert_family_close(got, want):
    """The reference kernel tests' check (cost rtol 1e-5, g and H rtol 1e-4
    with atol 1e-3 * max) plus the per-entry check."""
    cost, g, h = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), cost, rtol=1e-5)
    for x, x_ref in ((got[1], g), (got[2], h)):
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-4,
                                   atol=1e-3 * np.abs(x_ref).max())
    _assert_rows_at_their_scale(got, (cost, g, h))


# ---------------------------------------------------------------------------
# K14 / K13: v1 and v2 are K7's function
# ---------------------------------------------------------------------------


# The port's side of the v1/v2 test, run in a fresh interpreter: in a pytest
# worker that had run JAX-package files with large XLA:CPU compile histories
# (test_fuzz_fit.py, test_fuzz_parallel.py) the plain version once returned
# other float32 costs on the second of the two chunks into which torch
# splits its 3328-element transcendentals (ROADMAP.md, queue 3).
_PORT_V1_V2 = r"""
import sys
import numpy as np
import torch
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import lm_jac_cuda

d = np.load(sys.argv[1])
version, k, mhz = int(d["version"]), int(d["k"]), float(d["mhz"])
args = tuple(torch.from_numpy(d[n]) for n in ("grids", "yre", "yim", "t"))
port = {1: lm_jac_cuda.eq6_normal_equations_v1,
        2: lm_jac_cuda.eq6_normal_equations_v2}[version]
K.reset_counters()
got = port(*args, k, mhz)
calls = K.counters()["plain_calls"][f"eq6_normal_eq_v{version}"]
v3 = lm_jac_cuda.eq6_normal_equations_v3(*args, k, mhz)
np.savez(sys.argv[2], calls=calls,
         **{f"got{i}": a.numpy() for i, a in enumerate(got)},
         **{f"v3_{i}": a.numpy() for i, a in enumerate(v3)})
"""


def _float64_normal_eq(grids, yre, yim, t, k):
    """Cost, g and H of the explicit-Jacobian normal equations in float64:
    the yardstick ``test_lm_pallas.py:53-86`` holds the reference v1/v2
    kernels to."""
    p = grids.astype(np.float64).reshape(-1, k, 5)
    t = t.astype(np.float64)
    w_unit = 2.0 * np.pi * MHZ
    m = np.zeros(yre.shape, np.complex128)
    cols = []
    for j in range(k):
        amp, cs, lw, ph, gg = (p[:, j, c:c + 1] for c in range(5))
        dp = (1.0 - gg + gg * t) * t
        basis = amp * np.exp(-np.pi * lw * dp) * np.exp(
            1j * (w_unit * cs * t + np.deg2rad(ph)))
        m += basis
        safe = np.where(amp == 0, 1.0, amp)
        cols += [basis / safe, 1j * w_unit * t * basis, -np.pi * dp * basis,
                 1j * (np.pi / 180.0) * basis, -np.pi * lw * (t * t - t) * basis]
    r = yre.astype(np.float64) + 1j * yim.astype(np.float64) - m
    jac = np.stack(cols, 1)  # (B, 5K, n_t)
    cost = (np.abs(r) ** 2).sum(-1)
    g = (jac.real * r.real[:, None] + jac.imag * r.imag[:, None]).sum(-1)
    h = (np.einsum("bin,bjn->bij", jac.real, jac.real)
         + np.einsum("bin,bjn->bij", jac.imag, jac.imag))
    return cost, g, h


@pytest.mark.parametrize("version", [1, 2])
def test_v1_v2_match_reference(version, tmp_path):
    k = 2
    arrays = _inputs(k, seed=version)
    jargs, _ = _both(arrays)
    ref_fn = {1: jlp.eq6_normal_equations_pallas,
              2: jlp.eq6_normal_equations_pallas_v2}[version]
    want = ref_fn(*jargs, n_peaks=k, mhz=MHZ, v_tile=V_TILE, interpret=True)
    np.savez(tmp_path / "in.npz", version=version, k=k, mhz=MHZ,
             **dict(zip(("grids", "yre", "yim", "t"), arrays)))
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_V1_V2, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    assert int(out["calls"]) == 1
    got = tuple(torch.from_numpy(out[f"got{i}"]) for i in range(3))
    # Each side against float64 first, so that a failure says which moved.
    cost64, g64, h64 = _float64_normal_eq(*arrays, k)
    for side in (got, want):
        np.testing.assert_allclose(np.asarray(side[0]), cost64, rtol=1e-5)
        for x, x64 in ((side[1], g64), (side[2], h64)):
            np.testing.assert_allclose(np.asarray(x), x64, rtol=1e-4,
                                       atol=1e-3 * np.abs(x64).max())
    _assert_family_close(got, want)
    # One function, one set of operations: K7's plain version bit for bit.
    for i, a in enumerate(got):
        assert np.array_equal(a.numpy(), out[f"v3_{i}"])


# ---------------------------------------------------------------------------
# K11: v6 (active rows, voxel mask)
# ---------------------------------------------------------------------------

ACTIVE3 = tuple(j for j in range(15) if j % 5 != 4 and j != 8)


def test_v6_matches_reference():
    k = 3
    jargs, targs = _both(_inputs(k, seed=6))
    want = jlp.eq6_normal_equations_pallas_v6(
        *jargs, n_peaks=k, mhz=MHZ, active=ACTIVE3, v_tile=V_TILE,
        interpret=True)
    got = lm_jac_cuda.eq6_normal_equations_v6(*targs, k, MHZ, ACTIVE3)
    _assert_family_close(got, want)
    for a, b in zip(got, lm_jac_cuda.eq6_normal_equations_v5(*targs, k, MHZ,
                                                             ACTIVE3)):
        assert torch.equal(a, b)


def test_v6_voxel_mask_keeps_unmasked_voxels_exact():
    """Masked voxels may be skipped; unmasked ones stay exact (the
    reference skips whole tiles: its first tile holds the unmasked voxel)."""
    k = 2
    jargs, targs = _both(_inputs(k, seed=7))
    active = tuple(range(5 * k))
    mask = np.zeros(B, bool)
    mask[0] = True
    ref_full = jlp.eq6_normal_equations_pallas_v6(
        *jargs, n_peaks=k, mhz=MHZ, active=active, v_tile=V_TILE,
        interpret=True)
    ref_part = jlp.eq6_normal_equations_pallas_v6(
        *jargs, n_peaks=k, mhz=MHZ, active=active, voxel_mask=jnp.asarray(mask),
        v_tile=V_TILE, interpret=True)
    full = lm_jac_cuda.eq6_normal_equations_v6(*targs, k, MHZ, active)
    part = lm_jac_cuda.eq6_normal_equations_v6(*targs, k, MHZ, active,
                                               voxel_mask=_t(mask))
    for f, p, rf, rp in zip(full, part, ref_full, ref_part):
        assert p.shape == f.shape
        assert torch.equal(p[mask], f[mask])
        np.testing.assert_allclose(np.asarray(rp)[:V_TILE],
                                   np.asarray(rf)[:V_TILE], rtol=1e-6)
    _assert_family_close(tuple(x[mask] for x in part),
                         tuple(np.asarray(x)[mask] for x in ref_part))


# ---------------------------------------------------------------------------
# K10: v7 (block-factored basis)
# ---------------------------------------------------------------------------


def test_v7_matches_reference():
    """Peak 0 is purely Lorentzian (its whole basis factors), peaks 1-2
    keep their g (the angle factors, the envelope stays per sample)."""
    k = 3
    grids, yre, yim, t = _inputs(k, seed=11)
    grids[:, 4] = 0.0
    jargs, targs = _both((grids, yre, yim, t))
    active = tuple(j for j in range(5 * k) if j != 4)
    env_fast = (True, False, False)
    want = jlp.eq6_normal_equations_pallas_v7(
        *jargs, n_peaks=k, mhz=MHZ, active=active, env_fast=env_fast,
        v_tile=V_TILE, interpret=True)
    K.reset_counters()
    got = lm_jac_cuda.eq6_normal_equations_v7(*targs, k, MHZ, active, env_fast)
    assert K.counters()["plain_calls"]["eq6_normal_eq_v7"] == 1
    _assert_family_close(got, want)


def test_v7_refuses_what_the_reference_refuses():
    k = 1
    grids = sane_grids(2, k)
    y = np.zeros((2, N_T), np.float32)
    kw = dict(n_peaks=k, mhz=MHZ, active=tuple(range(5)), env_fast=(False,))

    def both(t, n_t=N_T):
        jargs, targs = _both((grids, y[:, :n_t], y[:, :n_t], t))
        ref = lambda: jlp.eq6_normal_equations_pallas_v7(  # noqa: E731
            *jargs, **kw, v_tile=2, interpret=True)
        port = lambda: lm_jac_cuda.eq6_normal_equations_v7(  # noqa: E731
            *targs, k, MHZ, kw["active"], kw["env_fast"])
        return ref, port

    t_bad = np.cumsum(np.random.default_rng(0).uniform(0.5, 1.5, N_T)
                      ).astype(np.float32)
    for fn in both(t_bad):
        with pytest.raises(ValueError, match="uniform"):
            fn()
    # f32-quantization wobble that the LM driver's tolerance accepts
    t_w = (np.arange(N_T, dtype=np.float64) / 5000.0).astype(np.float32)
    t_w[10] += np.float32(6e-8)
    assert jlm._t_is_uniform(t_w) and tlm._t_is_uniform(_t(t_w))
    for fn in both(t_w):
        assert np.isfinite(np.asarray(fn()[0])).all()
    for fn in both(np.arange(200, dtype=np.float32), n_t=200):
        with pytest.raises(ValueError, match="n_t % 128"):
            fn()


# ---------------------------------------------------------------------------
# K9: v8 (three moments, purely Lorentzian)
# ---------------------------------------------------------------------------


def test_v8_matches_reference():
    k = 3
    grids, yre, yim, t = _inputs(k, seed=21)
    grids[:, 4::5] = 0.0
    jargs, targs = _both((grids, yre, yim, t))
    active = tuple(j for j in range(5 * k) if j % 5 != 4)
    want = jlp.eq6_normal_equations_pallas_v8(
        *jargs, n_peaks=k, mhz=MHZ, active=active, v_tile=V_TILE,
        interpret=True)
    K.reset_counters()
    got = lm_cuda.eq6_normal_equations_v8(*targs, k, MHZ, active)
    assert K.counters()["plain_calls"]["eq6_normal_eq_v8"] == 1
    assert got[2].shape == (B, len(active), len(active))
    _assert_family_close(got, want)


@pytest.mark.parametrize("case", ["free_g", "fixed_nonzero_g"])
def test_v8_refuses_what_the_reference_refuses(case):
    grids = sane_grids(2, 1)
    if case == "free_g":
        active, match = tuple(range(5)), "Lorentzian"
    else:
        grids[:, 4] = 0.5
        active, match = tuple(range(4)), "AT 0"
    y = np.zeros((2, 128), np.float32)
    jargs, targs = _both((grids, y, y, np.arange(128, dtype=np.float32)))
    with pytest.raises(ValueError, match=match):
        jlp.eq6_normal_equations_pallas_v8(*jargs, n_peaks=1, mhz=MHZ,
                                           active=active, v_tile=2,
                                           interpret=True)
    with pytest.raises(ValueError, match=match):
        lm_cuda.eq6_normal_equations_v8(*targs, 1, MHZ, active)


# ---------------------------------------------------------------------------
# K2's accept gate
# ---------------------------------------------------------------------------


def test_accept_gate_cost_always_valid():
    k = 2
    jargs, targs = _both(_inputs(k, seed=3))
    active = tuple(range(5 * k))
    c_ref = jlp.eq6_normal_equations_pallas_v9(
        *jargs, n_peaks=k, mhz=MHZ, active=active, g_zero=(False,) * k,
        v_tile=V_TILE, interpret=True,
        cost_prev=jnp.zeros((B,), jnp.float32))[0]
    plan = lm_cuda.NormalEqPlan(
        n_peaks=k, n_free=5 * k, mhz=MHZ, active=active, g_zero=(False,) * k,
        fold_slots=active, fold_scales=(1.0,) * (5 * k), factored=False)
    dxdu = torch.ones((B, 5 * k))
    open_ = lm_cuda.eq6_normal_equations(*targs, dxdu, plan)
    gated = lm_cuda.eq6_normal_equations(*targs, dxdu, plan,
                                         cost_prev=torch.zeros(B))
    assert torch.equal(gated[0], open_[0])
    np.testing.assert_allclose(gated[0].numpy(), np.asarray(c_ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# The LM driver at each new version and with gate_rejects
# ---------------------------------------------------------------------------

VOIGT_FIXED_CSV = LORENTZ_CSV.replace("g,0,0", "g,0.3,0.3")

# case -> (prior, n_points, port version, reference version, LM options,
#          the normal-equations counter the port must take)
_DRIVER_CASES = {
    "v1": (LORENTZ_CSV, 256, 1, 1, {}, "eq6_normal_eq_v1"),
    "v2": (LORENTZ_CSV, 256, 2, 2, {}, "eq6_normal_eq_v2"),
    "v6": (LORENTZ_CSV, 256, 6, 6, {}, "eq6_normal_eq_v6"),
    "v7": (LORENTZ_CSV, 256, 7, 7, {}, "eq6_normal_eq_v7"),
    "v7_unaligned": (LORENTZ_CSV, 200, 7, 7, {}, "eq6_normal_eq_v6"),
    "v8": (LORENTZ_CSV, 256, 8, 8, {}, "eq6_normal_eq_v8"),
    "v8_voigt_falls_back": (VOIGT_FIXED_CSV, 256, 8, 8, {}, "eq6_normal_eq_v6"),
    "gate_v9": (LORENTZ_CSV, 256, 9, 9, {"gate_rejects": True},
                "eq6_normal_eq_v9"),
    "gate_v10": (LORENTZ_CSV, 256, 10, 9, {"gate_rejects": True},
                 "eq6_normal_eq_v9"),
}


@pytest.mark.parametrize("case", list(_DRIVER_CASES))
def test_driver_matches_reference(tmp_path, case):
    csv, n_points, version, ref_version, kw, counter = _DRIVER_CASES[case]
    _, args, ps = _driver_inputs(tmp_path, csv=csv, n_points=n_points)
    r_ref, h_ref = jlm.lm_fit_batched_pallas(
        *(jnp.asarray(a) for a in args), ps, MHZ, max_iter=25, v_tile=2,
        interpret=True, kernel_version=ref_version, return_hessian=True, **kw)
    K.reset_counters()
    res, h = tlm.lm_fit_batched_pallas(
        *(_t(a) for a in args), ps, MHZ, max_iter=25, kernel_version=version,
        return_hessian=True, **kw)
    plain = K.counters()["plain_calls"]
    evals = [n for n in plain if n.startswith("eq6_normal_eq") and plain[n]]
    assert evals == [counter]
    np.testing.assert_allclose(res.x_free.numpy(), np.asarray(r_ref.x_free),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(r_ref.cost),
                               rtol=1e-5)
    np.testing.assert_array_equal(res.n_iter.numpy(), np.asarray(r_ref.n_iter))
    assert res.converged.all() and np.asarray(r_ref.converged).all()
    h_ref = np.asarray(h_ref)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(h_ref).max())


def test_gated_fit_equals_the_open_fit(tmp_path):
    """The gate changes what is computed, not what is consumed: on the
    plain versions (which ignore it) the gated fit is the open fit."""
    _, args, ps = _driver_inputs(tmp_path, n_points=256)
    targs = tuple(_t(a) for a in args)
    open_ = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, max_iter=25)
    for v in (9, 10):
        gated = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, max_iter=25,
                                          kernel_version=v, gate_rejects=True)
        for a, b in zip(gated, open_):
            assert torch.equal(a, b)


def test_driver_v7_refuses_a_nonuniform_axis(tmp_path):
    _, args, ps = _driver_inputs(tmp_path, n_points=256)
    t_bad = args[2].copy()
    t_bad[7] += 1e-5
    bad = args[:2] + (t_bad,) + args[3:]
    with pytest.raises(ValueError, match="uniform") as ref_err:
        jlm.lm_fit_batched_pallas(*(jnp.asarray(a) for a in bad), ps, MHZ,
                                  kernel_version=7, v_tile=2, interpret=True)
    with pytest.raises(ValueError, match="uniform") as port_err:
        tlm.lm_fit_batched_pallas(*(_t(a) for a in bad), ps, MHZ,
                                  kernel_version=7)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# The grid program at v8 and v7
# ---------------------------------------------------------------------------

GRID_N_T, GRID_SW = 256, 10000.0
ZF, WEIGHT, FREQS = spectral_constants(n_t=GRID_N_T, sw=GRID_SW)


@pytest.fixture(scope="module")
def grid_case(tmp_path_factory):
    """Six voxels of ``test_fitting``'s two-peak phantom (PCr amplitude
    10 (v + 1)) under its Lorentzian prior: the 5-peak bench prior's v8
    kernel alone takes ~40 s to run in interpret mode."""
    pk, pkt = load_priors(LORENTZ_CSV, tmp_path_factory.mktemp("pk"))
    da = make_phantom(n_voxels=6, n_points=GRID_N_T, sw=GRID_SW, mhz=MHZ)
    fids = np.asarray(da.transpose("voxel", "time").values).astype(np.complex64)
    t = (np.arange(GRID_N_T) / GRID_SW).astype(np.float32)
    x_template = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ).astype(
        np.float32)
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    args = grid_inputs_from_numpy(fids, WEIGHT, FREQS, t, x_template, pkt,
                                  "cpu")
    return pk, 10.0 * np.arange(1, 7), args, kw


@pytest.mark.parametrize("version", [8, 7])
def test_process_grid_matches_reference(grid_case, version):
    pk, amp, args, kw = grid_case
    ref_cfg = RefConfig(zero_fill_to=ZF, lb=5.0, autophase="single",
                        dft_variant="pallas", spec_layout="stacked",
                        ap_optimizer="grid")
    ref = ref_process(*(jnp.asarray(a.numpy()) for a in args), cfg=ref_cfg,
                      interpret=True, kernel_version=version, v_tile=2, **kw)
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


# ---------------------------------------------------------------------------
# fit_amares at each new version
# ---------------------------------------------------------------------------

FIT_GRID = (2, 1, 1)


@pytest.fixture(scope="module")
def fit_case():
    """Two bench voxels as an (x, y, z, time) array, the bench prior, and
    the v9 engine's maps (held against the reference in
    ``test_torch_fit_amares.py``)."""
    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.amares import fit_amares
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text

    fids, _, _ = bi.make_inputs(FIT_GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    da = XmrArray(fids.reshape(FIT_GRID + (bi.N_TIME,)),
                  dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": bi.MHZ})
    pk = prior_from_csv_text(bi.PK_CSV)
    ds9 = fit_amares(da, pk, device="cpu", engine="pallas",
                     return_curves=False)
    return da, pk, ds9


@pytest.mark.parametrize("version", [1, 2, 6, 7, 8])
def test_fit_amares_runs_every_version(fit_case, version):
    """fit_amares(kernel_version=v) takes v's kernel on the bench prior
    (v7 the factored K10 at n_t = 1024, v8 K9) and lands on the v9
    engine's maps at the engines' tolerance (rtol/atol 2e-3)."""
    from xmris_tpu_torch.fitting.amares import fit_amares

    da, pk, ds9 = fit_case
    K.reset_counters()
    ds = fit_amares(da, pk, device="cpu", engine="pallas",
                    kernel_version=version, return_curves=False)
    plain = K.counters()["plain_calls"]
    evals = [n for n in plain if n.startswith("eq6_normal_eq") and plain[n]]
    assert evals == [f"eq6_normal_eq_v{version}"]
    assert ds["fit_converged"].values.all()
    for name in ("amplitude", "chem_shift", "linewidth", "phase", "crlb"):
        np.testing.assert_allclose(ds[name].values, ds9[name].values,
                                   rtol=2e-3, atol=2e-3, err_msg=name)
