"""The port's explicit-Jacobian LM path against the JAX package: the dense
damped solve (K6a), the v3/v5 normal equations (K7/K12), the non-slab LM
driver, ``crlb_batched_pallas`` and the ``kernel_version`` contract (the
other versions are held against the reference in
``test_torch_lm_versions.py``).

On the CPU each wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do.  Tolerances are the
reference tests':

* K6a: rtol 2e-6 / atol 1e-7, NaN exactly on non-SPD systems
  (``test_spd.py:49-96``);
* K7/K12: cost rtol 1e-5, g/H rtol 1e-4 with atol 1e-3 * max
  (``test_lm_pallas.py:53-86``); v5 on the v3 subset cost rtol 1e-6, g rtol
  1e-5 / atol 1e-4, H rtol 1e-5 / atol 1e-3 * max (``:154-187``);
* the driver: x rtol 1e-4 / atol 1e-4 (phases near 0 degrees need the
  atol), cost rtol 1e-5, equal accepted-step counts and the Hessian at
  rtol 1e-3 / atol 1e-4 * max (``test_lm_pallas.py:189-262``,
  ``test_lm_pallas_v10.py:99-111``).

``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.ops.kernels import spd as jspd
from xmris_tpu.ops.kernels.lm_pallas import (
    eq6_normal_equations_pallas_v3,
    eq6_normal_equations_pallas_v5,
)

from test_fitting import PK_CSV as FREE_G_CSV, make_phantom
from test_lm_pallas import sane_grids

from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import lm_jac_cuda, spd

from _torch_parity import BENCH_PK_CSV, bench_phantom, load_priors

MHZ = 120.0

# test_lm_pallas_v10.py's two-peak Lorentzian prior (g fixed at 0).
LORENTZ_CSV = (
    "Index,PCr,ATP\n"
    "Initial Values,,\n"
    "amplitude,10.0,5.0\n"
    "chemicalshift,0.0,-7.5\n"
    "linewidth,15.0,20.0\n"
    "phase,0,0\n"
    "g,0,0\n"
    "Bounds,,\n"
    'amplitude,"(0, ","(0, "\n'
    'chemicalshift,"(-0.5, 0.5)","(-8.0, -7.0)"\n'
    'linewidth,"(5.0, 30.0)","(10.0, 40.0)"\n'
    'phase,"(-180, 180)","(-180, 180)"\n'
    "g,fixed,fixed\n"
)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _spd_systems(b=13, f=10, seed=0, bad=(4,)):
    """float32 SPD (B, F, F) systems, right-hand sides and damping; the
    systems in ``bad`` are indefinite."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, f, f))
    h = a @ np.transpose(a, (0, 2, 1)) + f * np.eye(f)
    for v in bad:
        h[v, 0, 0] = -1.0
    g = rng.normal(size=(b, f))
    lam = rng.uniform(1e-5, 1e-2, size=b)
    return h.astype(np.float32), g.astype(np.float32), lam.astype(np.float32)


# ---------------------------------------------------------------------------
# K6a and the plain XLA forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [3, 10, 20])
def test_spd_solve_damped_dense_matches_reference(f):
    h, g, lam = _spd_systems(f=f, seed=f)
    want = np.asarray(jspd.spd_solve_damped_pallas(
        jnp.asarray(h), jnp.asarray(g), jnp.asarray(lam), v_tile=8,
        interpret=True))
    got = spd.spd_solve_damped_dense_plain(_t(h), _t(g), _t(lam)).numpy()
    bad = np.zeros(len(h), bool)
    bad[4] = True
    np.testing.assert_array_equal(np.isnan(got).all(1), bad)
    np.testing.assert_array_equal(np.isnan(want).any(1), bad)
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=2e-6, atol=1e-7)
    # The wrapper takes the plain version on the CPU, and K6a is K3's
    # arithmetic: equal to the slab solve on the same matrices, bit for bit.
    np.testing.assert_array_equal(
        spd.spd_solve_damped_dense(_t(h), _t(g), _t(lam)).numpy(), got)
    slab = _t(h).permute(1, 2, 0).reshape(f * f, -1).contiguous()
    np.testing.assert_array_equal(
        spd.spd_solve_damped_plain(slab, _t(g), _t(lam)).numpy(), got)


def test_spd_small_forms_match_reference():
    h, g, _ = _spd_systems(f=20, seed=7, bad=(2,))
    want = np.asarray(jspd.spd_solve_small(jnp.asarray(h), jnp.asarray(g)))
    got = spd.spd_solve_small(_t(h), _t(g)).numpy()
    np.testing.assert_array_equal(np.isnan(got).any(1), np.isnan(want).any(1))
    ok = ~np.isnan(want).any(1)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-6, atol=1e-7)
    want_d = np.asarray(jspd.spd_inverse_diag(jnp.asarray(h[ok])))
    got_d = spd.spd_inverse_diag_small(_t(h[ok])).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=2e-4)


# ---------------------------------------------------------------------------
# K7 / K12
# ---------------------------------------------------------------------------


def _jac_inputs(n_t, k, b=5, seed=None):
    seed = n_t if seed is None else seed
    rng = np.random.default_rng(seed)
    grids = sane_grids(b, k, seed=seed)
    yre = rng.normal(size=(b, n_t)).astype(np.float32)
    yim = rng.normal(size=(b, n_t)).astype(np.float32)
    t = (np.arange(n_t) / 5000.0).astype(np.float32)
    return grids, yre, yim, t


@pytest.mark.parametrize("version", [3, 5])
@pytest.mark.parametrize("n_t,k", [(256, 2), (512, 3)])
def test_jac_normal_equations_match_reference(version, n_t, k):
    grids, yre, yim, t = _jac_inputs(n_t, k)
    jargs = tuple(jnp.asarray(a) for a in (grids, yre, yim, t))
    targs = tuple(_t(a) for a in (grids, yre, yim, t))
    if version == 3:
        want = eq6_normal_equations_pallas_v3(*jargs, n_peaks=k, mhz=MHZ,
                                              v_tile=2, interpret=True)
        got = lm_jac_cuda.eq6_normal_equations_v3(*targs, k, MHZ)
    else:
        active = tuple(j for j in range(5 * k) if j % 5 != 4 and j != 8)
        want = eq6_normal_equations_pallas_v5(*jargs, n_peaks=k, mhz=MHZ,
                                              active=active, v_tile=2,
                                              interpret=True)
        got = lm_jac_cuda.eq6_normal_equations_v5(*targs, k, MHZ, active)
    cost, g, h = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), cost, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), g, rtol=1e-4,
                               atol=1e-3 * np.abs(g).max())
    np.testing.assert_allclose(got[2].numpy(), h, rtol=1e-4,
                               atol=1e-3 * np.abs(h).max())
    _assert_rows_at_their_scale(got, (cost, g, h))


def _assert_rows_at_their_scale(got, ref):
    """g and H within rtol 1e-4 plus, per entry, 1e-3 of its Cauchy-Schwarz
    bound (``sqrt(|H_ii H_jj|)``, ``sqrt(|H_ii| cost)``): the rows of H span
    orders of magnitude, so one atol from max|H| would not see a wrong
    amplitude or phase row."""
    cost, g, h = (np.asarray(a, np.float64) for a in ref)
    d = np.sqrt(np.abs(np.diagonal(h, axis1=1, axis2=2)))
    for x, x_ref, atol in (
        (got[1], g, 1e-3 * d * np.sqrt(np.abs(cost))[:, None]),
        (got[2], h, 1e-3 * d[:, :, None] * d[:, None, :]),
    ):
        err = np.abs(np.asarray(x, np.float64) - x_ref)
        assert (err <= atol + 1e-4 * np.abs(x_ref)).all(), float(
            (err / (atol + 1e-4 * np.abs(x_ref))).max())


def test_row_scaled_check_sees_a_wrong_amplitude_row():
    """One atol from max|H| lets an amplitude row 5 % off pass (shift rows
    are ~1e3 times larger); the per-entry check does not."""
    k = 3
    grids, yre, yim, t = _jac_inputs(256, k, b=4, seed=5)
    c, g, h = lm_jac_cuda.eq6_normal_equations_v3_plain(
        *(_t(a) for a in (grids, yre, yim, t)), k, MHZ)
    bad = h.clone()
    bad[:, 0, :] *= 1.05
    bad[:, :, 0] *= 1.05
    np.testing.assert_allclose(bad.numpy(), h.numpy(), rtol=1e-4,
                               atol=1e-3 * float(h.abs().max()))
    with pytest.raises(AssertionError):
        _assert_rows_at_their_scale((c, g, bad), (c, g, h))


def test_v5_is_v3_on_the_active_rows():
    k = 3
    grids, yre, yim, t = _jac_inputs(128, k, b=4, seed=4)
    args = tuple(_t(a) for a in (grids, yre, yim, t))
    active = tuple(j for j in range(5 * k) if j % 5 != 4 and j != 8)
    c3, g3, h3 = lm_jac_cuda.eq6_normal_equations_v3_plain(*args, k, MHZ)
    c5, g5, h5 = lm_jac_cuda.eq6_normal_equations_v5_plain(*args, k, MHZ,
                                                           active)
    sel = list(active)
    np.testing.assert_allclose(c5.numpy(), c3.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g5.numpy(), g3[:, sel].numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(h5.numpy(), h3[:, sel][:, :, sel].numpy(),
                               rtol=1e-5, atol=1e-3 * float(h3.abs().max()))
    _assert_rows_at_their_scale((c5, g5, h5),
                                (c3, g3[:, sel], h3[:, sel][:, :, sel]))


# ---------------------------------------------------------------------------
# The non-slab driver and crlb_batched_pallas
# ---------------------------------------------------------------------------


def _driver_inputs(tmp_path, csv=LORENTZ_CSV, n_voxels=3, n_points=256):
    pk, _ = load_priors(csv, tmp_path)
    da = make_phantom(n_voxels=n_voxels, n_points=n_points)
    fids = np.asarray(da.transpose("voxel", "time").values).astype(np.complex64)
    t = (np.arange(n_points) / 10000.0).astype(np.float32)
    u0 = jlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    args = (np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag),
            t, u0, pk.lower, pk.upper, pk.kind)
    return pk, args, jlm.hashable_pmap(pk.pmap)


@pytest.mark.parametrize("spd_pallas", [True, False])
@pytest.mark.parametrize("version", [3, 5])
def test_dense_driver_matches_reference(tmp_path, version, spd_pallas):
    pk, args, ps = _driver_inputs(tmp_path)
    r_ref, h_ref = jlm.lm_fit_batched_pallas(
        *(jnp.asarray(a) for a in args), ps, MHZ, max_iter=25, v_tile=1,
        interpret=True, kernel_version=version, return_hessian=True,
        spd_pallas=spd_pallas)
    K.reset_counters()
    res, h = tlm.lm_fit_batched_pallas(
        *(_t(a) for a in args), ps, MHZ, max_iter=25, kernel_version=version,
        return_hessian=True, spd_pallas=spd_pallas)
    counts = K.counters()["plain_calls"]
    assert counts[f"eq6_normal_eq_v{version}"] > 0
    assert (counts["spd_solve_damped_dense"] > 0) == spd_pallas
    assert counts["eq6_normal_eq_v9"] == counts["spd_solve_damped"] == 0
    np.testing.assert_allclose(res.x_free.numpy(), np.asarray(r_ref.x_free),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(r_ref.cost),
                               rtol=1e-5)
    np.testing.assert_array_equal(res.n_iter.numpy(), np.asarray(r_ref.n_iter))
    assert res.converged.all() and np.asarray(r_ref.converged).all()
    h_ref = np.asarray(h_ref)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(h_ref).max())


@pytest.mark.parametrize("version", [3, 9])
def test_crlb_batched_pallas_matches_reference(tmp_path, version):
    pk, _ = load_priors(BENCH_PK_CSV, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    fids, t, _ = bench_phantom(n_voxels=4, n_t=512)
    re, im = np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag)
    rng = np.random.default_rng(5)
    x = np.clip(pk.init_free[None] * rng.uniform(0.95, 1.05, (4, pk.n_free)),
                pk.lower, pk.upper).astype(np.float32)
    want = jlm.crlb_batched_pallas(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(t), jnp.asarray(x), ps,
        MHZ, v_tile=2, interpret=True, kernel_version=version)
    got = tlm.crlb_batched_pallas(_t(re), _t(im), _t(t), _t(x), ps, MHZ,
                                  kernel_version=version)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-3)


# ---------------------------------------------------------------------------
# The kernel_version contract
# ---------------------------------------------------------------------------


# kernel_version -> the normal-equations counter it takes on a Lorentzian
# prior with n_t % 128 == 0 (the reference's _select_pallas_kernel).
_VERSION_KERNEL = {1: "eq6_normal_eq_v1", 2: "eq6_normal_eq_v2",
                   3: "eq6_normal_eq_v3", 5: "eq6_normal_eq_v5",
                   6: "eq6_normal_eq_v6", 7: "eq6_normal_eq_v7",
                   8: "eq6_normal_eq_v8", 9: "eq6_normal_eq_v9"}


def test_kernel_version_contract(tmp_path):
    """Every version the reference accepts runs: 1-3 and 5-9 through the LM
    driver, ``crlb_batched_pallas`` and ``seeded_fit_grid_raw``, each on
    its own normal-equations kernel; 0 and 4 raise the reference's
    ValueError; 11 is the whole-loop kernel, as the reference resolves
    every version >= 10; ``gate_rejects`` runs; a free-g prior runs with
    the VARPRO override at 6, 8 (K11, the v8 fallback) and 10 (the v9
    loop: K2, never K8)."""
    pk, args, ps = _driver_inputs(tmp_path, n_voxels=2, n_points=128)
    targs = tuple(_t(a) for a in args)
    amp_slots, ls_plan = jam.seed_plan(pk)
    seed_args = (targs[0], targs[1], targs[2],
                 _t(pk.init_free.astype(np.float32)),
                 _t(pk.lower.astype(np.float32)),
                 _t(pk.upper.astype(np.float32)), targs[6])
    seed_kw = dict(pmap_static=ps, mhz=MHZ, amp_slots=amp_slots,
                   ls_plan=ls_plan)
    for v, kernel in _VERSION_KERNEL.items():
        K.reset_counters()
        res = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=v)
        sds, _ = tlm.crlb_batched_pallas(targs[0], targs[1], targs[2],
                                         res.x_free, ps, MHZ, kernel_version=v)
        x, _, conv, _ = tam.seeded_fit_grid_raw(*seed_args, **seed_kw,
                                                kernel_version=v)
        plain = K.counters()["plain_calls"]
        assert [n for n in _VERSION_KERNEL.values() if plain[n]] == [kernel]
        assert res.converged.all() and conv.all()
        assert torch.isfinite(sds).all() and torch.isfinite(x).all()
    for v in (0, 4):
        with pytest.raises(ValueError) as ref_err:
            jlm._select_pallas_kernel(v, ps, 128)
        with pytest.raises(ValueError) as port_err:
            tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=v)
        assert str(port_err.value) == str(ref_err.value)
    jlm._select_pallas_kernel(11, ps, 128)  # the reference accepts it
    r10 = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=10)
    r11 = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=11)
    for a, b in zip(r10, r11):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="slab"):
        tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=3,
                                  return_hessian="slab")
    with pytest.raises(ValueError, match="per-iteration v9"):
        tlm.lm_fit_batched_pallas(*targs, ps, MHZ, kernel_version=10,
                                  return_hessian="slab")
    K.reset_counters()
    gated = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, gate_rejects=True)
    assert K.counters()["plain_calls"]["eq6_normal_eq_v9"] > 0
    assert gated.converged.all()
    free_g, args_g, ps_g = _driver_inputs(tmp_path, csv=FREE_G_CSV, n_voxels=2,
                                          n_points=128)
    for v, kernel in ((6, "eq6_normal_eq_v6"), (8, "eq6_normal_eq_v6"),
                      (10, "eq6_normal_eq_v9")):
        K.reset_counters()
        res = tlm.lm_fit_batched_pallas(*(_t(a) for a in args_g), ps_g, MHZ,
                                        kernel_version=v)
        plain = K.counters()["plain_calls"]
        assert [n for n in _VERSION_KERNEL.values() if plain[n]] == [kernel]
        assert plain["lm_loop_v10"] == 0
        assert torch.isfinite(res.cost).all()


def test_return_hessian_forms(tmp_path):
    """The reference's three return forms on the slab path: the result
    alone, the dense external Hessian, and its (F*F, B) slab."""
    _, args, ps = _driver_inputs(tmp_path, n_voxels=2, n_points=128)
    targs = tuple(_t(a) for a in args)
    res = tlm.lm_fit_batched_pallas(*targs, ps, MHZ)
    assert isinstance(res, tlm.LMResult)
    res_d, h = tlm.lm_fit_batched_pallas(*targs, ps, MHZ, return_hessian=True)
    res_s, h_slab = tlm.lm_fit_batched_pallas(*targs, ps, MHZ,
                                              return_hessian="slab")
    for a, b, c in zip(res, res_d, res_s):
        assert torch.equal(a, b) and torch.equal(a, c)
    f = res.x_free.shape[-1]
    assert h_slab.shape == (f * f, 2)
    assert torch.equal(tlm.slab_to_bff(h_slab, f), h)
