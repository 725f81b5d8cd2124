"""Free-g priors in the port against the JAX package: the g-scan seed, the
VARPRO override, the LM driver, the grid fit and ``fit_amares``, the staged
planes, the stage timers and the complex-input wrappers.

Both packages get the same seeded numpy inputs; the reference runs its
Pallas kernels in interpret mode, the port its plain kernel versions on the
CPU.  Tolerances: the g scan picks the reference's candidate per voxel
except where two candidates' costs differ by < 1e-6 relative, amplitudes
and phases to rtol 1e-4 (atol 1e-4 max amp, 1e-3 deg); the override's
``ok`` mask exactly and its u to rtol 1e-4 / atol 1e-5; fits reach a cost
per voxel <= 1.005 x the reference's and in total <= 1.002 x
(``tests/test_lm_pallas.py::TestVarpro``), with parameters and CRLB % to
the fixed-g ``fit_amares`` tests' 2e-3 / 2e-2.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xmris_tpu as xmt
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.runtime import profiling

from _torch_parity import TEST_PK_CSV, load_priors
import test_process
from test_fitting import make_phantom
from test_process import PK_CSV_FREE_G

MHZ = 120.0
G_SCAN = (0.0, 0.25, 0.5, 0.75)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _voigt(**kw):
    return test_process.TestGScanSeed()._voigt_phantom(**kw)


@pytest.fixture(scope="module")
def free_g(tmp_path_factory):
    """The free-g two-peak prior (g initial 0.1) of ``test_process.py``."""
    return load_priors(PK_CSV_FREE_G, tmp_path_factory.mktemp("pk"))


def _g_only_csv():
    return (PK_CSV_FREE_G
            .replace('amplitude,"(0, ","(0, "', "amplitude,fixed,fixed")
            .replace('phase,"(-180, 180)","(-180, 180)"', "phase,fixed,fixed"))


# ---------------------------------------------------------------------------
# The g-scan seed
# ---------------------------------------------------------------------------


def _ref_scan(fids, t, pk, g_values):
    out = jam._linear_seed_scan_g(
        jnp.asarray(fids.real.copy()), jnp.asarray(fids.imag.copy()),
        jnp.asarray(pk.init_free, jnp.float32), jnp.asarray(t),
        jlm.hashable_pmap(pk.pmap), MHZ, g_values)
    return [np.asarray(v) for v in out]


def _port_scan(fids, t, pk, g_values):
    out = tam._linear_seed_scan_g(
        _t(fids.real), _t(fids.imag),
        torch.as_tensor(pk.init_free, dtype=torch.float32), _t(t),
        tlm.hashable_pmap(pk.pmap), MHZ, g_values)
    return [v.numpy() for v in out]


def _all_costs(fids, t, pk, g_values):
    """(C, B) LS costs of every candidate (the port's, float64 for ties)."""
    return np.stack([_port_scan(fids.astype(np.complex128), t.astype(np.float64),
                                pk, (g,))[3] for g in g_values])


@pytest.mark.parametrize("g_values", [G_SCAN, (0.0, 0.2, 0.4, 0.6, 0.8)])
def test_scan_g_matches_reference(free_g, g_values):
    pk, tpk = free_g
    fids, t = _voigt()
    amp_r, ph_r, g_r, c_r = _ref_scan(fids, t, pk, g_values)
    amp, ph, g, c = _port_scan(fids, t, tpk, g_values)
    costs = np.sort(_all_costs(fids, t, tpk, g_values), axis=0)
    near_tie = (costs[1] - costs[0]) < 1e-6 * np.abs(costs[0])
    same = g == g_r
    assert np.all(same | near_tie)
    assert same.mean() >= 0.75
    np.testing.assert_allclose(amp[same], amp_r[same], rtol=1e-4,
                               atol=1e-4 * np.abs(amp_r).max())
    np.testing.assert_allclose(ph[same], ph_r[same], rtol=1e-4, atol=1e-3)
    # The cost is ||y||^2 - Re(N^H a) in float32: held at its cancellation
    # scale, 1e-5 ||y||^2.
    yy = (np.abs(fids.astype(np.complex128)) ** 2).sum(1)
    assert np.all(np.abs(c - c_r)[same] <= 1e-5 * yy[same])


def test_scan_g_ties_go_to_the_first_candidate(free_g):
    """A candidate repeated gives equal costs: the first one wins, as
    ``jnp.argmin`` picks it."""
    pk, tpk = free_g
    fids, t = _voigt(n_voxels=4)
    g_values = (0.5, 0.5, 0.0)
    amp, ph, g, _ = _port_scan(fids, t, tpk, g_values)
    amp_r, ph_r, g_r, _ = _ref_scan(fids, t, pk, g_values)
    np.testing.assert_array_equal(g, g_r)
    np.testing.assert_allclose(amp, amp_r, rtol=1e-4, atol=1e-4 * amp_r.max())


def test_template_seeded_x0_with_g_scan_matches_reference(free_g):
    pk, tpk = free_g
    fids, t = _voigt()
    want = jam.template_seeded_x0(fids, pk, jnp.asarray(t), MHZ,
                                  fit_template=False, g_scan=G_SCAN)
    got = tam.template_seeded_x0(fids, tpk, _t(t), MHZ, fit_template=False,
                                 g_scan=G_SCAN)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    for slot, _, _, _ in tam.g_seed_plan(tpk):
        np.testing.assert_allclose(got[:, slot], 0.5, atol=0.26)
    with pytest.raises(TypeError, match="g_scan"):
        tam.template_seeded_x0(fids, tpk, _t(t), MHZ, fit_template=False,
                               g_scan="auto")
    # No scan: the plain LS seed at the template's g, as the reference.
    want0 = jam.template_seeded_x0(fids, pk, jnp.asarray(t), MHZ,
                                   fit_template=False, g_scan=None)
    got0 = tam.template_seeded_x0(fids, tpk, _t(t), MHZ, fit_template=False,
                                  g_scan=None)
    np.testing.assert_allclose(got0, want0, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# The VARPRO override
# ---------------------------------------------------------------------------


def _mis_seeded_state(tpk, b=4, n_t=512):
    """``TestVarpro.test_override_reaches_linear_optimum``'s state: the
    init values with amplitudes scaled by U(0.5, 2) and phases moved by
    U(-60, 60) deg; g and H of the internal-space normal equations at it
    (float64 products, then float32)."""
    plan = tlm.varpro_plan(tlm.hashable_pmap(tpk.pmap))
    da = make_phantom(n_voxels=b, n_points=n_t)
    data = np.asarray(da.transpose("voxel", "time").values)
    yre = data.real.astype(np.float32)
    yim = data.imag.astype(np.float32)
    t = (np.arange(n_t) / 10000.0).astype(np.float32)
    rng = np.random.default_rng(0)
    x0 = np.tile(tpk.init_free, (b, 1)).astype(np.float64)
    x0[:, plan["sa"]] *= rng.uniform(0.5, 2.0, size=(b, 2))
    x0[:, plan["sp"]] += rng.uniform(-60, 60, size=(b, 2))
    u = tlm.external_to_internal(x0, tpk.lower, tpk.upper, tpk.kind).astype(
        np.float32)
    lo = tpk.lower.astype(np.float32)
    hi = tpk.upper.astype(np.float32)
    ps = tlm.hashable_pmap(tpk.pmap)
    x, dxdu = tlm.internal_to_external_torch(_t(u).double(), _t(lo).double(),
                                             _t(hi).double(), _t(tpk.kind))
    smat = torch.as_tensor(tlm._scatter_matrix(ps, tpk.n_free))
    grid = tlm.expand_params(x, ps)
    td = _t(t).double()
    m_re, m_im, b_re, b_im = tlm.eq6_basis_planar(td, grid, MHZ)
    jre_p, jim_p = tlm.eq6_jacobian_planar(td, grid, b_re, b_im, MHZ)
    jre = (jre_p.flatten(-2) @ smat) * dxdu[:, None, :]
    jim = (jim_p.flatten(-2) @ smat) * dxdu[:, None, :]
    rre, rim = _t(yre).double() - m_re, _t(yim).double() - m_im
    g = (jre.transpose(1, 2) @ rre[..., None]
         + jim.transpose(1, 2) @ rim[..., None])[..., 0]
    h = jre.transpose(1, 2) @ jre + jim.transpose(1, 2) @ jim
    cost = (rre ** 2 + rim ** 2).sum(-1)
    return dict(u=u, g=g.float().numpy(), h=h.float().numpy(), lo=lo, hi=hi,
                t=t, yre=yre, yim=yim, plan=plan, cost=cost.numpy())


@pytest.mark.parametrize("layout", ["dense", "slab"])
def test_varpro_override_matches_reference(free_g, layout):
    """Same ``ok`` mask and u on the same (u, g, h, lam); one voxel's lam
    above 10 lam0 keeps the plain trial on both sides."""
    pk, tpk = free_g
    st = _mis_seeded_state(tpk)
    b, f = st["u"].shape
    lam = np.asarray([1e-3, 2e-3, 0.5, 1e-3], np.float32)
    plan = st["plan"]
    want = np.asarray(jlm._varpro_override(
        jnp.asarray(st["u"]), jnp.asarray(st["u"]), jnp.asarray(st["g"]),
        jnp.asarray(st["h"]), jnp.asarray(lam), jnp.asarray(st["lo"]),
        jnp.asarray(st["hi"]), jnp.asarray(pk.kind), plan, 1e-3))
    h = _t(st["h"])
    if layout == "slab":  # (F*F, B), entry (i, j) of voxel v at [i*F + j, v]
        h = h.reshape(b, f * f).t().contiguous()
    got = tlm._varpro_override(
        _t(st["u"]), _t(st["u"]), _t(st["g"]), h, _t(lam), _t(st["lo"]),
        _t(st["hi"]), _t(tpk.kind), plan, 1e-3,
        slab_f=f if layout == "slab" else None).numpy()
    ok_want = (want != st["u"]).any(1)
    ok_got = (got != st["u"]).any(1)
    np.testing.assert_array_equal(ok_got, ok_want)
    assert ok_want.tolist() == [True, True, False, True]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    lin = list(plan["sa"]) + list(plan["sp"])
    nl = [s for s in range(f) if s not in lin]
    np.testing.assert_array_equal(got[:, nl], st["u"][:, nl])


def test_override_reaches_linear_optimum(free_g):
    """Port-only mirror of ``TestVarpro.test_override_reaches_linear_optimum``:
    from the mis-seeded state the override lands the amplitude/phase
    families on the exact complex-LS optimum at the current shifts,
    linewidths and g, recovered from the carried normal equations."""
    _, tpk = free_g
    st = _mis_seeded_state(tpk)
    ps = tlm.hashable_pmap(tpk.pmap)
    lo, hi, kind = _t(st["lo"]), _t(st["hi"]), _t(tpk.kind)
    u = _t(st["u"])
    u_t = tlm._varpro_override(u, u, _t(st["g"]), _t(st["h"]),
                               torch.full((u.shape[0],), 1e-3), lo, hi, kind,
                               st["plan"], 1e-3)
    x = tlm.internal_to_external_torch(u, lo, hi, kind)[0]
    x_new = tlm.internal_to_external_torch(u_t, lo, hi, kind)[0]
    lin = set(st["plan"]["sa"]) | set(st["plan"]["sp"])
    nl = [s for s in range(tpk.n_free) if s not in lin]
    np.testing.assert_allclose(x_new[:, nl].numpy(), x[:, nl].numpy(), rtol=1e-6)
    t = _t(st["t"]).double()
    for i in range(u.shape[0]):
        grid = tlm.expand_params(x_new[i].double(), ps)
        m_re, m_im, _, _ = tlm.eq6_basis_planar(t, grid, MHZ)
        y = st["yre"][i].astype(np.float64) + 1j * st["yim"][i]
        cost_new = float(np.sum(np.abs(y - (m_re.numpy() + 1j * m_im.numpy())) ** 2))
        grid0 = tlm.expand_params(x[i].double(), ps).clone()
        grid0[:, 0] = 1.0
        grid0[:, 3] = 0.0
        _, _, b_re, b_im = tlm.eq6_basis_planar(t, grid0, MHZ)
        bc = b_re.numpy() + 1j * b_im.numpy()
        c = np.linalg.lstsq(bc, y, rcond=None)[0]
        cost_ls = float(np.sum(np.abs(y - bc @ c) ** 2))
        assert cost_new <= st["cost"][i] * (1 + 1e-4)
        assert cost_new == pytest.approx(cost_ls, rel=1e-3)


# ---------------------------------------------------------------------------
# The LM driver with a free g
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def driver_inputs(tmp_path_factory):
    """``TestVarpro.test_driver_free_g_matches_novarpro_optimum``'s fit: its
    prior (g free in (0, 1) from 0), 6 voxels of 512 points from the init
    values, 120 iterations."""
    pk, tpk = load_priors(TEST_PK_CSV, tmp_path_factory.mktemp("pk"))
    b, n_t = 6, 512
    da = make_phantom(n_voxels=b, n_points=n_t)
    fids = np.asarray(da.transpose("voxel", "time").values)
    t = (np.arange(n_t) / 10000.0).astype(np.float32)
    u0 = tlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    re = fids.real.astype(np.float32)
    im = fids.imag.astype(np.float32)
    ref = jlm.lm_fit_batched_pallas(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(t), jnp.asarray(u0),
        jnp.asarray(pk.lower), jnp.asarray(pk.upper), jnp.asarray(pk.kind),
        jlm.hashable_pmap(pk.pmap), MHZ, max_iter=120, v_tile=2,
        interpret=True, return_hessian=True)
    port_args = (_t(re), _t(im), _t(t), _t(u0), _t(tpk.lower), _t(tpk.upper),
                 _t(tpk.kind), tlm.hashable_pmap(tpk.pmap), MHZ)
    return ref, port_args


def _costs_hold(cost, cost_ref):
    cost, cost_ref = np.asarray(cost), np.asarray(cost_ref)
    assert (cost <= cost_ref * 1.005).all()
    assert cost.sum() <= cost_ref.sum() * 1.002


@pytest.mark.parametrize("kernel_version", [9, 10])
def test_driver_free_g_matches_reference(driver_inputs, kernel_version):
    """The free-g prior turns the override on; at 10 the driver runs the v9
    loop (K2 + K3 counted on their plain versions here, K8 never)."""
    (ref, h_ref), args = driver_inputs
    assert tlm.auto_varpro(args[7])
    K.reset_counters()
    res, h = tlm.lm_fit_batched_pallas(*args, max_iter=120,
                                       kernel_version=kernel_version,
                                       return_hessian=True)
    calls = K.counters()["plain_calls"]
    assert calls["lm_loop_v10"] == 0
    assert calls["eq6_normal_eq_v9"] > 0 and calls["spd_solve_damped"] > 0
    assert res.converged.all() and res.done.all()
    _costs_hold(res.cost.numpy(), ref.cost)
    # The noisy phantom's g valley is flat (0.5 noise): float32 trajectories
    # stop apart along it, so the parameters are held to 0.1 CRLB, and the
    # CRLBs from the port's carried Hessian to the reference's Jacobian
    # CRLBs at the port's own solution.
    sds_ref, _ = jlm.crlb_from_hessian(h_ref, ref.cost, args[0].shape[-1])
    dx = np.abs(res.x_free.numpy() - np.asarray(ref.x_free))
    assert np.all(dx <= 2e-3 + 0.1 * np.asarray(sds_ref))
    sds, _ = tlm.crlb_from_hessian(h, res.cost, args[0].shape[-1])
    sds_at, _ = jlm.crlb_batched_planar(
        *(jnp.asarray(a.numpy()) for a in (args[0], args[1], args[2],
                                           res.x_free)), args[7], MHZ)
    np.testing.assert_allclose(sds.numpy(), np.asarray(sds_at), rtol=2e-2,
                               atol=1e-4)


def test_driver_without_override_keeps_the_whole_loop(driver_inputs):
    """``varpro=False`` at 10 is the whole-loop K8 again (its plain
    version here), and the override on (the default) reaches at least the
    plain LM's optimum, as the reference's own test holds."""
    _, args = driver_inputs
    K.reset_counters()
    off = tlm.lm_fit_batched_pallas(*args, max_iter=120, kernel_version=10,
                                     varpro=False)
    calls = K.counters()["plain_calls"]
    assert calls["lm_loop_v10"] == 1 and calls["eq6_normal_eq_v9"] == 0
    on = tlm.lm_fit_batched_pallas(*args, max_iter=120)
    _costs_hold(on.cost.numpy(), off.cost.numpy())


@pytest.mark.parametrize("kernel_version", [3, 8])
def test_dense_driver_free_g_matches_reference(free_g, kernel_version):
    """The override on the dense per-iteration loop (K7 at 3; at 8 the
    free g falls back to K11, as the reference's selection does)."""
    pk, tpk = free_g
    fids, t = _voigt(n_voxels=4, n_points=256, noise=0.05)
    u0 = tlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    re, im = fids.real.copy(), fids.imag.copy()
    ref = jlm.lm_fit_batched_pallas(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(t), jnp.asarray(u0),
        jnp.asarray(pk.lower), jnp.asarray(pk.upper), jnp.asarray(pk.kind),
        jlm.hashable_pmap(pk.pmap), MHZ, max_iter=60, v_tile=2,
        interpret=True, kernel_version=kernel_version)
    K.reset_counters()
    res = tlm.lm_fit_batched_pallas(
        _t(re), _t(im), _t(t), _t(u0), _t(tpk.lower), _t(tpk.upper),
        _t(tpk.kind), tlm.hashable_pmap(tpk.pmap), MHZ, max_iter=60,
        kernel_version=kernel_version)
    calls = K.counters()["plain_calls"]
    want = "eq6_normal_eq_v3" if kernel_version == 3 else "eq6_normal_eq_v6"
    assert calls[want] > 0 and calls["eq6_normal_eq_v8"] == 0
    assert calls["spd_solve_damped_dense"] > 0
    _costs_hold(res.cost.numpy(), ref.cost)


# ---------------------------------------------------------------------------
# seeded_fit_grid_raw with the g scan
# ---------------------------------------------------------------------------


def _grid_args(fids, t, pk, port):
    if port:
        return (_t(fids.real), _t(fids.imag), _t(t),
                torch.as_tensor(pk.init_free, dtype=torch.float32),
                _t(pk.lower), _t(pk.upper), _t(pk.kind))
    return (jnp.asarray(fids.real.copy()), jnp.asarray(fids.imag.copy()),
            jnp.asarray(t), jnp.asarray(pk.init_free, jnp.float32),
            jnp.asarray(pk.lower), jnp.asarray(pk.upper), jnp.asarray(pk.kind))


def _grid_kw(pk, **kw):
    amp_slots, ls_plan = tam.seed_plan(pk)
    return dict(pmap_static=tlm.hashable_pmap(pk.pmap), mhz=MHZ,
                amp_slots=amp_slots, ls_plan=ls_plan, g_scan=G_SCAN,
                g_plan=tam.g_seed_plan(pk), uniform_t_ok=True, **kw)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_seeded_fit_grid_g_scan_matches_reference(free_g, engine):
    """``TestGScanSeed.test_fused_g_scan_converges``'s grid on both
    engines."""
    pk, tpk = free_g
    fids, t = _voigt(n_voxels=6, n_points=512, noise=0.05)
    extra = {"interpret": True} if engine == "pallas" else {}
    x_r, c_r, conv_r, sds_r = (np.asarray(v) for v in jam.seeded_fit_grid_raw(
        *_grid_args(fids, t, pk, False), **_grid_kw(pk, engine=engine), **extra))
    K.reset_counters()
    x, c, conv, sds = (v.numpy() for v in tam.seeded_fit_grid_raw(
        *_grid_args(fids, t, tpk, True), **_grid_kw(tpk, engine=engine)))
    calls = K.counters()["plain_calls"]
    if engine == "pallas":
        assert all(calls[n] > 0 for n in K.PATHS["seeded_fit"])
    else:
        assert not any(calls.values())
    assert conv.all() and conv_r.all()
    _costs_hold(c, c_r)
    np.testing.assert_allclose(x, x_r, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds, sds_r, rtol=2e-2, atol=1e-4)
    g_slot = int(tpk.pmap.idx[4])
    np.testing.assert_allclose(x[:, g_slot], 0.5, atol=0.15)


def test_seeded_fit_grid_g_only_seed_matches_reference(tmp_path):
    """``TestGOnlySeed``: every amplitude/phase fixed, g free; at
    ``max_iter=0`` x_free is the seed, the scanned g."""
    pk, tpk = load_priors(_g_only_csv(), tmp_path)
    assert tam.seed_plan(tpk)[1] == () and tam.g_seed_plan(tpk)
    fids, t = _voigt(n_voxels=4, n_points=512, noise=0.05)
    x_r = np.asarray(jam.seeded_fit_grid_raw(
        *_grid_args(fids, t, pk, False), **_grid_kw(pk, max_iter=0),
        interpret=True)[0])
    x = tam.seeded_fit_grid_raw(*_grid_args(fids, t, tpk, True),
                                **_grid_kw(tpk, max_iter=0))[0].numpy()
    np.testing.assert_allclose(x, x_r, rtol=1e-5, atol=1e-5)
    for slot, _, _, _ in tam.g_seed_plan(tpk):
        np.testing.assert_allclose(x[:, slot], 0.5, atol=0.26)


# ---------------------------------------------------------------------------
# fit_amares with a free g
# ---------------------------------------------------------------------------


def _arrays(fids, t):
    dims = ("voxel", "time")
    ref = xmt.XmrArray(fids, dims=dims, coords={"time": JCoord("time", t)},
                       attrs={"MHz": MHZ})
    port = XmrArray(fids, dims=dims, coords={"time": Coord("time", t)},
                    attrs={"MHz": MHZ})
    return ref, port


@pytest.fixture(scope="module")
def free_g_fits(tmp_path_factory):
    path = tmp_path_factory.mktemp("pk") / "pk.csv"
    path.write_text(TEST_PK_CSV)  # g bounds (0, 1) on both peaks
    # g is weakly identified against noise: the clean phantom of
    # TestGScanSeed.test_fused_g_scan_converges.
    fids, t = _voigt(n_voxels=6, n_points=512, noise=0.05)
    ref_da, port_da = _arrays(fids.astype(np.complex128), t.astype(np.float64))
    ref = jam.fit_amares(ref_da, path, engine="pallas")
    got = tam.fit_amares(port_da, path, engine="pallas", device="cpu")
    return ref, got, port_da, path


def test_fit_amares_free_g_matches_reference(free_g_fits):
    ref, got, _, _ = free_g_fits
    assert got["fit_converged"].values.all() and ref["fit_converged"].values.all()
    _costs_hold(*((np.abs(ds["residuals"].values) ** 2).sum(1)
                  for ds in (got, ref)))
    for name in ("amplitude", "chem_shift", "linewidth", "phase", "snr"):
        np.testing.assert_allclose(got[name].values, ref[name].values,
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    np.testing.assert_allclose(got["crlb"].values, ref["crlb"].values,
                               rtol=2e-2, atol=1e-4)


def test_fit_amares_staged_planes_equal_unstaged(free_g_fits):
    """``device_fids`` from ``stage_device_fids`` (g_scan="auto") give the
    unstaged fit bit for bit; planes staged along another layout or of
    another shape raise the reference's ``ValueError``."""
    _, got, port_da, path = free_g_fits
    staged = tam.stage_device_fids(port_da, device="cpu")
    assert isinstance(staged, tam.StagedFids) and staged.ready is None
    assert staged.dims == ("voxel", "time") and staged.shape == (6, 512)
    again = tam.fit_amares(port_da, path, engine="pallas", device="cpu",
                           device_fids=staged)
    for name in got.data_vars:
        np.testing.assert_array_equal(again[name].values, got[name].values)
    bad = staged._replace(dims=("time", "voxel"))
    with pytest.raises(ValueError, match="staged for layout"):
        tam.fit_amares(port_da, path, device="cpu", device_fids=bad)
    with pytest.raises(ValueError, match="device_fids planes have shapes"):
        tam.fit_amares(port_da, path, device="cpu",
                       device_fids=(staged.re[:3], staged.im[:3]))


def test_fit_amares_stage_timers_print_the_reference_keys(free_g_fits,
                                                          monkeypatch, capsys):
    """The port's ``fit_amares.*`` spans under ``recording()`` are the
    stages the JAX package prints with ``XMT_FIT_STAGE_TIMERS``, in its
    order; without recording the port prints and records nothing."""
    _, _, port_da, path = free_g_fits
    ref_da = xmt.XmrArray(port_da.values, dims=port_da.dims,
                          coords={"time": JCoord("time", port_da.coords["time"].values)},
                          attrs=dict(port_da.attrs))
    monkeypatch.setenv("XMT_FIT_STAGE_TIMERS", "1")
    capsys.readouterr()
    jam.fit_amares(ref_da, path, engine="xla", return_curves=False)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"fit_amares_stages_s"')]
    assert len(lines) == 1
    want = json.loads(lines[0])["fit_amares_stages_s"]
    monkeypatch.delenv("XMT_FIT_STAGE_TIMERS")

    with profiling.recording() as rec:
        tam.fit_amares(port_da, path, engine="xla", device="cpu",
                       return_curves=False)
    spans = rec.snapshot()["spans"]
    got = [n.split(".", 1)[1] for n in spans if n.startswith("fit_amares.")]
    assert got == list(want)
    assert all(spans[f"fit_amares.{k}"]["host_ms"] >= 0.0 for k in got)
    assert spans["fit_amares"]["calls"] == 1

    before = profiling.snapshot()
    capsys.readouterr()
    tam.fit_amares(port_da, path, engine="xla", device="cpu",
                   return_curves=False)
    assert "fit_amares_stages_s" not in capsys.readouterr().out
    assert profiling.snapshot() == before


def test_fit_amares_g_scan_auto_is_the_ladder(free_g_fits):
    """``g_scan="auto"`` on a free-g prior is the explicit five-candidate
    ladder; on a fixed-g prior it is no scan."""
    _, got, port_da, path = free_g_fits
    ladder = tam.fit_amares(port_da, path, engine="pallas", device="cpu",
                            g_scan=(0.0, 0.2, 0.4, 0.6, 0.8))
    for name in got.data_vars:
        np.testing.assert_array_equal(ladder[name].values, got[name].values)


# ---------------------------------------------------------------------------
# The complex-input wrappers
# ---------------------------------------------------------------------------


def test_complex_wrappers_match_reference(free_g):
    pk, tpk = free_g
    fids, t = _voigt(n_voxels=3, n_points=256)
    fids = fids.astype(np.complex128)
    t64 = t.astype(np.float64)
    u0 = tlm.external_to_internal(pk.init_free, pk.lower, pk.upper, pk.kind)
    ps = tlm.hashable_pmap(tpk.pmap)
    ref = jlm.lm_fit_batched(fids, jnp.asarray(t64), jnp.asarray(u0),
                             jnp.asarray(pk.lower), jnp.asarray(pk.upper),
                             jnp.asarray(pk.kind), jlm.hashable_pmap(pk.pmap),
                             MHZ, max_iter=30)
    for src in (fids, torch.from_numpy(fids)):
        got = tlm.lm_fit_batched(src, _t(t64), _t(u0), _t(tpk.lower),
                                 _t(tpk.upper), _t(tpk.kind), ps, MHZ,
                                 max_iter=30)
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   rtol=1e-4)
        np.testing.assert_allclose(got.x_free.numpy(), np.asarray(ref.x_free),
                                   rtol=2e-3, atol=2e-3)
    x = got.x_free.double()
    sds, s2 = tlm.crlb_batched(fids, _t(t64), x, ps, MHZ)
    sds_r, s2_r = jlm.crlb_batched(fids, jnp.asarray(t64),
                                   jnp.asarray(x.numpy()),
                                   jlm.hashable_pmap(pk.pmap), MHZ)
    np.testing.assert_allclose(sds.numpy(), np.asarray(sds_r), rtol=2e-2,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_r), rtol=1e-4)
    grid = tlm.expand_params(x, ps)[0]  # the reference's takes one (K, 5)
    m, basis = tlm.eq6_model_and_basis(_t(t64), grid, MHZ)
    m_r, b_r = jlm.eq6_model_and_basis(jnp.asarray(t64),
                                       jnp.asarray(grid.numpy()), MHZ)
    assert m.is_complex() and m.shape == (256,) and basis.shape == (256, 2)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(m_r)).max())
    np.testing.assert_allclose(basis.numpy(), np.asarray(b_r), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(b_r)).max())
