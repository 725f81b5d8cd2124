"""The port's prior parsing, LM host half, seeding and grid fit against
the JAX package.

Inputs are made with numpy and handed to both packages.  The grid fit is
held to ``tests/test_process.py:78-84``: cost rtol 1e-4, x rtol/atol 2e-3,
CRLB rtol 2e-2 / atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.fitting import amares as jam
from xmris_tpu.fitting import lm as jlm

from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.fitting.prior import (
    load_prior_knowledge,
    prior_from_csv_text,
    prior_from_numpy,
)
from xmris_tpu_torch.ops import kernels as K

from _torch_parity import (
    BENCH_PK_CSV,
    MHZ,
    TEST_PK_CSV,
    TEST_PK_CSV_FIXED_G,
    bench_phantom,
    load_priors,
)

TIED_PK_CSV = TEST_PK_CSV.replace("amplitude,10.0,5.0", "amplitude,10.0,0.5*PCr")
PRIORS = {
    "bench": BENCH_PK_CSV, "test": TEST_PK_CSV,
    "test_fixed_g": TEST_PK_CSV_FIXED_G, "tied": TIED_PK_CSV,
}


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _assert_prior_equal(a, b):
    assert list(a.metabolites) == list(b.metabolites)
    assert list(a.free_labels) == list(b.free_labels)
    for name in ("init_free", "lower", "upper", "kind"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("idx", "scale", "offset"):
        np.testing.assert_array_equal(getattr(a.pmap, name),
                                      getattr(b.pmap, name))
    assert int(a.pmap.n_peaks) == int(b.pmap.n_peaks)


# ---------------------------------------------------------------------------
# Prior parsing and the static plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_prior_parsing_matches_reference(tmp_path, name):
    pk_ref, pk_from_ref = load_priors(PRIORS[name], tmp_path)
    path = tmp_path / "again.csv"
    path.write_text(PRIORS[name])
    pk_port = load_prior_knowledge(path)
    _assert_prior_equal(pk_port, pk_ref)
    _assert_prior_equal(pk_from_ref, pk_ref)
    _assert_prior_equal(prior_from_csv_text(PRIORS[name]), pk_ref)
    assert pk_port.n_peaks == pk_ref.n_peaks
    assert pk_port.n_free == pk_ref.n_free
    # prior_from_numpy round-trips the port's own prior too.
    _assert_prior_equal(prior_from_numpy(pk_port), pk_port)


def test_prior_parsing_errors(tmp_path):
    with pytest.raises(ValueError, match="empty"):
        prior_from_csv_text("")
    with pytest.raises(ValueError, match="no metabolite"):
        prior_from_csv_text("Index\n")
    with pytest.raises(ValueError, match="Tie target"):
        prior_from_csv_text(TEST_PK_CSV.replace("amplitude,10.0,5.0",
                                                "amplitude,10.0,0.5*Foo"))


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_static_plans_match_reference(tmp_path, name):
    pk, pkt = load_priors(PRIORS[name], tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    assert tlm.hashable_pmap(pkt.pmap) == ps
    np.testing.assert_array_equal(
        tlm._scatter_matrix(ps, pk.n_free), jlm._scatter_matrix(ps, pk.n_free)
    )
    assert tlm.active_param_rows(ps) == jlm.active_param_rows(ps)
    assert tlm.lorentzian_env_flags(ps) == jlm.lorentzian_env_flags(ps)
    assert tlm.auto_varpro(ps) == jlm.auto_varpro(ps)
    vp, vp_ref = tlm.varpro_plan(ps), jlm.varpro_plan(ps)
    assert (vp is None) == (vp_ref is None)
    if vp is not None:
        for key in vp_ref:
            np.testing.assert_array_equal(vp[key], vp_ref[key])
    for spd_pallas in (True, False):
        for kv in (8, 9, 10):
            assert (tlm.uses_slab_hessian(spd_pallas, kv)
                    == jlm.uses_slab_hessian(spd_pallas, kv))
    assert tam.seed_plan(pkt) == jam.seed_plan(pk)


def test_bound_transforms_match_reference(tmp_path):
    pk, _ = load_priors(TEST_PK_CSV, tmp_path)
    lower = np.r_[pk.lower, 0.0, -np.inf, -np.inf]
    upper = np.r_[pk.upper, np.inf, 3.0, np.inf]
    kind = tlm.classify_bounds(lower, upper)
    np.testing.assert_array_equal(kind, jlm.classify_bounds(lower, upper))
    rng = np.random.default_rng(0)
    x = np.clip(rng.normal(size=(7, len(lower))) * 5, lower, upper)
    u = tlm.external_to_internal(x, lower, upper, kind)
    np.testing.assert_array_equal(u, jlm.external_to_internal(x, lower, upper,
                                                              kind))
    args = (_t(lower), _t(upper), _t(kind))
    np.testing.assert_allclose(
        tlm.external_to_internal_torch(_t(x), *args).numpy(), u, rtol=1e-12
    )
    xu, du = tlm.internal_to_external_torch(_t(u), *args)
    xr, dr = jlm.internal_to_external_jax(
        jnp.asarray(u), jnp.asarray(lower), jnp.asarray(upper),
        jnp.asarray(kind),
    )
    np.testing.assert_allclose(xu.numpy(), np.asarray(xr), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(du.numpy(), np.asarray(dr), rtol=1e-12,
                               atol=1e-12)


def test_model_and_jacobian_match_reference(tmp_path):
    pk, _ = load_priors(TEST_PK_CSV, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    t = (np.arange(128) / 5000.0).astype(np.float32)
    x = (pk.init_free * 1.1).astype(np.float32)
    grid_ref = jlm.expand_params(jnp.asarray(x), jlm._pmap_jax(ps, jnp.float32))
    grid = tlm.expand_params(_t(x), ps)
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_ref), rtol=1e-6)
    ref = jlm.eq6_basis_planar(jnp.asarray(t), grid_ref, MHZ)
    got = tlm.eq6_basis_planar(_t(t), grid, MHZ)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    jr = jlm.eq6_jacobian_planar(jnp.asarray(t), grid_ref, ref[2], ref[3], MHZ)
    jt = tlm.eq6_jacobian_planar(_t(t), grid, got[2], got[3], MHZ)
    for a, b in zip(jt, jr):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_seed_helpers_match_reference():
    rng = np.random.default_rng(2)
    vals = rng.uniform(-700, 700, 50)
    for lo, hi in ((-180.0, 180.0), (0.0, 360.0), (0.0, np.inf),
                   (-np.inf, 90.0), (-np.inf, np.inf), (5.0, 30.0)):
        np.testing.assert_allclose(
            tam._wrap_phase_window_torch(_t(vals), lo, hi).numpy(),
            jam._wrap_phase_window(vals, lo, hi), rtol=1e-12, atol=1e-9,
        )
        np.testing.assert_allclose(
            tam._nudge_into_bounds_torch(_t(vals), lo, hi).numpy(),
            jam._nudge_into_bounds(vals, lo, hi), rtol=1e-12,
        )
    fids, _, _ = bench_phantom(n_voxels=9)
    assert (tam.select_template_fid(fids, announce=False)
            == jam.select_template_fid(fids, announce=False))


# ---------------------------------------------------------------------------
# The template fit and the grid fit
# ---------------------------------------------------------------------------


def test_template_optimum_matches_reference(tmp_path):
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path)
    fids, t, _ = bench_phantom()
    ref = jam.template_optimum(fids, pk, jnp.asarray(t), MHZ)
    got = tam.template_optimum(fids, pkt, _t(t), MHZ)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def _fit_inputs(pk, pkt, fids, t):
    re = np.ascontiguousarray(fids.real)
    im = np.ascontiguousarray(fids.imag)
    x_t = pk.init_free.astype(np.float32)
    lo = pk.lower.astype(np.float32)
    hi = pk.upper.astype(np.float32)
    jargs = (jnp.asarray(re), jnp.asarray(im), jnp.asarray(t),
             jnp.asarray(x_t), jnp.asarray(lo), jnp.asarray(hi),
             jnp.asarray(pk.kind))
    targs = (_t(re), _t(im), _t(t), _t(x_t), _t(lo), _t(hi), _t(pkt.kind))
    amp_slots, ls_plan = jam.seed_plan(pk)
    kw = dict(pmap_static=jlm.hashable_pmap(pk.pmap), mhz=MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, uniform_t_ok=True)
    return jargs, targs, kw


@pytest.mark.parametrize("name", ["bench", "test_fixed_g"])
def test_seeded_fit_grid_matches_reference(tmp_path, name):
    pk, pkt = load_priors(PRIORS[name], tmp_path)
    fids, t, amp_true = bench_phantom()
    jargs, targs, kw = _fit_inputs(pk, pkt, fids, t)
    x_ref, cost_ref, conv_ref, sds_ref = (
        np.asarray(a) for a in jam.seeded_fit_grid_raw(
            *jargs, **kw, interpret=True)
    )
    x, cost, conv, sds = tam.seeded_fit_grid_raw(*targs, **kw)
    assert conv.all() and conv_ref.all()
    np.testing.assert_allclose(cost.numpy(), cost_ref, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(sds.numpy(), sds_ref, rtol=2e-2, atol=1e-4)
    if name == "bench":
        slot = int(pk.pmap.idx[0])
        np.testing.assert_allclose(x.numpy()[:, slot], amp_true, rtol=0.05)


def _counting(kernels):
    calls = {"normal_equations": 0}

    def normal_equations(*args, **kwargs):
        calls["normal_equations"] += 1
        return kernels.normal_equations(*args, **kwargs)

    return dataclasses.replace(kernels, normal_equations=normal_equations), calls


def test_lm_trip_count(tmp_path):
    """The loop reads ``done.all()`` on the host once per trip: it runs
    while ``(i < max_iter) & ~all(done)``, the reference's condition, and
    done voxels freeze, so a larger budget changes nothing."""
    pk, pkt = load_priors(BENCH_PK_CSV, tmp_path)
    fids, t, _ = bench_phantom(n_voxels=8)
    _, targs, kw = _fit_inputs(pk, pkt, fids, t)
    re, im, t_, x_t, lo, hi, kind = targs
    ps = kw["pmap_static"]
    u0 = tam.seed_grid(re, im, t_, x_t, lo, hi, kind, pmap_static=ps, mhz=MHZ,
                       amp_slots=kw["amp_slots"], ls_plan=kw["ls_plan"])

    def run(max_iter):
        ks, calls = _counting(K.PLAIN)
        res, h = tlm.lm_fit_batched_slab(
            re, im, t_, u0, lo, hi, kind, ps, MHZ, kernels=ks,
            max_iter=max_iter, uniform_t_ok=True,
        )
        return res, h, calls["normal_equations"] - 1  # minus the initial eval

    res, h, trips = run(24)
    assert res.done.all() and 0 < trips < 24
    res_big, h_big, trips_big = run(200)
    assert trips_big == trips
    for a, b in zip(res, res_big):
        assert torch.equal(a, b)
    assert torch.equal(h, h_big)
    res_short, _, trips_short = run(trips - 1)
    assert trips_short == trips - 1 and not res_short.done.all()
    _, _, trips_two = run(2)
    assert trips_two == min(2, trips)


def test_unported_fit_options_raise(tmp_path):
    pk, pkt = load_priors(TEST_PK_CSV, tmp_path)  # free g -> VARPRO
    fids, t, _ = bench_phantom(n_voxels=2)
    _, targs, kw = _fit_inputs(pk, pkt, fids, t)
    with pytest.raises(NotImplementedError, match="VARPRO"):
        tam.seeded_fit_grid_raw(*targs, **kw)
    with pytest.raises(NotImplementedError, match="kernel_version=9"):
        tam.seeded_fit_grid_raw(*targs, **kw, kernel_version=6)
    with pytest.raises(NotImplementedError, match="kernel_version=9"):
        tam.seeded_fit_grid_raw(*targs, **kw, spd_pallas=False)
