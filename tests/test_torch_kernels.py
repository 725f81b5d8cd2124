"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, as its own tests do.  Tolerances are
those of the reference's tests for the same kernels:

* K1 spectrum: 1e-6 * max|S| (``test_dft_pallas.py:283``), argmax identical;
* K2 v9 normal equations: cost rtol 1e-5, g/H rtol 1e-4 with atol
  1e-3 * max (``test_lm_pallas.py:599-606``);
* K3 damped solve rtol 2e-6 / atol 1e-7, K4 inverse diagonal rtol 2e-4
  (``test_spd.py:72,110``), NaN rows on non-SPD input.

``test_torch_cuda.py`` holds the same comparisons between each CUDA
kernel and its plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.fitting import lm as jlm
from xmris_tpu.ops.kernels.dft_pallas import spectrum_pallas
from xmris_tpu.ops.kernels.lm_pallas import eq6_normal_equations_pallas_v9
from xmris_tpu.ops.kernels.spd import (
    spd_inverse_diag_pallas_slab,
    spd_solve_damped_pallas_slab,
)

from xmris_tpu_torch.fitting.lm import normal_eq_plan
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import dft_cuda, lm_cuda, spd

from _torch_parity import (
    BENCH_PK_CSV,
    MHZ,
    TEST_PK_CSV,
    bench_phantom,
    load_priors,
)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def _spectrum_inputs(b=24, n_in=256, seed=0):
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=(b, n_in)).astype(np.float32)
    xi = rng.normal(size=(b, n_in)).astype(np.float32)
    w = np.exp(-np.arange(n_in) / 80.0).astype(np.float32)
    return xr, xi, w


@pytest.mark.parametrize("stacked", [True, False])
def test_spectrum_matches_pallas(stacked):
    xr, xi, w = _spectrum_inputs()
    n_out = 2 * xr.shape[1]
    ref = spectrum_pallas(
        jnp.asarray(xr), jnp.asarray(xi), n_out, window=jnp.asarray(w),
        interpret=True, with_maxmag=True, stacked_out=stacked, v_tile=8,
    )
    got = dft_cuda.spectrum(_t(xr), _t(xi), n_out, window=_t(w),
                            with_maxmag=True, stacked_out=stacked)
    assert got[0].shape == tuple(ref[0].shape)
    for a, b in zip(got[:2], ref[:2]):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=0, atol=1e-6 * float(np.abs(b).max())
        )
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].dtype == torch.int32


def test_spectrum_plain_equals_unshifted_fft():
    """The plain version is fftshift(fft(pad(x*w), ortho)) and the stacked
    layout is the flat spectrum in memory."""
    xr, xi, w = _spectrum_inputs(b=3, n_in=64)
    flat = dft_cuda.spectrum_plain(_t(xr), _t(xi), 128, window=_t(w))
    stk = dft_cuda.spectrum_plain(_t(xr), _t(xi), 128, window=_t(w),
                                  stacked_out=True)
    x = (xr + 1j * xi) * w
    want = np.fft.fftshift(np.fft.fft(x, n=128, norm="ortho"), axes=-1)
    np.testing.assert_allclose(flat[0].numpy(), want.real, atol=1e-5)
    np.testing.assert_allclose(flat[1].numpy(), want.imag, atol=1e-5)
    assert stk[0].shape == (3,) + dft_cuda.stacked_spec_shape(64, 128)
    np.testing.assert_array_equal(stk[0].reshape(3, 128).numpy(),
                                  flat[0].numpy())


def test_spectrum_rejects_bad_inputs():
    xr, xi, w = _spectrum_inputs(b=2, n_in=64)
    with pytest.raises(ValueError, match="Cooley-Tukey"):
        dft_cuda.spectrum(_t(xr), _t(xi), 32)
    with pytest.raises(TypeError):
        dft_cuda.spectrum(_t(xr).double(), _t(xi).double(), 128)
    with pytest.raises(ValueError, match="window"):
        dft_cuda.spectrum(_t(xr), _t(xi), 128, window=_t(w[:10]))
    with pytest.raises(ValueError, match="unsupported device"):
        dft_cuda.spectrum(_t(xr).to("meta"), _t(xi).to("meta"), 128)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _normal_eq_case(csv_text, tmp_path, factored, b=12, n_t=256, seed=3):
    pk, _ = load_priors(csv_text, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    nf = pk.n_free
    rng = np.random.default_rng(seed)
    fids, t, _ = bench_phantom(n_voxels=b, n_t=n_t, seed=seed)
    x = pk.init_free[None, :] * rng.uniform(0.8, 1.2, (b, nf))
    x = np.clip(x, pk.lower, pk.upper).astype(np.float32)
    grids = np.asarray(
        jlm._expand_params_batched(jnp.asarray(x), ps, jnp.float32)
    )
    dxdu = rng.uniform(0.5, 1.5, (b, nf)).astype(np.float32)
    yre = np.ascontiguousarray(fids.real)
    yim = np.ascontiguousarray(fids.imag)
    active = jlm.active_param_rows(ps)
    cost, g, h = eq6_normal_equations_pallas_v9(
        jnp.asarray(grids), jnp.asarray(yre), jnp.asarray(yim),
        jnp.asarray(t), n_peaks=ps[3], mhz=MHZ, active=active,
        g_zero=jlm.lorentzian_env_flags(ps), v_tile=8, interpret=True,
        factored_t=factored,
        fold_slots=tuple(int(ps[0][j]) for j in active),
        fold_scales=tuple(float(ps[1][j]) for j in active),
        n_free=nf, dxdu=jnp.asarray(dxdu),
    )
    plan = normal_eq_plan(ps, nf, MHZ, factored)
    got = lm_cuda.eq6_normal_equations(
        _t(grids), _t(yre), _t(yim), _t(t), _t(dxdu), plan
    )
    return (np.asarray(cost), np.asarray(g), np.asarray(h)), got, nf, b, plan


# The direct (non-factored) basis runs on the small prior only: the
# reference kernel's interpret-mode compile of the 20-parameter prior takes
# ~20 s per variant.
@pytest.mark.parametrize(
    "prior,factored",
    [("bench", True), ("test_free_g", True), ("test_free_g", False),
     ("tied", True)],
)
def test_normal_equations_match_v9(tmp_path, prior, factored):
    csv_text = {
        "bench": BENCH_PK_CSV, "test_free_g": TEST_PK_CSV,
        # ATP's amplitude tied to PCr's: two rows fold into one free slot.
        "tied": TEST_PK_CSV.replace("amplitude,10.0,5.0",
                                    "amplitude,10.0,0.5*PCr"),
    }[prior]
    (c, g, h), (c2, g2, h2), nf, b, plan = _normal_eq_case(
        csv_text, tmp_path, factored
    )
    # The test prior fits g: Voigt rows need the t^2 coefficient terms.
    assert plan.q_n == (1 if prior == "bench" else 2)
    h2_bff = h2.view(nf, nf, b).permute(2, 0, 1).numpy()
    np.testing.assert_allclose(c2.numpy(), c, rtol=1e-5)
    np.testing.assert_allclose(
        g2.numpy(), g, rtol=1e-4, atol=1e-3 * np.abs(g).max()
    )
    np.testing.assert_allclose(
        h2_bff, h, rtol=1e-4, atol=1e-3 * np.abs(h).max()
    )
    np.testing.assert_array_equal(h2_bff, h2_bff.transpose(0, 2, 1))


def test_normal_equations_plan_table(tmp_path):
    """The kernel's structure table: rows, slots, CSR by slot, g flags."""
    pk, _ = load_priors(BENCH_PK_CSV, tmp_path)
    ps = jlm.hashable_pmap(pk.pmap)
    plan = normal_eq_plan(ps, pk.n_free, MHZ, True)
    a, f, k = len(plan.active), plan.n_free, plan.n_peaks
    table = plan.int_table()
    assert table.shape == (4 * a + f + 1 + k,)
    ptr = table[3 * a: 3 * a + f + 1]
    np.testing.assert_array_equal(ptr, np.arange(f + 1))  # no ties
    assert all(plan.g_zero) and plan.q_n == 1


def test_normal_equations_reject_large_prior(tmp_path):
    pk, _ = load_priors(BENCH_PK_CSV, tmp_path)
    plan = normal_eq_plan(jlm.hashable_pmap(pk.pmap), pk.n_free, MHZ, True)
    z = torch.zeros
    with pytest.raises(ValueError, match="params"):
        lm_cuda.eq6_normal_equations(
            z(2, 3), z(2, 256), z(2, 256), z(256), z(2, pk.n_free), plan
        )


# ---------------------------------------------------------------------------
# K3 / K4
# ---------------------------------------------------------------------------


def _spd_case(b=13, f=20, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, f, f))
    h = (a @ a.transpose(0, 2, 1) + f * np.eye(f)).astype(np.float32)
    h[3] = np.diag(np.r_[[-1.0], np.ones(f - 1)]).astype(np.float32)
    g = rng.normal(size=(b, f)).astype(np.float32)
    lam = rng.uniform(1e-5, 1e-2, b).astype(np.float32)
    # Reference slab: (n_tiles, f_pad^2, v_tile) with f_pad = 24, v_tile = 8
    f_pad, v_tile = 24, 8
    n_tiles = -(-b // v_tile)
    hp = np.zeros((n_tiles * v_tile, f_pad, f_pad), np.float32)
    hp[:b, :f, :f] = h
    ref_slab = hp.reshape(n_tiles, v_tile, f_pad * f_pad).transpose(0, 2, 1)
    port_slab = np.ascontiguousarray(h.transpose(1, 2, 0).reshape(f * f, b))
    return h, g, lam, ref_slab, port_slab, f, f_pad


def test_spd_solve_matches_slab_kernel():
    h, g, lam, ref_slab, port_slab, f, f_pad = _spd_case()
    ref = np.asarray(spd_solve_damped_pallas_slab(
        jnp.asarray(ref_slab), jnp.asarray(g), jnp.asarray(lam), f=f,
        f_pad=f_pad, interpret=True,
    ))
    got = spd.spd_solve_damped(_t(port_slab), _t(g), _t(lam)).numpy()
    bad = np.zeros(len(g), bool)
    bad[3] = True
    assert np.isnan(ref[3]).all() and np.isnan(got[3]).all()
    assert np.isfinite(got[~bad]).all()
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=2e-6, atol=1e-7)


def test_spd_inverse_diag_matches_slab_kernel():
    h, _, _, ref_slab, port_slab, f, f_pad = _spd_case(seed=7)
    ref = np.asarray(spd_inverse_diag_pallas_slab(
        jnp.asarray(ref_slab), f=f, f_pad=f_pad, tikhonov=1e-12,
        interpret=True,
    ))[: h.shape[0]]
    got = spd.spd_inverse_diag(_t(port_slab), 1e-12).numpy()
    assert np.isnan(got[3]).all() and np.isnan(ref[3]).all()
    ok = np.arange(h.shape[0]) != 3
    np.testing.assert_allclose(got[ok], ref[ok], rtol=2e-4)
    exact = np.stack([np.diagonal(np.linalg.inv(h[i].astype(np.float64)))
                      for i in np.nonzero(ok)[0]])
    np.testing.assert_allclose(got[ok], exact, rtol=2e-4)


def test_spd_rejects_bad_slab():
    with pytest.raises(ValueError, match="square"):
        spd.spd_inverse_diag(torch.zeros(5, 3))
    with pytest.raises(ValueError, match="voxels"):
        spd.spd_solve_damped(torch.zeros(4, 3), torch.zeros(2, 2),
                             torch.zeros(2))


def test_counters_count_plain_calls_only_on_cpu():
    K.reset_counters()
    xr, xi, w = _spectrum_inputs(b=2, n_in=64)
    dft_cuda.spectrum(_t(xr), _t(xi), 128)
    snap = K.counters()
    assert snap["plain_calls"]["spectrum"] == 1
    assert snap["launches"]["spectrum"] == 0
    K.reset_counters()
    assert K.counters()["plain_calls"]["spectrum"] == 0
