"""The port's planar matmul DFT (``ops/kernels/dft.py``) and the
``PipelineConfig`` fields that select it (``dft_variant``,
``dft_precision``, ``phase_barrier``) against the JAX package.

The same seeded numpy inputs go through both packages.  In float64 every
formulation is held to the reference at atol 1e-9 (``tests/test_planar.py``'s
bar); the reference's ``"pallas"`` variant runs in interpret mode, as
``tests/test_dft_pallas.py`` runs it, against the port's K1 (its plain
version here) in float32 at 1e-6 max|S|.  The precision emulation is held
to numpy's float64 FFT at the bounds of its arithmetic: ``"high"`` keeps 16
significand bits (2^-16 of max|S|), ``"default"`` 8 (1e-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.ops.kernels import dft as jdft
from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.planar_pipeline import (
    spectral_pipeline_planar_raw as ref_spectral,
)

from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import dft
from xmris_tpu_torch.parallel.mesh import make_mesh
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import (
    spectral_pipeline_planar_raw,
    spectral_pipeline_sharded,
)

VARIANTS = ("einsum", "flat", "block", "full")
SIZES = (16, 100, 256, 2048, 13)


def _planar(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _rel_err(got, want):
    """max |got - want| / max |want| of planar (re, im) against complex."""
    z = got[0].double().numpy() + 1j * got[1].double().numpy()
    return float(np.abs(z - want).max() / np.abs(want).max())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dft_planar_matches_reference(variant, n, inverse):
    xr, xi = _planar((3, n), seed=n)
    ref = jdft.dft_planar(jnp.asarray(xr), jnp.asarray(xi), n,
                          inverse=inverse, variant=variant)
    got = dft.dft_planar(_t(xr), _t(xi), n, inverse=inverse, variant=variant)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64 and tuple(a.shape) == (3, n)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)


@pytest.mark.parametrize("variant", VARIANTS)
def test_dft_planar_batch_shape_and_ortho_false(variant):
    xr, xi = _planar((2, 3, 64), seed=1)
    for inverse in (False, True):
        ref = jdft.dft_planar(jnp.asarray(xr), jnp.asarray(xi), 64,
                              inverse=inverse, ortho=False, variant=variant)
        got = dft.dft_planar(_t(xr), _t(xi), 64, inverse=inverse, ortho=False,
                             variant=variant)
        for a, b in zip(got, ref):
            assert tuple(a.shape) == (2, 3, 64)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-9)


@pytest.mark.parametrize("n_in,n_out", [(100, 256), (256, 512), (64, 64)])
def test_rect_shifted_matches_reference_and_numpy(n_in, n_out):
    xr, xi = _planar((4, n_in), seed=n_in + n_out)
    ref = jdft.dft_rect_shifted_planar(jnp.asarray(xr), jnp.asarray(xi), n_out)
    got = dft.dft_rect_shifted_planar(_t(xr), _t(xi), n_out)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    padded = np.pad(xr + 1j * xi, ((0, 0), (0, n_out - n_in)))
    want = np.fft.fftshift(np.fft.fft(padded, axis=-1, norm="ortho"), axes=-1)
    assert _rel_err(got, want) < 1e-12


@pytest.mark.parametrize("variant", VARIANTS)
def test_round_trip_and_wrappers(variant):
    xr, xi = _planar((5, 96), seed=7)
    fr, fi = dft.dft_planar(_t(xr), _t(xi), 96, variant=variant)
    br, bi = dft.dft_planar(fr, fi, 96, inverse=True, variant=variant)
    np.testing.assert_allclose(br.numpy(), xr, atol=1e-12)
    np.testing.assert_allclose(bi.numpy(), xi, atol=1e-12)
    for ours, ref in ((dft.fft_ortho_planar, jdft.fft_ortho_planar),
                      (dft.ifft_ortho_planar, jdft.ifft_ortho_planar)):
        got = ours(_t(xr), _t(xi))
        want = ref(jnp.asarray(xr), jnp.asarray(xi))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)


def test_factorize_and_plan_cache_match_reference():
    for n in list(range(1, 130)) + [1000, 1024, 1536, 2048, 4096, 4099]:
        assert dft._factorize(n) == jdft._factorize(n), n
    for n in (13, 100, 2048):
        plan = dft.plan_dft(n)
        assert dft.plan_dft(n) is plan  # host-cached
        ref = jdft.plan_dft(n)
        assert (plan.n, plan.n1, plan.n2) == (ref.n, ref.n1, ref.n2)
        for name in plan._fields[3:]:
            a = getattr(plan, name)
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, getattr(ref, name))
    for n in (64, 2048):
        for a, b in zip(dft._block_factors(n), jdft._block_factors(n)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dft._full_block_matrix(32),
                                  jdft._full_block_matrix(32))
    np.testing.assert_array_equal(dft._rect_shifted_block_matrix(24, 64),
                                  jdft._rect_shifted_block_matrix(24, 64))


@pytest.mark.parametrize("variant", VARIANTS)
def test_float32_accuracy(variant):
    xr, xi = _planar((2, 2048), seed=11)
    got = dft.dft_planar(_t(xr).float(), _t(xi).float(), 2048,
                         variant=variant)
    assert got[0].dtype == torch.float32
    assert _rel_err(got, np.fft.fft(xr + 1j * xi, norm="ortho")) < 5e-6


@pytest.mark.parametrize("variant", VARIANTS + ("rect",))
def test_precision_emulation_against_numpy(variant):
    """``"high"`` within 2^-16 of max|S|, ``"default"`` within 1e-2 and
    measurably worse than ``"high"``, which is worse than ``"highest"``;
    None is ``"highest"`` bit for bit; the same on float64 operands."""
    xr, xi = _planar((2, 2048), seed=5)
    want = np.fft.fft(xr + 1j * xi, norm="ortho")
    if variant == "rect":
        want = np.fft.fftshift(np.fft.fft(np.pad(xr + 1j * xi, ((0, 0), (0, 2048))),
                                          axis=-1, norm="ortho"), axes=-1)

    def run(precision, dtype=torch.float32):
        a, b = _t(xr).to(dtype), _t(xi).to(dtype)
        if variant == "rect":
            return dft.dft_rect_shifted_planar(a, b, 4096, precision=precision)
        return dft.dft_planar(a, b, 2048, variant=variant, precision=precision)

    errs = {p: _rel_err(run(p), want) for p in ("highest", "high", "default")}
    assert errs["highest"] < 5e-6
    assert errs["high"] <= 2.0**-16
    assert errs["default"] <= 1e-2
    assert errs["default"] > 10 * errs["high"] > 10 * errs["highest"]
    for a, b in zip(run(None), run("highest")):
        assert torch.equal(a, b)
    err64 = {p: _rel_err(run(p, torch.float64), want) for p in ("high", "default")}
    assert err64["high"] <= 2.0**-16 and 1e-4 < err64["default"] <= 1e-2


def test_unknown_variant_and_precision_raise():
    xr, xi = _planar((1, 16))
    with pytest.raises(ValueError, match="Unknown DFT variant"):
        jdft.dft_planar(jnp.asarray(xr), jnp.asarray(xi), 16, variant="fft")
    with pytest.raises(ValueError, match="Unknown DFT variant"):
        dft.dft_planar(_t(xr), _t(xi), 16, variant="fft")
    with pytest.raises(ValueError, match="precision"):
        dft.dft_planar(_t(xr), _t(xi), 16, precision="medium")
    with pytest.raises(ValueError, match="precision"):
        dft.dft_rect_shifted_planar(_t(xr), _t(xi), 32, precision="low")
    with pytest.raises(ValueError, match=r"\(\.\.\., 32\)"):
        dft.dft_planar(_t(xr), _t(xi), 32)


# ---------------------------------------------------------------------------
# The spectral stage at each dft_variant
# ---------------------------------------------------------------------------

N_VOX, N_TIME, ZF, SW = 6, 128, 256, 4000.0


def _stage_inputs(dtype=np.float64):
    """Six decaying lines with noise (``tests/test_planar.py``'s phase
    barrier input at the fused-pipeline test's sizes)."""
    rng = np.random.default_rng(33)
    t = np.arange(N_TIME) / SW
    fids = (rng.uniform(1, 4, (N_VOX, 1))
            * np.exp((1j * 2 * np.pi * rng.uniform(-1e3, 1e3, (N_VOX, 1)) - 30) * t))
    fids = fids + rng.normal(0, 1e-3, fids.shape) + 1j * rng.normal(0, 1e-3, fids.shape)
    weight = np.exp(-np.pi * 5.0 * np.arange(ZF) / SW)
    freqs = np.fft.fftshift(np.fft.fftfreq(ZF, d=1 / SW))
    return tuple(np.ascontiguousarray(a, dtype=dtype)
                 for a in (fids.real, fids.imag, weight, freqs))


@pytest.mark.parametrize("autophase", ["none", "single"])
@pytest.mark.parametrize("variant", ["fused"] + list(VARIANTS))
def test_spectral_stage_variant_matches_reference(variant, autophase):
    arrays = _stage_inputs()
    kw = dict(zero_fill_to=ZF, autophase=autophase, ap_optimizer="grid",
              dft_variant=variant)
    ref = ref_spectral(*(jnp.asarray(a) for a in arrays), RefConfig(**kw))
    K.reset_counters()
    got = spectral_pipeline_planar_raw(*(_t(a) for a in arrays),
                                       PipelineConfig(**kw))
    assert K.counters()["plain_calls"]["spectrum"] == 0  # no K1
    scale = float(np.abs(np.asarray(ref[0])).max())
    atol = 1e-9 if autophase == "none" else 1e-8 * scale
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
    (p0, p1, piv), (q0, q1, qpiv) = got[2], ref[2]
    assert float(piv) == float(qpiv)
    assert abs(float(p0) - float(q0)) <= 1e-6
    assert abs(float(p1) - float(q1)) <= 1e-5


@pytest.mark.parametrize("autophase", ["none", "single"])
@pytest.mark.parametrize("variant", [None, "pallas"])
def test_kernel_variant_matches_reference_pallas(variant, autophase):
    """None and "pallas" run K1 (its plain version here), against the
    reference's Pallas kernel in interpret mode; float32."""
    arrays = _stage_inputs(np.float32)
    kw = dict(zero_fill_to=ZF, autophase=autophase, ap_optimizer="grid")
    ref = ref_spectral(*(jnp.asarray(a) for a in arrays),
                       RefConfig(**kw, dft_variant="pallas"))
    K.reset_counters()
    got = spectral_pipeline_planar_raw(*(_t(a) for a in arrays),
                                       PipelineConfig(**kw, dft_variant=variant))
    assert K.counters()["plain_calls"]["spectrum"] == 1
    scale = float(np.abs(np.asarray(ref[0])).max())
    (p0, p1, piv), (q0, q1, qpiv) = got[2], ref[2]
    assert float(piv) == float(qpiv) and abs(float(p0) - float(q0)) <= 0.5
    x_range = float(arrays[3][-1] - arrays[3][0])

    def phi(a0, a1):
        return (np.deg2rad(float(a0)) + np.deg2rad(float(a1))
                * ((arrays[3].astype(np.float64) - float(piv)) / x_range))

    d = phi(p0, p1) - phi(q0, q1)
    sr, si = np.asarray(ref[0]), np.asarray(ref[1])
    rot = (sr * np.cos(d) - si * np.sin(d), sr * np.sin(d) + si * np.cos(d))
    for a, b in zip(got[:2], rot):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * scale)


def test_precision_without_variant_runs_einsum():
    """A ``dft_precision`` with ``dft_variant=None`` turns the kernel off,
    as in the reference: the einsum formulation at that precision."""
    args = tuple(_t(a) for a in _stage_inputs(np.float32))
    base = dict(zero_fill_to=ZF, autophase="none")
    K.reset_counters()
    got = spectral_pipeline_planar_raw(
        *args, PipelineConfig(**base, dft_precision="high"))
    assert K.counters()["plain_calls"]["spectrum"] == 0
    want = spectral_pipeline_planar_raw(
        *args, PipelineConfig(**base, dft_variant="einsum", dft_precision="high"))
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="precision"):
        spectral_pipeline_planar_raw(
            *args, PipelineConfig(**base, dft_precision="medium"))
    with pytest.raises(KeyError):  # the reference rejects it too
        ref_spectral(*(jnp.asarray(a.numpy()) for a in args),
                     RefConfig(**base, dft_precision="medium"))


@pytest.mark.parametrize("variant,precision", [("einsum", None), ("full", None),
                                               (None, "highest")])
def test_stacked_layout_needs_the_kernel(variant, precision):
    args = _stage_inputs(np.float32)
    kw = dict(zero_fill_to=ZF, autophase="single", spec_layout="stacked",
              dft_variant=variant, dft_precision=precision)
    with pytest.raises(ValueError) as ref_err:
        ref_spectral(*(jnp.asarray(a) for a in args), RefConfig(**kw))
    with pytest.raises(ValueError) as port_err:
        spectral_pipeline_planar_raw(*(_t(a) for a in args),
                                     PipelineConfig(**kw))
    assert str(port_err.value) == str(ref_err.value)
    out = spectral_pipeline_planar_raw(
        *(_t(a) for a in args),
        PipelineConfig(**{**kw, "dft_variant": "pallas", "dft_precision": None}))
    assert out[0].dim() == 3


@pytest.mark.parametrize("variant", [None, "einsum"])
def test_phase_barrier_is_bit_identical(variant):
    args = tuple(_t(a) for a in _stage_inputs(np.float32))
    outs = [spectral_pipeline_planar_raw(*args, PipelineConfig(
        zero_fill_to=ZF, autophase="single", ap_optimizer="grid",
        dft_variant=variant, phase_barrier=barrier)) for barrier in (False, True)]
    for a, b in zip(outs[0][:2] + outs[0][2], outs[1][:2] + outs[1][2]):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="bool"):
        spectral_pipeline_planar_raw(*args, PipelineConfig(
            zero_fill_to=ZF, autophase="single", ap_optimizer="grid",
            phase_barrier="yes"))


@pytest.mark.parametrize("autophase", ["single", "all", "none"])
def test_sharded_matmul_variant_equals_one_device(autophase):
    """The voxel mesh runs the matmul DFT per shard: the same spectra and
    phases as the one-device program, bit for bit."""
    args = tuple(_t(a) for a in _stage_inputs(np.float32))
    cfg = PipelineConfig(zero_fill_to=ZF, autophase=autophase,
                         ap_optimizer="grid", dft_variant="block")
    one = spectral_pipeline_planar_raw(*args, cfg)
    mesh = make_mesh(2, device="cpu")
    two = spectral_pipeline_sharded(*args, cfg, mesh, mesh.axis_names[0])
    for a, b in zip(one[:2] + one[2], two[:2] + two[2]):
        assert torch.equal(a, b)
