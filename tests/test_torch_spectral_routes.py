"""The spectral stage on every zero-fill, against the JAX package.

The port takes each (n_time, zero_fill_to) by one of three routes, chosen
from the shapes alone (``dft_cuda.route``): K1's FFT kernel for a
power-of-two output (256..8192), K1's split kernel for the other lengths
with a Cooley-Tukey split, and the dense route (one matmul against the
fftshifted ortho DFT matrix, summed in float64, plain PyTorch as the
reference's XLA DFT is) for the rest.  On the CPU the spectrum is ``spectrum_plain`` whatever
the route; the dense route's own function is held here too.  Spectra are
held to 1e-6 * max|S| of the reference's (which runs its XLA DFT on the
CPU; with ``autophase="single"``, after rotating the reference's onto the
port's phases); the pivot must be the reference's, and the phases are held
as ``test_torch_slice.py`` holds them at the bench shape.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xmris_tpu.parallel.pipeline import PipelineConfig as RefConfig
from xmris_tpu.parallel.planar_pipeline import (
    spectral_pipeline_planar_raw as ref_spectral,
)

from xmris_tpu_torch.ops.kernels import _counters, dft_cuda
from xmris_tpu_torch.ops.phasing import _phased_real_planar, acme_score_raw
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw

from _torch_parity import SW, bench_phantom

SHAPES = [(500, 1024), (1020, 2048), (500, 1500), (1000, 1500)]


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _inputs(n_in, n_out, lb=5.0):
    fids, _, _ = bench_phantom(n_voxels=6, n_t=n_in)
    weight = np.exp(-np.pi * lb * np.arange(n_out) / SW).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(n_out, d=1.0 / SW)).astype(
        np.float32)
    return fids, weight, freqs


@pytest.mark.parametrize("n_in,n_out,want", [
    (500, 1024, "fft"), (1020, 2048, "fft"), (1024, 2048, "fft"),
    (768, 1536, "split"), (1000, 2000, "split"), (64, 128, "split"),
    (500, 1500, "dense"), (1000, 1500, "dense"), (1001, 1001, "dense"),
    (100, 100, "dense"),
])
def test_route_names_each_of_the_three(n_in, n_out, want):
    assert dft_cuda.route(n_in, n_out) == want
    assert dft_cuda.pallas_split_ok(n_in, n_out) == (
        want == "split" or (want == "fft" and n_in % 8 == 0))


@pytest.mark.parametrize("autophase", ["none", "single"])
@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_spectral_stage_matches_reference(n_in, n_out, autophase):
    fids, weight, freqs = _inputs(n_in, n_out)
    ref = ref_spectral(
        jnp.asarray(np.ascontiguousarray(fids.real)),
        jnp.asarray(np.ascontiguousarray(fids.imag)), jnp.asarray(weight),
        jnp.asarray(freqs),
        RefConfig(zero_fill_to=n_out, lb=5.0, autophase=autophase,
                  ap_optimizer="grid", spec_layout="flat"))
    got = spectral_pipeline_planar_raw(
        _t(fids.real), _t(fids.imag), _t(weight), _t(freqs),
        PipelineConfig(zero_fill_to=n_out, autophase=autophase,
                       ap_optimizer="grid", spec_layout="flat"))
    ref_re, ref_im = np.asarray(ref[0]), np.asarray(ref[1])
    assert tuple(got[0].shape) == ref_re.shape == (len(fids), n_out)
    (p0, p1, pivot), (p0_r, p1_r, piv_r) = got[2], ref[2]
    assert float(pivot) == float(piv_r)
    # The reference's spectra rotated onto the port's phases.
    x_range = float(freqs[-1]) - float(freqs[0])

    def phi(a0, a1):
        return (np.deg2rad(float(a0)) + np.deg2rad(float(a1))
                * ((freqs.astype(np.float64) - float(pivot)) / x_range))

    d = (phi(p0, p1) - phi(p0_r, p1_r))[None]
    rot_re = ref_re * np.cos(d) - ref_im * np.sin(d)
    rot_im = ref_re * np.sin(d) + ref_im * np.cos(d)
    scale = float(np.maximum(np.abs(ref_re).max(), np.abs(ref_im).max()))
    for a, b in ((got[0], rot_re), (got[1], rot_im)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * scale)
    if autophase == "none":
        assert float(p0) == float(p1) == float(pivot) == 0.0
        return
    # The two grid searches round differently (test_torch_slice.py holds
    # the bench shape so): |dp0| <= 0.5 deg (test_dft_pallas.py:161), and
    # the port's ACME score on the pivot row no worse than the reference's
    # by more than 1e-5 relative.
    assert abs(float(p0) - float(p0_r)) <= 0.5
    m2 = ref_re.astype(np.float64) ** 2 + ref_im.astype(np.float64) ** 2
    row = int(np.argmax(m2.max(1)))
    un = ref_spectral(
        jnp.asarray(np.ascontiguousarray(fids.real)),
        jnp.asarray(np.ascontiguousarray(fids.imag)), jnp.asarray(weight),
        jnp.asarray(freqs),
        RefConfig(zero_fill_to=n_out, lb=5.0, autophase="none",
                  ap_optimizer="grid", spec_layout="flat"))
    un_re = np.asarray(un[0])[row].astype(np.float64)
    un_im = np.asarray(un[1])[row].astype(np.float64)
    assert _score(un_re, un_im, freqs, p0, p1, pivot) <= _score(
        un_re, un_im, freqs, p0_r, p1_r, piv_r) * (1 + 1e-5)


def _score(row_re, row_im, freqs, p0, p1, pivot):
    """ACME score in float64 of one row at the given phases."""
    f = torch.as_tensor(freqs, dtype=torch.float64)
    d = _phased_real_planar(
        torch.as_tensor(row_re), torch.as_tensor(row_im), f,
        torch.tensor(float(p0), dtype=torch.float64),
        torch.tensor(float(p1), dtype=torch.float64), float(pivot),
        float(f[-1] - f[0]))
    return float(acme_score_raw(d))


@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_dense_route_matches_plain_and_reference(n_in, n_out):
    fids, weight, freqs = _inputs(n_in, n_out)
    xr, xi, w = _t(fids.real), _t(fids.imag), _t(weight[:n_in])
    before = dict(_counters.LAUNCHES)
    d_re, d_im, d_mv, d_mi = dft_cuda.spectrum_dense(xr, xi, n_out, window=w,
                                                     with_maxmag=True)
    assert _counters.LAUNCHES["spectrum_dense"] == before["spectrum_dense"] + 1
    assert _counters.LAUNCHES["spectrum"] == before["spectrum"]
    p_re, p_im, p_mv, p_mi = dft_cuda.spectrum_plain(xr, xi, n_out, window=w,
                                                     with_maxmag=True)
    scale = float(torch.maximum(p_re.abs().max(), p_im.abs().max()))
    torch.testing.assert_close(d_re, p_re, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(d_im, p_im, rtol=0, atol=1e-6 * scale)
    assert torch.equal(d_mi, p_mi)
    torch.testing.assert_close(d_mv, p_mv, rtol=1e-5, atol=0)
    ref = ref_spectral(
        jnp.asarray(np.ascontiguousarray(fids.real)),
        jnp.asarray(np.ascontiguousarray(fids.imag)), jnp.asarray(weight),
        jnp.asarray(freqs),
        RefConfig(zero_fill_to=n_out, lb=5.0, autophase="none",
                  ap_optimizer="grid", spec_layout="flat"))
    np.testing.assert_allclose(d_re.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(d_im.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("n_in,n_out", [(500, 1500), (1000, 1500)])
def test_dense_route_holds_the_parity_bar_on_white_noise(n_in, n_out):
    """White noise has no peak to set a large max|S|: the dense route's
    sums (2 n_in terms) must still land within 1e-6 max|S| of the FFT."""
    rng = np.random.default_rng(7)
    xr, xi = (_t(rng.normal(size=(512, n_in)).astype(np.float32))
              for _ in range(2))
    w = _t(rng.uniform(0.5, 1.0, n_in).astype(np.float32))
    got = dft_cuda.spectrum_dense(xr, xi, n_out, window=w, with_maxmag=True)
    want = dft_cuda.spectrum_plain(xr, xi, n_out, window=w, with_maxmag=True)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("n_in,n_out", [(500, 1024), (500, 1500)])
def test_stacked_layout_without_a_split_raises(n_in, n_out):
    """As in the reference: the stacked layout needs the split, so a shape
    without one raises ValueError on every route (the FFT route's too)."""
    fids, weight, freqs = _inputs(n_in, n_out)
    with pytest.raises(ValueError, match="stacked"):
        ref_spectral(
            jnp.asarray(np.ascontiguousarray(fids.real)),
            jnp.asarray(np.ascontiguousarray(fids.imag)), jnp.asarray(weight),
            jnp.asarray(freqs),
            RefConfig(zero_fill_to=n_out, lb=5.0, autophase="none",
                      ap_optimizer="grid", spec_layout="stacked"))
    cfg = PipelineConfig(zero_fill_to=n_out, autophase="none",
                         ap_optimizer="grid", spec_layout="stacked")
    with pytest.raises(ValueError, match="stacked"):
        spectral_pipeline_planar_raw(_t(fids.real), _t(fids.imag),
                                     _t(weight), _t(freqs), cfg)
    for fn in (dft_cuda.spectrum_plain, dft_cuda.spectrum_dense):
        with pytest.raises(ValueError, match="stacked"):
            fn(_t(fids.real), _t(fids.imag), n_out, stacked_out=True)


def test_truncation_still_raises():
    fids, weight, freqs = _inputs(1000, 1000)
    with pytest.raises(ValueError, match="split"):
        dft_cuda.route(1000, 500)
    for fn in (dft_cuda.spectrum_plain, dft_cuda.spectrum_dense):
        with pytest.raises(ValueError, match="split"):
            fn(_t(fids.real), _t(fids.imag), 500)
    with pytest.raises(ValueError, match="split"):
        spectral_pipeline_planar_raw(
            _t(fids.real), _t(fids.imag), _t(weight[:500]), _t(freqs[:500]),
            PipelineConfig(zero_fill_to=500, autophase="none",
                           ap_optimizer="grid"))
