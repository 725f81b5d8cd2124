"""The port's k-space recon (``xmris_tpu_torch.recon``) against the JAX
package's, on the same seeded numpy k-space.

Every function, complex and planar, is held at ``tests/test_recon.py``'s own
tolerances (float64 parity: 1e-8 / 1e-10); the Walsh adaptive combine at an
odd and an even box, over 2-D and 3-D spatial axes and with tied coils.
The labeled SENSE functions run with ``device="cpu"``: without it a numpy
payload is staged on the card, and the call raises where there is none.
"""

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu import recon as jrecon
from xmris_tpu.recon import kspace as jks
from xmris_tpu.recon import sense as jsense

from xmris_tpu_torch import DIMS, XmrArray
from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch import recon as trecon
from xmris_tpu_torch.recon import kspace as tks
from xmris_tpu_torch.recon import sense as tsense

from test_recon import make_kspace_with_sens


def _both(da_ref):
    """The reference's k-space array and the port's twin (same payload,
    coords and attrs)."""
    port = XmrArray(da_ref.values, dims=da_ref.dims,
                    coords={k: (c.dim, c.values, c.attrs)
                            for k, c in da_ref.coords.items()},
                    attrs=dict(da_ref.attrs))
    return da_ref, port


def _same_labels(got, ref):
    assert got.dims == ref.dims
    assert got.attrs == ref.attrs
    assert sorted(got.coords) == sorted(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(got.coords[k].values, ref.coords[k].values)
        assert got.coords[k].dim == ref.coords[k].dim


@pytest.fixture(scope="module")
def phantom():
    da, phantom, sens = make_kspace_with_sens(n=32, n_coils=4, noise=0.01)
    return _both(da) + (phantom, sens)


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_kspace_to_image_and_rss_match_reference(phantom, payload):
    ref_da, da = phantom[:2]
    if payload == "tensor":
        da = da.to("cpu")
    img_r, img = jrecon.kspace_to_image(ref_da), trecon.kspace_to_image(da)
    assert isinstance(img.data, torch.Tensor) == (payload == "tensor")
    _same_labels(img, img_r)
    np.testing.assert_allclose(img.values, img_r.values, rtol=1e-10, atol=1e-12)
    for got, ref in ((trecon.rss_combine(img), jrecon.rss_combine(img_r)),
                     (trecon.rss_reconstruct(da), jrecon.rss_reconstruct(ref_da))):
        _same_labels(got, ref)
        assert got.dtype == (torch.float64 if payload == "tensor" else np.float64)
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-10, atol=1e-12)


def test_kspace_to_image_explicit_dims_and_errors():
    x = np.random.default_rng(0).normal(size=(8, 8)) + 0j
    ref = jrecon.kspace_to_image(xmt.XmrArray(x, dims=("a", "b")), dims=["a"],
                                 out_dims=["a_img"])
    got = trecon.kspace_to_image(XmrArray(x, dims=("a", "b")), dims=["a"],
                                 out_dims=["a_img"])
    assert got.dims == ref.dims == ("a_img", "b")
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="k-space"):
        trecon.kspace_to_image(XmrArray(np.zeros((4, 4), complex), dims=("a", "b")))


def test_rss_raw_forms_match_reference(phantom):
    k = phantom[0].values
    ref = np.asarray(jks.rss_reconstruct_raw(k, axes=(1, 2), coil_axis=0))
    got = tks.rss_reconstruct_raw(torch.as_tensor(k), axes=(1, 2), coil_axis=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-10)
    re, im = np.ascontiguousarray(k.real), np.ascontiguousarray(k.imag)
    ref_p = np.asarray(jks.rss_reconstruct_planar_raw(re, im, axes=(1, 2),
                                                      coil_axis=0))
    got_p = tks.rss_reconstruct_planar_raw(torch.as_tensor(re), torch.as_tensor(im),
                                           axes=(-2, -1), coil_axis=0)
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("calib_frac", [0.25, 0.4])
def test_sensitivity_maps_match_reference(phantom, calib_frac):
    ref_da, da, ph, sens = phantom
    ref = jrecon.estimate_sensitivities(ref_da, calib_frac=calib_frac)
    got = trecon.estimate_sensitivities(da, calib_frac=calib_frac, device="cpu")
    _same_labels(got, ref)
    assert got.dtype == ref.dtype == np.complex128
    np.testing.assert_allclose(got.values, ref.values, atol=1e-8)
    on_t = trecon.estimate_sensitivities(da.to("cpu"), calib_frac=calib_frac)
    assert on_t.data.dtype == torch.complex128
    np.testing.assert_allclose(on_t.values, ref.values, atol=1e-8)


def test_sensitivity_maps_match_truth_inside_object():
    """tests/test_recon.py's bar: mean error < 0.05 in the object's interior."""
    da_r, phantom, sens = make_kspace_with_sens(n=64, n_coils=4)
    est = trecon.estimate_sensitivities(_both(da_r)[1], calib_frac=0.4,
                                        device="cpu")
    truth = sens / np.sqrt(np.sum(np.abs(sens) ** 2, axis=0, keepdims=True))
    n = phantom.shape[0]
    yy, xx = np.mgrid[0:n, 0:n]
    interior = (phantom > 0.5) & ((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 5) ** 2)
    assert np.abs(est.values - truth)[:, interior].mean() < 0.05


def test_sensitivity_raw_forms_match_reference(phantom):
    k = phantom[0].values
    ref = np.asarray(jsense.estimate_sensitivities_raw(k, axes=(1, 2), coil_axis=0,
                                                       calib_frac=0.3))
    got = tsense.estimate_sensitivities_raw(torch.as_tensor(k), axes=(1, 2),
                                            coil_axis=0, calib_frac=0.3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-8)
    re, im = np.ascontiguousarray(k.real), np.ascontiguousarray(k.imag)
    r_re, r_im = jsense.estimate_sensitivities_planar_raw(re, im, axes=(1, 2),
                                                          coil_axis=0, calib_frac=0.3)
    g_re, g_im = tsense.estimate_sensitivities_planar_raw(
        torch.as_tensor(re), torch.as_tensor(im), axes=(1, 2), coil_axis=0,
        calib_frac=0.3)
    np.testing.assert_allclose(g_re.numpy(), np.asarray(r_re), atol=1e-8)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(r_im), atol=1e-8)
    for n, f in ((7, 0.25), (64, 0.3), (3, 0.9)):
        np.testing.assert_array_equal(tsense._hann_calib_window(n, f),
                                      jsense._hann_calib_window(n, f))


def test_sense_combine_raw_forms_match_reference():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))
    sens = rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))
    ref = np.asarray(jsense.sense_combine_raw(img, sens, 0))
    got = tsense.sense_combine_raw(torch.as_tensor(img), torch.as_tensor(sens), 0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    planes = [np.ascontiguousarray(x) for x in (img.real, img.imag, sens.real,
                                                sens.imag)]
    r_re, r_im = jsense.sense_combine_planar_raw(*planes, 0)
    g_re, g_im = tsense.sense_combine_planar_raw(*map(torch.as_tensor, planes), 0)
    np.testing.assert_allclose(g_re.numpy(), np.asarray(r_re), atol=1e-10)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(r_im), atol=1e-10)


def test_sense_combine_and_reconstruct_match_reference(phantom):
    ref_da, da, ph, sens = phantom
    img_r, img = jrecon.kspace_to_image(ref_da), trecon.kspace_to_image(da)
    ref = jrecon.sense_combine(img_r, xmt.XmrArray(sens, dims=img_r.dims))
    got = trecon.sense_combine(img, XmrArray(sens, dims=img.dims), device="cpu")
    _same_labels(got, ref)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got.values, ref.values, atol=1e-8)
    # A tensor image takes the numpy maps to its device; the result stays a
    # tensor.
    on_t = trecon.sense_combine(img.to("cpu"), XmrArray(sens, dims=img.dims))
    assert isinstance(on_t.data, torch.Tensor)
    np.testing.assert_allclose(on_t.values, ref.values, atol=1e-8)
    ref_s = jrecon.sense_reconstruct(ref_da, calib_frac=0.4)
    got_s = trecon.sense_reconstruct(da, calib_frac=0.4, device="cpu")
    _same_labels(got_s, ref_s)
    np.testing.assert_allclose(got_s.values, ref_s.values, atol=1e-8)


def test_sense_combine_recovers_the_phantom_exactly():
    """tests/test_recon.py: I = S p, so the matched filter returns p."""
    da_r, phantom, sens = make_kspace_with_sens(n=64, n_coils=4)
    img = trecon.kspace_to_image(_both(da_r)[1])
    out = trecon.sense_combine(img, XmrArray(sens, dims=img.dims), device="cpu")
    np.testing.assert_allclose(out.values.real, phantom, atol=1e-8)
    np.testing.assert_allclose(out.values.imag, 0.0, atol=1e-8)
    assert out.attrs["coil_combine"] == "sense" and DIMS.coil not in out.dims


@pytest.mark.parametrize("dtype", [np.complex64, np.float64, np.float32])
def test_staged_results_keep_the_reference_dtype(phantom, dtype):
    """``result_type(input, complex64)``: complex64 stays, float64 gives
    complex128, float32 complex64.  In float32 the reference's matmul DFT
    and ``torch.fft`` round differently, and the unit-RSS normalization
    magnifies that at dark pixels: the maps (|S| <= 1) are held at 1e-4
    there, at 1e-8 in float64."""
    ref_da, da = phantom[:2]
    vals = ref_da.values.astype(dtype) if dtype == np.complex64 else \
        ref_da.values.real.astype(dtype)
    r = jrecon.estimate_sensitivities(xmt.XmrArray(vals, dims=ref_da.dims))
    g = trecon.estimate_sensitivities(XmrArray(vals, dims=da.dims), device="cpu")
    assert g.dtype == r.dtype
    tol = 1e-8 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(g.values, r.values, atol=tol)


def _adaptive_inputs(spatial, n_coils, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n_coils,) + spatial) + 1j * rng.normal(
        size=(n_coils,) + spatial)
    return np.ascontiguousarray(img.real), np.ascontiguousarray(img.imag)


@pytest.mark.parametrize("spatial,block,coil_axis", [
    ((20, 18), 5, 0), ((20, 18), 4, 0), ((20, 18), 1, 0),
    ((10, 9, 6), 3, 0), ((10, 9, 6), 2, 2),
])
def test_adaptive_combine_matches_reference(spatial, block, coil_axis):
    """Even boxes pad low (b-1)//2, high b//2 and count the padding; the box
    runs over every non-coil axis."""
    re, im = _adaptive_inputs(spatial, 4, seed=block)
    re, im = np.moveaxis(re, 0, coil_axis), np.moveaxis(im, 0, coil_axis)
    r_re, r_im = jsense.adaptive_combine_planar_raw(re, im, coil_axis=coil_axis,
                                                    block=block)
    g_re, g_im = tsense.adaptive_combine_planar_raw(
        torch.as_tensor(re), torch.as_tensor(im), coil_axis=coil_axis, block=block)
    scale = float(np.sqrt(np.max(np.asarray(r_re) ** 2 + np.asarray(r_im) ** 2)))
    np.testing.assert_allclose(g_re.numpy(), np.asarray(r_re), atol=1e-10 * scale)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(r_im), atol=1e-10 * scale)


def test_adaptive_combine_ties_anchor_to_the_first_coil():
    """Coil 1 = i * coil 0 has bit for bit the same energy: both packages
    anchor the phase to coil 0 (the first maximum)."""
    re, im = _adaptive_inputs((16, 16), 3, seed=7)
    re[1], im[1] = -im[0], re[0]
    re[2], im[2] = 0.5 * re[2], 0.5 * im[2]
    energy = np.sum(re**2 + im**2, axis=(1, 2))
    assert energy[0] == energy[1] and energy.argmax() == 0
    r_re, r_im = jsense.adaptive_combine_planar_raw(re, im)
    g_re, g_im = tsense.adaptive_combine_planar_raw(torch.as_tensor(re),
                                                    torch.as_tensor(im))
    np.testing.assert_allclose(g_re.numpy(), np.asarray(r_re), atol=1e-10)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(r_im), atol=1e-10)
    # Anchored to coil 1 instead, the output turns by the phase between them.
    swapped = tsense.adaptive_combine_planar_raw(torch.as_tensor(re[[1, 0, 2]]),
                                                 torch.as_tensor(im[[1, 0, 2]]))
    assert not np.allclose(swapped[0].numpy(), np.asarray(r_re), atol=1e-3)


def test_adaptive_magnitude_matches_rss_in_object():
    """tests/test_recon.py's bar: within 2 % of RSS inside the object."""
    da_r, phantom, _ = make_kspace_with_sens(n=48, n_coils=4)
    img = trecon.kspace_to_image(_both(da_r)[1]).values
    o_re, o_im = tsense.adaptive_combine_planar_raw(
        torch.as_tensor(np.ascontiguousarray(img.real)),
        torch.as_tensor(np.ascontiguousarray(img.imag)))
    mag = np.sqrt(o_re.numpy() ** 2 + o_im.numpy() ** 2)
    rss = np.sqrt(np.sum(np.abs(img) ** 2, axis=0))
    mask = phantom > 0.5
    np.testing.assert_allclose(mag[mask], rss[mask], rtol=0.02)


def test_staged_functions_default_to_the_card(phantom):
    """A numpy payload runs on the card unless the caller passes
    device="cpu": without a card the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, da, _, sens = phantom
    img = trecon.kspace_to_image(da)
    for call in (lambda: trecon.estimate_sensitivities(da),
                 lambda: trecon.sense_combine(img, XmrArray(sens, dims=img.dims)),
                 lambda: trecon.sense_reconstruct(da)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="must match"):
        trecon.sense_combine(img, XmrArray(sens, dims=("a", "b", "c")),
                             device="cpu")


@pytest.mark.parametrize("n,n_coils", [(64, 4), (48, 4), (32, 8)])
def test_coil_phantom_is_the_reference_tests(n, n_coils):
    """``bench_inputs.coil_kspace_phantom``, which the card runs at 256 x 256
    as BASELINE config 3, is ``tests/test_recon.py``'s phantom bit for bit."""
    da, phantom, sens = make_kspace_with_sens(n=n, n_coils=n_coils)
    k, ph, s = bi.coil_kspace_phantom((n, n), n_coils)
    np.testing.assert_array_equal(ph, phantom)
    np.testing.assert_array_equal(s, sens)
    np.testing.assert_array_equal(k, da.values)
    maps = bi.unit_rss_coil_maps((6, 5, 4), 3)
    np.testing.assert_allclose(np.sum(np.abs(maps) ** 2, axis=0), 1.0, rtol=1e-12)
