"""Coil sensitivity estimation and optimal-SNR coil combination (PyTorch
port of :mod:`xmris_tpu.recon.sense`).

* **Low-resolution sensitivity maps**: apodize the central (calibration)
  region of k-space with a separable Hann window, inverse-transform, and
  normalize by the RSS image: ``S_c = I_c^low / RSS(I^low)``.
* **SENSE (matched-filter) combine**: given maps,
  ``x = sum_c conj(S_c) I_c / sum_c |S_c|^2``, the optimal-SNR
  unaccelerated SENSE solution; unlike RSS it keeps the phase.
* **Walsh adaptive combine**: per-pixel dominant eigenvector of the locally
  box-smoothed coil covariance, by batched power iteration.

The raw functions take tensors (arrays become CPU tensors) and run on their
device; the covariance, the power iteration and the combine sums are plain
torch with the sums written out (no matmul, so no TF32 path).  The labeled
``estimate_sensitivities`` and ``sense_combine`` keep a tensor payload on
its device and return a tensor there; a numpy payload is staged on
``device`` (the card unless the caller passes ``"cpu"``) and comes back as
the reference's host array, of dtype ``result_type(input, complex64)``.
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.core.config import DIMS
from xmris_tpu_torch.core.utils import _check_dims, card_device
from xmris_tpu_torch.recon.kspace import _axes, centered_ifftn
from xmris_tpu_torch.runtime.profiling import spanned

_EPS = 1e-12


def _hann_calib_window(n: int, calib_frac: float) -> np.ndarray:
    """1-D window passing the central ``calib_frac`` of a length-n axis,
    Hann-tapered to zero at the calibration edges (centered k-space)."""
    m = max(4, int(round(n * calib_frac)))
    m = min(m, n)
    w = np.zeros(n)
    ramp = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(m) / max(m - 1, 1)))
    start = (n - m) // 2
    w[start : start + m] = ramp
    return w


def _window(shape, ax: int, calib_frac: float, like: torch.Tensor) -> torch.Tensor:
    """The calibration window of axis ``ax``, shaped to broadcast."""
    bshape = [1] * len(shape)
    bshape[ax] = shape[ax]
    w = _hann_calib_window(shape[ax], calib_frac)
    return torch.as_tensor(w, dtype=like.dtype, device=like.device).reshape(bshape)


# ---------------------------------------------------------------------------
# Raw functions (complex + planar)
# ---------------------------------------------------------------------------


def estimate_sensitivities_raw(
    kspace, axes: tuple[int, ...], coil_axis: int, calib_frac: float = 0.25
):
    """Complex-input sensitivity maps from the k-space calibration region."""
    kspace = torch.as_tensor(kspace)
    axes = _axes(kspace.ndim, axes)
    real = kspace.real if kspace.is_complex() else kspace
    win = torch.ones((), dtype=real.dtype, device=real.device)
    for ax in axes:
        win = win * _window(kspace.shape, ax, calib_frac, real)
    low = centered_ifftn(kspace * win, axes)
    rss = torch.sqrt(torch.sum((low * low.conj()).real, dim=coil_axis, keepdim=True))
    return low / torch.clamp_min(rss, _EPS)


def estimate_sensitivities_planar_raw(
    k_re, k_im, axes: tuple[int, ...], coil_axis: int, calib_frac: float = 0.25
):
    """Planar sensitivity maps: window each plane, centered inverse
    transform, normalize by the RSS over coils."""
    k_re, k_im = torch.as_tensor(k_re), torch.as_tensor(k_im)
    axes = _axes(k_re.ndim, axes)
    for ax in axes:
        w = _window(k_re.shape, ax, calib_frac, k_re)
        k_re = k_re * w
        k_im = k_im * w
    img = centered_ifftn(torch.complex(k_re, k_im), axes)
    re, im = img.real, img.imag
    rss = torch.sqrt(torch.sum(re * re + im * im, dim=coil_axis, keepdim=True))
    rss = torch.clamp_min(rss, _EPS)
    return re / rss, im / rss


def sense_combine_raw(img, sens, coil_axis: int):
    """Matched-filter combine: ``sum conj(S) I / sum |S|^2`` (complex)."""
    img, sens = torch.as_tensor(img), torch.as_tensor(sens)
    num = torch.sum(sens.conj() * img, dim=coil_axis)
    den = torch.sum((sens * sens.conj()).real, dim=coil_axis)
    return num / torch.clamp_min(den, _EPS)


def sense_combine_planar_raw(i_re, i_im, s_re, s_im, coil_axis: int):
    """Planar matched-filter combine."""
    i_re, i_im, s_re, s_im = (torch.as_tensor(x) for x in (i_re, i_im, s_re, s_im))
    num_re = torch.sum(s_re * i_re + s_im * i_im, dim=coil_axis)
    num_im = torch.sum(s_re * i_im - s_im * i_re, dim=coil_axis)
    den = torch.clamp_min(torch.sum(s_re * s_re + s_im * s_im, dim=coil_axis), _EPS)
    return num_re / den, num_im / den


def _box_mean(x: torch.Tensor, first: int, block: int) -> torch.Tensor:
    """Mean over a ``block``-wide box along every axis from ``first`` on,
    zero-padded as ``reduce_window(..., "SAME")`` pads (low (b-1)//2, high
    b//2) and divided by ``block**n_axes`` (the padding counts)."""
    n_axes = x.ndim - first
    lo, hi = (block - 1) // 2, block // 2
    for ax in range(first, x.ndim):
        n = x.shape[ax]
        xp = torch.nn.functional.pad(x.movedim(ax, -1), (lo, hi))
        acc = xp[..., 0:n]
        for k in range(1, block):
            acc = acc + xp[..., k : k + n]
        x = acc.movedim(-1, ax)
    return x / float(block**n_axes)


def adaptive_combine_planar_raw(
    i_re, i_im, coil_axis: int = 0, block: int = 5, n_iter: int = 12
):
    """Walsh adaptive combine: per-pixel dominant eigenvector of the locally
    averaged coil covariance, via batched power iteration.

    ``i_re/i_im``: planar coil images with the coils on ``coil_axis``.  The
    C x C covariance entries are C^2 maps smoothed with a ``block``-wide box
    over every non-coil axis; every pixel's eigenvector then iterates
    ``n_iter`` times at once, is phase-anchored to the strongest coil (the
    first of equals) and combines ``sum conj(v) I``.  Returns the combined
    planar pair.
    """
    i_re = torch.as_tensor(i_re).movedim(coil_axis, 0)
    i_im = torch.as_tensor(i_im).movedim(coil_axis, 0)
    c = i_re.shape[0]

    # R[a, b] = I_a conj(I_b), smoothed spatially: (C, C, ...).
    a_re, a_im, b_re, b_im = i_re[:, None], i_im[:, None], i_re[None], i_im[None]
    r_re = a_re * b_re + a_im * b_im
    r_im = a_im * b_re - a_re * b_im
    if block > 1:
        r_re = _box_mean(r_re, 2, block)
        r_im = _box_mean(r_im, 2, block)

    v_re = torch.ones_like(i_re) / float(np.sqrt(float(c)))
    v_im = torch.zeros_like(i_re)
    for _ in range(n_iter):
        w_re = (r_re * v_re[None]).sum(1) - (r_im * v_im[None]).sum(1)
        w_im = (r_re * v_im[None]).sum(1) + (r_im * v_re[None]).sum(1)
        norm = torch.sqrt(torch.sum(w_re * w_re + w_im * w_im, dim=0, keepdim=True))
        norm = torch.clamp_min(norm, _EPS)
        v_re, v_im = w_re / norm, w_im / norm

    # Phase-anchor to the strongest coil so the combined phase is smooth.
    energy = torch.sum(i_re * i_re + i_im * i_im, dim=tuple(range(1, i_re.ndim)))
    ref = int(torch.argmax(energy))
    ref_re, ref_im = v_re[ref], v_im[ref]
    ref_mag = torch.clamp_min(torch.sqrt(ref_re**2 + ref_im**2), _EPS)
    ph_re, ph_im = ref_re / ref_mag, ref_im / ref_mag
    v_re, v_im = v_re * ph_re + v_im * ph_im, v_im * ph_re - v_re * ph_im

    out_re = torch.sum(v_re * i_re + v_im * i_im, dim=0)
    out_im = torch.sum(v_re * i_im - v_im * i_re, dim=0)
    return out_re, out_im


# ---------------------------------------------------------------------------
# Labeled API
# ---------------------------------------------------------------------------


def _planes(data, dev):
    """(re, im) of a tensor payload where it lies, or of a numpy payload
    uploaded to ``dev`` (an imaginary plane of zeros for real data)."""
    if isinstance(data, torch.Tensor):
        t = data
    else:
        t = torch.as_tensor(np.ascontiguousarray(data), device=dev)
    if t.is_complex():
        return t.real, t.imag
    return t, torch.zeros_like(t)


def _joined(re, im, data):
    """The complex result: a tensor where a tensor payload lies, else a host
    array of dtype ``result_type(data, complex64)`` as the reference's."""
    if isinstance(data, torch.Tensor):
        return torch.complex(re, im)
    out = re.cpu().numpy().astype(np.result_type(data.dtype, np.complex64))
    out += 1j * im.cpu().numpy()
    return out


def estimate_sensitivities(
    da: XmrArray,
    dims: list[str] | None = None,
    coil_dim: str = DIMS.coil,
    calib_frac: float = 0.25,
    *,
    device="cuda",
) -> XmrArray:
    """Coil sensitivity maps from a k-space array's calibration region.

    ``dims`` defaults to the kx/ky/kz dims present.  Returns complex maps of
    the same shape with unit-RSS normalization; lineage records the
    calibration fraction.  A tensor payload stays on its device; a numpy
    payload runs on ``device`` and comes back to the host.
    """
    if dims is None:
        dims = [d for d in (DIMS.kx, DIMS.ky, DIMS.kz) if d in da.dims]
        if not dims:
            raise ValueError(
                "No k-space dimensions (kx/ky/kz) found; pass `dims` explicitly."
            )
    _check_dims(da, dims + [coil_dim], "estimate_sensitivities")
    axes = tuple(da.get_axis_num(d) for d in dims)
    coil_axis = da.get_axis_num(coil_dim)
    data = da.data
    dev = None if isinstance(data, torch.Tensor) else card_device(
        device, "estimate_sensitivities")
    k_re, k_im = _planes(data, dev)
    s_re, s_im = estimate_sensitivities_planar_raw(k_re, k_im, axes, coil_axis,
                                                   calib_frac)
    out = XmrArray(_joined(s_re, s_im, data), dims=da.dims, attrs=da.attrs.copy(),
                   name=da.name)
    out.coords = {k: c.copy() for k, c in da.coords.items()}
    out.attrs["sensitivity_calib_frac"] = calib_frac
    return out


@spanned("recon")
def sense_combine(
    img: XmrArray, sens: XmrArray, coil_dim: str = DIMS.coil, *, device="cuda"
) -> XmrArray:
    """Matched-filter (unaccelerated SENSE) coil combine with given maps.

    Runs where a tensor payload lies (the other operand follows it there),
    else on ``device`` with the host result.
    """
    _check_dims(img, coil_dim, "sense_combine")
    if img.dims != sens.dims:
        raise ValueError(
            f"Image dims {img.dims} and sensitivity dims {sens.dims} must match."
        )
    ax = img.get_axis_num(coil_dim)
    i_data, s_data = img.data, sens.data
    on = next((x for x in (i_data, s_data) if isinstance(x, torch.Tensor)), None)
    dev = on.device if on is not None else card_device(device, "sense_combine")
    i_re, i_im = _planes(i_data, dev)
    s_re, s_im = _planes(s_data, dev)
    o_re, o_im = sense_combine_planar_raw(i_re, i_im, s_re.to(dev), s_im.to(dev), ax)
    combined = _joined(o_re, o_im, on if on is not None else np.asarray(i_data))
    new_dims = tuple(d for d in img.dims if d != coil_dim)
    out = XmrArray(combined, dims=new_dims, attrs=img.attrs.copy(), name=img.name)
    out.coords = {k: c.copy() for k, c in img.coords.items() if c.dim != coil_dim}
    out.attrs["coil_combine"] = "sense"
    return out


def sense_reconstruct(
    da: XmrArray,
    dims: list[str] | None = None,
    coil_dim: str = DIMS.coil,
    calib_frac: float = 0.25,
    *,
    device="cuda",
) -> XmrArray:
    """Full Cartesian SENSE recon: estimate maps from the calibration
    region, centered iFFT, matched-filter combine.  Phase-preserving and
    noise-bias-free, unlike :func:`~xmris_tpu_torch.recon.kspace.rss_reconstruct`.
    """
    from xmris_tpu_torch.recon.kspace import kspace_to_image

    sens_k = estimate_sensitivities(
        da, dims=dims, coil_dim=coil_dim, calib_frac=calib_frac, device=device
    )
    img = kspace_to_image(da, dims=dims)
    # The maps were computed on the k-space dims; rename to the image dims.
    sens = XmrArray(sens_k.data, dims=img.dims, attrs=sens_k.attrs)
    sens.coords = {k: c.copy() for k, c in img.coords.items()}
    return sense_combine(img, sens, coil_dim=coil_dim, device=device)
