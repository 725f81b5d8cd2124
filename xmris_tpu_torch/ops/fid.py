"""FID-domain operations: spectrum conversion, apodization, zero-filling.

Port of :mod:`xmris_tpu.ops.fid`, same formulas:

* ``to_spectrum`` = ortho FFT + fftshift;
* ``to_fid`` = ifftshift + ortho iFFT + time coords ``t = arange(n)/(n*df)``;
* ``apodize_exp``: weight ``exp(-pi * lb * t)``;
* ``apodize_lg``: weight ``exp(+pi * lb * t) * exp(-t^2 / T_G^2)`` with
  ``T_G = 2*sqrt(ln 2)/(pi*gb)``;
* ``zero_fill``: end/symmetric padding + linear coordinate extrapolation.

Weights are small 1-D vectors computed on the host from the coordinates and
broadcast-multiplied on the payload's own device.
"""

from __future__ import annotations

import numpy as np

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.core.config import ATTRS, COORDS, DIMS
from xmris_tpu_torch.core.utils import _check_dims, as_coord
from xmris_tpu_torch.ops.fourier import fft, fftshift, ifft, ifftshift
from xmris_tpu_torch.runtime.config import matching_dtypes


def to_spectrum(
    da: XmrArray, dim: str = DIMS.time, out_dim: str = DIMS.frequency
) -> XmrArray:
    """Convert a time-domain FID to a centered frequency-domain spectrum."""
    _check_dims(da, dim, "to_spectrum")
    return fftshift(fft(da, dim=dim, out_dim=out_dim), dim=out_dim)


def to_fid(
    da: XmrArray, dim: str = DIMS.frequency, out_dim: str = DIMS.time
) -> XmrArray:
    """Convert a centered spectrum back to a time-domain FID, with strictly
    positive time coordinates ``dt = 1/(n*df)``."""
    _check_dims(da, dim, "to_fid")

    result = ifft(ifftshift(da, dim=dim), dim=dim, out_dim=out_dim)

    if dim in da.coords:
        f_axis = da.coords[dim].values
        n = len(f_axis)
        if n > 1:
            df = abs(float(f_axis[1] - f_axis[0]))
            rebuilt_t = np.arange(n) / (n * df)
            if out_dim == DIMS.time:
                tick = as_coord(COORDS.time, out_dim, rebuilt_t)
            else:
                tick = Coord(out_dim, rebuilt_t)
            result = result.assign_coords({out_dim: tick})

    return result


def _apply_weight(da: XmrArray, dim: str, weight: np.ndarray) -> XmrArray:
    """Broadcast-multiply a 1-D weight along ``dim``, keeping axis order,
    coords and (explicitly re-attached) attrs."""
    real_dtype, _ = matching_dtypes(da.dtype)
    w = XmrArray(weight.astype(real_dtype), (dim,))
    out = (da * w).transpose(*da.dims)
    out = out.assign_attrs(da.attrs)  # binary ops drop attrs
    out.name = da.name
    return out


def apodize_exp(da: XmrArray, dim: str = DIMS.time, lb: float = 1.0) -> XmrArray:
    """Exponential line-broadening filter: multiply by ``exp(-pi * lb * t)``."""
    _check_dims(da, dim, "apodize_exp")
    t = da.coords[dim].values.astype(np.float64)
    out = _apply_weight(da, dim, np.exp(-np.pi * lb * t))
    out.attrs[ATTRS.apodization_lb] = lb
    return out


def apodize_lg(
    da: XmrArray, dim: str = DIMS.time, lb: float = 1.0, gb: float = 1.0
) -> XmrArray:
    """Lorentz-to-Gauss filter: ``exp(+pi*lb*t) * exp(-t^2/T_G^2)``.

    Cancels ``lb`` Hz of Lorentzian broadening and imposes a Gaussian
    lineshape of width ``gb`` Hz (``T_G = 2*sqrt(ln 2)/(pi*gb)``; ``gb ==
    0`` leaves out the Gaussian factor).
    """
    _check_dims(da, dim, "apodize_lg")
    t = da.coords[dim].values.astype(np.float64)
    undo_lorentz = np.exp(np.pi * lb * t)
    if gb != 0:
        gauss_tc = (2.0 * np.sqrt(np.log(2.0))) / (np.pi * gb)
        impose_gauss = np.exp(-((t / gauss_tc) ** 2))
    else:
        impose_gauss = np.ones_like(t)
    out = _apply_weight(da, dim, undo_lorentz * impose_gauss)
    out.attrs[ATTRS.apodization_lb] = lb
    out.attrs[ATTRS.apodization_gb] = gb
    return out


def zero_fill(
    da: XmrArray,
    dim: str = DIMS.time,
    target_points: int = 1024,
    position: str = "end",
) -> XmrArray:
    """Pad ``dim`` with zeros to ``target_points`` total points.

    ``position="end"`` appends, ``"symmetric"`` splits the padding.
    Coordinates are linearly extrapolated and re-labeled from the vocabulary
    for a known physical axis.  A copy when the target is not larger than
    the current size.
    """
    _check_dims(da, dim, "zero_fill")

    n_now = da.sizes[dim]
    if target_points <= n_now:
        return da.copy()

    extra = target_points - n_now
    if position == "end":
        margins = (0, extra)
    elif position == "symmetric":
        margins = (extra // 2, extra - extra // 2)
    else:
        raise ValueError("`position` must be either 'end' or 'symmetric'.")

    padded = da.pad({dim: margins}, mode="constant", constant_values=0)

    if dim in da.coords:
        axis_old = da.coords[dim].values
        if len(axis_old) > 1:
            step = axis_old[1] - axis_old[0]
            first = axis_old[0] - margins[0] * step
            axis_new = first + np.arange(target_points) * step
            vocab = next(
                (
                    c
                    for c in (COORDS.time, COORDS.frequency, COORDS.chemical_shift)
                    if c == dim
                ),
                None,
            )
            if vocab is not None:
                tick = as_coord(vocab, dim, axis_new)
            else:
                tick = Coord(dim, axis_new, da.coords[dim].attrs)
            padded = padded.assign_coords({dim: tick})

    padded = padded.assign_attrs(da.attrs)
    padded.attrs[ATTRS.zero_fill_target] = target_points
    padded.attrs[ATTRS.zero_fill_position] = position
    return padded
