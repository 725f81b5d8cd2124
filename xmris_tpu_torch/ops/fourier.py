"""Fourier engine: ortho-normalized N-D FFTs over named dimensions.

Port of :mod:`xmris_tpu.ops.fourier`: ``fftshift`` rolls data and coords by
``n//2``, ``ifftshift`` by ``(n+1)//2``; ``fft``/``ifft`` are ortho-normalized
``fftn``/``ifftn`` over named dims with reciprocal coordinates from
``fftfreq(n, d)``; ``fftc``/``ifftc`` are ifftshift -> transform -> fftshift.
A numpy payload is transformed on the host with ``np.fft``, a tensor payload
on its device with ``torch.fft`` (the reference uses ``jnp.fft`` here, no
kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.core.config import COORDS, DIMS, XmrTerm
from xmris_tpu_torch.core.utils import _check_dims, as_coord


def fftn_ortho(data: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """Ortho-normalized N-D FFT of a tensor over ``axes``, on its device."""
    return torch.fft.fftn(data, dim=tuple(axes), norm="ortho")


def ifftn_ortho(data: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """Ortho-normalized N-D inverse FFT of a tensor over ``axes``, on its
    device."""
    return torch.fft.ifftn(data, dim=tuple(axes), norm="ortho")


def _transform_values(data, axes: tuple[int, ...], inverse: bool):
    """Ortho FFT over ``axes`` on the payload's own namespace."""
    if isinstance(data, torch.Tensor):
        return (ifftn_ortho if inverse else fftn_ortho)(data, axes)
    fn = np.fft.ifftn if inverse else np.fft.fftn
    return fn(data, axes=axes, norm="ortho")


def fftshift(da: XmrArray, dim: str | list[str]) -> XmrArray:
    """Move the zero-frequency component to the center (rolls data + coords)."""
    dims = [dim] if isinstance(dim, str) else dim
    _check_dims(da, dims, "fftshift")
    return da.roll({d: da.sizes[d] // 2 for d in dims}, roll_coords=True)


def ifftshift(da: XmrArray, dim: str | list[str]) -> XmrArray:
    """Exact inverse of :func:`fftshift` (rolls by ``(n+1)//2``)."""
    dims = [dim] if isinstance(dim, str) else dim
    _check_dims(da, dims, "ifftshift")
    return da.roll({d: (da.sizes[d] + 1) // 2 for d in dims}, roll_coords=True)


def _convert_fft_coords(
    da: XmrArray,
    dim: str,
    out_dim: str | None = None,
    term: XmrTerm | None = None,
) -> XmrArray:
    """Unshifted reciprocal coordinates for a transformed dimension: sample
    spacing from the first two coordinate values, ``fftfreq(n, d)``, optional
    rename and vocabulary metadata."""
    n_points = da.sizes[dim]
    if dim in da.coords and len(da.coords[dim].values) > 1:
        old = da.coords[dim].values
        delta = float(old[1] - old[0])
    else:
        delta = 1.0

    new_coords = np.fft.fftfreq(n_points, d=delta)
    target_dim = out_dim if out_dim is not None else dim

    if out_dim is not None and out_dim != dim:
        da = da.rename({dim: out_dim})
        if dim in da.coords:
            da = da.drop_coords(dim)

    coord = (
        as_coord(term, target_dim, new_coords)
        if term is not None
        else Coord(target_dim, new_coords)
    )
    return da.assign_coords({target_dim: coord})


def _fft_impl(
    da: XmrArray,
    dim: str | list[str],
    out_dim: str | list[str] | None,
    inverse: bool,
    name: str,
) -> XmrArray:
    dims = [dim] if isinstance(dim, str) else list(dim)
    _check_dims(da, dims, name)

    out_dims = [out_dim] if isinstance(out_dim, str) else out_dim
    if out_dims is not None and len(dims) != len(out_dims):
        raise ValueError("`dim` and `out_dim` lists must have the same length.")

    axes = tuple(da.get_axis_num(d) for d in dims)
    out = da.copy(data=_transform_values(da.data, axes, inverse))

    for i, d in enumerate(dims):
        o_dim = out_dims[i] if out_dims else None
        if not inverse:  # time -> frequency metadata
            term = (
                COORDS.frequency
                if (d == DIMS.time and o_dim in (None, DIMS.frequency))
                else None
            )
        else:  # frequency -> time metadata
            term = (
                COORDS.time
                if (d == DIMS.frequency and o_dim in (None, DIMS.time))
                else None
            )
        out = _convert_fft_coords(out, dim=d, out_dim=o_dim, term=term)
    return out


def fft(
    da: XmrArray,
    dim: str | list[str] = DIMS.time,
    out_dim: str | list[str] | None = None,
) -> XmrArray:
    """Ortho-normalized, unshifted N-D FFT over named dimensions; transformed
    dimensions get unshifted reciprocal coordinates."""
    return _fft_impl(da, dim, out_dim, inverse=False, name="fft")


def ifft(
    da: XmrArray,
    dim: str | list[str] = DIMS.frequency,
    out_dim: str | list[str] | None = None,
) -> XmrArray:
    """Ortho-normalized, unshifted N-D inverse FFT over named dimensions."""
    return _fft_impl(da, dim, out_dim, inverse=True, name="ifft")


def fftc(
    da: XmrArray,
    dim: str | list[str] = DIMS.time,
    out_dim: str | list[str] | None = None,
) -> XmrArray:
    """Centered N-D FFT: ``ifftshift -> fft -> fftshift``."""
    new_dims = out_dim if out_dim is not None else dim
    return fftshift(fft(ifftshift(da, dim=dim), dim=dim, out_dim=out_dim), dim=new_dims)


def ifftc(
    da: XmrArray,
    dim: str | list[str] = DIMS.frequency,
    out_dim: str | list[str] | None = None,
) -> XmrArray:
    """Centered N-D inverse FFT: ``ifftshift -> ifft -> fftshift``."""
    new_dims = out_dim if out_dim is not None else dim
    return fftshift(
        ifft(ifftshift(da, dim=dim), dim=dim, out_dim=out_dim), dim=new_dims
    )
