"""Complex <-> stacked-real conversions (PyTorch port of
:mod:`xmris_tpu.ops.utils`), for exporters and models that take no complex
dtype.  Both run on the payload's own namespace: numpy on the host, a
tensor on its device."""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import Coord, XmrArray, get_namespace
from xmris_tpu_torch.core.config import DIMS
from xmris_tpu_torch.core.utils import _check_dims


def to_real_imag(
    da: XmrArray,
    dim: str = DIMS.component,
    coords: tuple[str, str] = ("real", "imag"),
) -> XmrArray:
    """Stack real and imaginary parts along a new trailing ``component`` dim."""
    if get_namespace(da.data) is torch:
        data = torch.stack([da.data.real, da.data.imag], dim=-1)
    else:
        data = np.stack([da.data.real, da.data.imag], axis=-1)
    new_coords = {k: c.copy() for k, c in da.coords.items()}
    new_coords[dim] = Coord(dim, np.asarray(list(coords), dtype=object))
    out = XmrArray(data, dims=tuple(da.dims) + (dim,), attrs=da.attrs, name=da.name)
    out.coords = new_coords
    return out


def to_complex(
    da: XmrArray,
    dim: str = DIMS.component,
    coords: tuple[str, str] = ("real", "imag"),
) -> XmrArray:
    """Rebuild complex values from a stacked-component array."""
    _check_dims(da, dim, "to_complex")
    real_part = da.sel({dim: coords[0]})
    imag_part = da.sel({dim: coords[1]})
    out = real_part + imag_part * 1j
    out.name = da.name
    return out.assign_attrs(da.attrs)
