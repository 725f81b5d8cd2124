"""Cartesian k-space reconstruction: centered iFFT + RSS coil combine
(PyTorch port of :mod:`xmris_tpu.recon.kspace`).

BASELINE config 3: 8-coil 256x256 centered inverse FFT with
root-sum-of-squares coil combination.  The labeled functions run on the
payload's own namespace, as in the reference: a numpy payload on the host,
a tensor payload on its device (the result is a tensor there).  The raw
functions take tensors (or arrays, as CPU tensors) and run on their device;
the transforms are ``torch.fft`` (the reference's are ``jnp.fft`` and the XLA
matmul DFT, no Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import XmrArray, get_namespace
from xmris_tpu_torch.core.config import DIMS
from xmris_tpu_torch.core.utils import _check_dims
from xmris_tpu_torch.ops.fourier import ifftc
from xmris_tpu_torch.runtime.profiling import spanned


def _axes(ndim: int, axes) -> tuple[int, ...]:
    return tuple(a % ndim for a in axes)


def centered_ifftn(data: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """``fftshift(ifftn(ifftshift(data), ortho))`` over ``axes``."""
    shifted = torch.fft.ifftshift(data, dim=axes)
    return torch.fft.fftshift(torch.fft.ifftn(shifted, dim=axes, norm="ortho"),
                              dim=axes)


def rss_reconstruct_raw(kspace, axes: tuple[int, ...], coil_axis: int):
    """Centered N-D iFFT over ``axes`` + RSS magnitude combine over
    ``coil_axis``."""
    kspace = torch.as_tensor(kspace)
    img = centered_ifftn(kspace, _axes(kspace.ndim, axes))
    return torch.sqrt(torch.sum((img * img.conj()).real, dim=coil_axis))


def rss_reconstruct_planar_raw(k_re, k_im, axes: tuple[int, ...], coil_axis: int):
    """Planar (split real/imag) Cartesian recon: the centered inverse
    transform of ``k_re + i k_im``, then the root-sum-of-squares over coils
    from the planes."""
    k_re, k_im = torch.as_tensor(k_re), torch.as_tensor(k_im)
    img = centered_ifftn(torch.complex(k_re, k_im), _axes(k_re.ndim, axes))
    re, im = img.real, img.imag
    return torch.sqrt(torch.sum(re * re + im * im, dim=coil_axis))


@spanned("recon")
def kspace_to_image(
    da: XmrArray,
    dims: list[str] | None = None,
    out_dims: list[str] | None = None,
) -> XmrArray:
    """Centered inverse FFT of Cartesian k-space dims (default kx/ky/kz
    present in the array), renaming to image-space dims (x/y/z)."""
    if dims is None:
        dims = [d for d in (DIMS.kx, DIMS.ky, DIMS.kz) if d in da.dims]
        if not dims:
            raise ValueError(
                "No k-space dimensions (kx/ky/kz) found; pass `dims` explicitly."
            )
    if out_dims is None:
        k2im = {DIMS.kx: DIMS.x, DIMS.ky: DIMS.y, DIMS.kz: DIMS.z}
        out_dims = [k2im.get(d, d) for d in dims]
    _check_dims(da, dims, "kspace_to_image")
    return ifftc(da, dim=dims, out_dim=out_dims)


def rss_combine(da: XmrArray, dim: str = DIMS.coil) -> XmrArray:
    """Root-sum-of-squares magnitude combination over the coil dimension."""
    _check_dims(da, dim, "rss_combine")
    ax = da.get_axis_num(dim)
    x = da.data
    if get_namespace(x) is torch:
        out_data = torch.sqrt(torch.sum((x * x.conj()).real, dim=ax))
    else:
        out_data = np.sqrt(np.sum(np.real(x * np.conj(x)), axis=ax))
    new_dims = tuple(d for d in da.dims if d != dim)
    out = XmrArray(out_data, dims=new_dims, attrs=da.attrs, name=da.name)
    out.coords = {k: c.copy() for k, c in da.coords.items() if c.dim != dim}
    out.attrs["coil_combine"] = "rss"
    return out


def rss_reconstruct(
    da: XmrArray,
    dims: list[str] | None = None,
    coil_dim: str = DIMS.coil,
) -> XmrArray:
    """Full Cartesian recon: centered iFFT + RSS coil combine (labeled)."""
    img = kspace_to_image(da, dims=dims)
    return rss_combine(img, dim=coil_dim)
