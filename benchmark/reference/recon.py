"""Plain reference of the multi-coil recon: the centered inverse FFT over
the spatial axes and the matched-filter (unaccelerated SENSE) combine with
known maps, ``sum_c conj(S_c) I_c / sum_c |S_c|^2``.

Plain PyTorch: complex128 FFTs for the comparison; for the control, the
transforms as bfloat16 matmuls (``torch.fft`` has no bfloat16).  It runs
in blocks of time points, so that a 1 GiB k-space fits beside its result.
"""

from __future__ import annotations

import math

import torch


def _centered_idft(n: int, dtype, device):
    """The centered ortho inverse DFT along one axis as real and imaginary
    (n, n) planes acting on the last axis: ``fftshift(ifft(ifftshift(x)))``."""
    j = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    ang = 2.0 * math.pi * torch.outer(j, j) / n
    s = 1.0 / math.sqrt(n)
    return (torch.cos(ang) * s).to(dtype), (torch.sin(ang) * s).to(dtype)


def _combine(i_re, i_im, maps):
    """The matched-filter combine over the coil axis (0)."""
    s_re, s_im = maps.real.to(i_re.dtype), maps.imag.to(i_re.dtype)
    den = (s_re * s_re + s_im * s_im).sum(0)
    num_re = (s_re * i_re + s_im * i_im).sum(0)
    num_im = (s_re * i_im - s_im * i_re).sum(0)
    return num_re / den, num_im / den


def recon(kspace, maps, dtype=torch.float64, block: int = 128):
    """Combined FIDs ``(re, im)`` (X, Y, Z, time) in ``dtype`` from centered
    k-space (coil, kx, ky, kz, time) and the (coil, X, Y, Z) maps."""
    maps_t = torch.as_tensor(maps, device=kspace.device)[..., None]
    sp = (1, 2, 3)
    outs = []
    for t0 in range(0, kspace.shape[-1], block):
        k = kspace[..., t0:t0 + block]
        if dtype == torch.float64:
            img = torch.fft.fftshift(torch.fft.ifftn(
                torch.fft.ifftshift(k.to(torch.complex128), dim=sp), dim=sp,
                norm="ortho"), dim=sp)
            i_re, i_im = img.real, img.imag
        else:
            i_re, i_im = k.real.to(dtype), k.imag.to(dtype)
            for ax in sp:
                c, s = _centered_idft(k.shape[ax], dtype, k.device)
                xr, xi = i_re.movedim(ax, -1), i_im.movedim(ax, -1)
                i_re = (xr @ c - xi @ s).movedim(-1, ax)
                i_im = (xr @ s + xi @ c).movedim(-1, ax)
        outs.append(_combine(i_re, i_im, maps_t))
    return (torch.cat([o[0] for o in outs], -1),
            torch.cat([o[1] for o in outs], -1))
