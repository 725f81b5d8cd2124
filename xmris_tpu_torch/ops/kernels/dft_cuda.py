"""K1: fused window -> zero-fill -> ortho DFT -> fftshift (+ peak search).

Replaces ``xmris_tpu/ops/kernels/dft_pallas.py::spectrum_pallas`` (with
``with_maxmag`` and ``stacked_out``).  The CUDA source is
``csrc/spectrum.cu``; its header comment gives the bound on the H100 and
the design.  :func:`spectrum_plain` is the same function in plain PyTorch
(``torch.fft``), used for CPU tensors and as the reference on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels import _build, _counters


def _pick_n2(n_in: int, n_out: int) -> int:
    """The reference's Cooley-Tukey split: n2 = 32, halved until it divides
    both lengths (not below 8)."""
    n2 = 32
    while n2 > 8 and (n_in % n2 or n_out % n2):
        n2 //= 2
    return n2


def pallas_split_ok(n_in: int, n_out: int) -> bool:
    """True when the split handles (n_in, n_out): an even n2 >= 8 dividing
    both, with n_out >= n_in (zero-fill only)."""
    if n_out < n_in:
        return False
    n2 = _pick_n2(n_in, n_out)
    return n_in % n2 == 0 and n_out % n2 == 0


def stacked_spec_shape(n_in: int, n_out: int) -> tuple[int, int]:
    """The (n2, n1) per-voxel block of the stacked layout (flat k = k1 +
    n1*k2, so the block is the flat spectrum in memory)."""
    n2 = _pick_n2(n_in, n_out)
    return n2, n_out // n2


@functools.lru_cache(maxsize=16)
def _factor_tables(n_in: int, n_out: int, n2: int) -> tuple[np.ndarray, ...]:
    """Planar factor tables, computed in float64 and stored as float32.

    The math of the reference's ``_spectrum_factors`` (ortho scale folded
    into F1, fftshift folded into F2's rows), laid out for the kernel:
    F1^T (n1_in, n1), TW^T (n2, n1) and F2 (n2, n2) as [k2, j2].
    """
    n1 = n_out // n2
    n1_in = n_in // n2
    k1 = np.arange(n1)[None, :]
    j1 = np.arange(n1_in)[:, None]
    ang1 = -2.0 * np.pi * j1 * k1 / n1
    scale = 1.0 / math.sqrt(n_out)
    j2 = np.arange(n2)[:, None]
    ang_t = -2.0 * np.pi * j2 * k1 / n_out
    k2 = (np.arange(n2)[:, None] + n2 // 2) % n2
    ang2 = -2.0 * np.pi * k2 * np.arange(n2)[None, :] / n2
    tables = (
        np.cos(ang1) * scale, np.sin(ang1) * scale,
        np.cos(ang_t), np.sin(ang_t),
        np.cos(ang2), np.sin(ang2),
    )
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in tables)


_device_tables: dict = {}


def _tables_on(device, n_in: int, n_out: int, n2: int):
    key = (str(device), n_in, n_out, n2)
    if key not in _device_tables:
        _device_tables[key] = tuple(
            torch.as_tensor(a, device=device)
            for a in _factor_tables(n_in, n_out, n2)
        )
    return _device_tables[key]


def _check_inputs(xr, xi, n_out, window):
    if xr.dim() != 2 or xi.shape != xr.shape:
        raise ValueError(
            f"xr/xi must be matching (B, n_in) planes, got {tuple(xr.shape)} "
            f"and {tuple(xi.shape)}"
        )
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError("spectrum takes float32 planes")
    if xi.device != xr.device:
        raise ValueError("xr and xi must be on the same device")
    n_in = xr.shape[1]
    if not pallas_split_ok(n_in, n_out):
        raise ValueError(
            f"(n_in={n_in}, n_out={n_out}) has no Cooley-Tukey split: "
            "need n_out >= n_in and an even n2 >= 8 dividing both"
        )
    if window is not None:
        if window.shape != (n_in,) or window.dtype != torch.float32:
            raise ValueError(f"window must be float32 of shape ({n_in},)")
        if window.device != xr.device:
            raise ValueError("window must be on the planes' device")
    return n_in


def _shape_outputs(out_re, out_im, n_in, n_out, stacked_out):
    if stacked_out:
        n2, n1 = stacked_spec_shape(n_in, n_out)
        return (out_re.view(-1, n2, n1), out_im.view(-1, n2, n1))
    return out_re, out_im


def spectrum_plain(xr, xi, n_out: int, window=None, with_maxmag=False,
                   stacked_out=False):
    """Plain-PyTorch K1: ``fftshift(fft(pad(x * window), n_out, "ortho"))``.

    Returns ``(re, im)`` — shaped (B, n_out), or (B, n2, n1) with
    ``stacked_out`` — plus, with ``with_maxmag``, each voxel's max |X|^2
    (B,) float32 and its first flat index (B,) int32.
    """
    _counters.PLAIN_CALLS["spectrum"] += 1
    n_in = _check_inputs(xr, xi, n_out, window)
    if window is not None:
        xr = xr * window
        xi = xi * window
    spec = torch.fft.fft(torch.complex(xr, xi), n=n_out, dim=-1, norm="ortho")
    spec = torch.roll(spec, n_out // 2, dims=-1)
    out_re = spec.real.contiguous()
    out_im = spec.imag.contiguous()
    shaped = _shape_outputs(out_re, out_im, n_in, n_out, stacked_out)
    if not with_maxmag:
        return shaped
    mv, mi = torch.max(out_re * out_re + out_im * out_im, dim=1)
    return shaped + (mv, mi.to(torch.int32))


def spectrum(xr, xi, n_out: int, window=None, with_maxmag=False,
             stacked_out=False):
    """K1: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Same contract as :func:`spectrum_plain`.
    """
    if xr.device.type == "cpu":
        return spectrum_plain(xr, xi, n_out, window, with_maxmag, stacked_out)
    if xr.device.type != "cuda":
        raise ValueError(f"spectrum: unsupported device {xr.device}")
    n_in = _check_inputs(xr, xi, n_out, window)
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("spectrum: planes must be contiguous")
    b = xr.shape[0]
    n2 = _pick_n2(n_in, n_out)
    if window is None:
        window = torch.ones(n_in, dtype=torch.float32, device=xr.device)
    window = window.contiguous()
    tables = _tables_on(xr.device, n_in, n_out, n2)
    out_re = torch.empty((b, n_out), dtype=torch.float32, device=xr.device)
    out_im = torch.empty_like(out_re)
    mv = torch.empty((b,), dtype=torch.float32, device=xr.device)
    mi = torch.empty((b,), dtype=torch.int32, device=xr.device)
    lib = _build.library()
    err = lib.xmt_spectrum(
        xr.data_ptr(), xi.data_ptr(), window.data_ptr(),
        *(a.data_ptr() for a in tables),
        out_re.data_ptr(), out_im.data_ptr(), mv.data_ptr(), mi.data_ptr(),
        b, n_in, n_out, n2, int(bool(with_maxmag)),
        _build.stream_ptr(xr.device),
    )
    _build.check("xmt_spectrum", err)
    _counters.LAUNCHES["spectrum"] += 1
    shaped = _shape_outputs(out_re, out_im, n_in, n_out, stacked_out)
    return shaped + (mv, mi) if with_maxmag else shaped
