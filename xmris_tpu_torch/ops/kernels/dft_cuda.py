"""K1: fused window -> zero-fill -> ortho DFT -> fftshift (+ peak search).

Replaces ``xmris_tpu/ops/kernels/dft_pallas.py::spectrum_pallas`` (with
``with_maxmag`` and ``stacked_out``).  The CUDA source is
``csrc/spectrum.cu``; its header comment gives the bound on the H100 and
the design.  It holds two kernels for one function: a shared-memory
Stockham FFT for power-of-two ``n_out`` (256..8192) and the reference's
Cooley-Tukey split for the other lengths :func:`pallas_split_ok` accepts;
both count as ``spectrum``.  :func:`route` names the route a shape takes,
from the shapes alone: ``"fft"``, ``"split"``, or ``"dense"`` for every
other zero-fill.  The dense route (:func:`spectrum_dense`, its own counter
``spectrum_dense``) is plain PyTorch, as the reference computes those
shapes outside any Pallas kernel (its XLA DFT, ``ops/kernels/dft.py``): one
matmul against the rectangular fftshifted ortho DFT matrix, summed in
float64 (a float32 sum over 2 n_in terms leaves errors of ~2e-6 max|S| on
white noise at 1000 -> 1500, above the 1e-6 parity bar that the FFT
routes, whose errors grow as log n, keep).
:func:`spectrum_plain` is the same function in plain PyTorch
(``torch.fft``), used for CPU tensors and as the reference on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels import _build, _counters
from xmris_tpu_torch.ops.kernels.dft import _rect_shifted_block_matrix


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


FFT_MIN, FFT_MAX = 256, 8192


def route(n_in: int, n_out: int) -> str:
    """The route a CUDA call takes for (n_in, n_out), n_out >= n_in:
    ``"fft"`` when n_out is a power of two in [256, 8192] (split or not),
    else ``"split"`` when :func:`pallas_split_ok`, else ``"dense"``.
    Raises ``ValueError`` when ``n_out < n_in``."""
    if n_out < n_in:
        raise ValueError(
            f"(n_in={n_in}, n_out={n_out}): n_out < n_in; the spectrum only "
            "zero-fills, and no route (FFT, Cooley-Tukey split or dense) "
            "truncates")
    pow2 = n_out > 0 and n_out & (n_out - 1) == 0
    if pow2 and FFT_MIN <= n_out <= FFT_MAX:
        return "fft"
    return "split" if pallas_split_ok(n_in, n_out) else "dense"


def fft_plan(n_out: int) -> tuple[int, ...]:
    """The FFT kernel's pass radices, in order: radix 8 while it divides,
    then one radix-2 or radix-4 pass for the remaining factor."""
    m = n_out.bit_length() - 1
    return (8,) * (m // 3) + ((), (2,), (4,))[m % 3]


@functools.lru_cache(maxsize=16)
def fft_twiddles(n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """``e^(-2 pi i k / n_out)`` for k < n_out as float32 (cos, sin) planes,
    computed in float64; entries within 1e-12 of 0 are exact zeros, so the
    quarter turns multiply exactly."""
    ang = -2.0 * np.pi * np.arange(n_out) / n_out
    tables = []
    for a in (np.cos(ang), np.sin(ang)):
        a[np.abs(a) < 1e-12] = 0.0
        tables.append(np.ascontiguousarray(a, dtype=np.float32))
    return tables[0], tables[1]


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


def _tables_on(device, kind: str, *shape: int):
    key = (str(device), kind) + shape
    if key not in _device_tables:
        if kind == "split":
            tables = _factor_tables(*shape)
        elif kind == "dense":
            tables = (_rect_shifted_block_matrix(*shape, "float64"),)
        else:  # one (n_out, 2) table of interleaved (cos, sin) pairs
            tables = (np.stack(fft_twiddles(*shape), axis=1),)
        _device_tables[key] = tuple(torch.as_tensor(a, device=device)
                                    for a in tables)
    return _device_tables[key]


def _check_inputs(xr, xi, n_out, window, stacked_out=False):
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
    route(n_in, n_out)  # raises for n_out < n_in
    if stacked_out and not pallas_split_ok(n_in, n_out):
        raise ValueError(
            f"the stacked layout needs a Cooley-Tukey split of (n_in={n_in}, "
            f"n_out={n_out}): an even n2 >= 8 dividing both; use the flat "
            "layout"
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
    _counters.plain_called("spectrum")
    n_in = _check_inputs(xr, xi, n_out, window, stacked_out)
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


def spectrum_dense(xr, xi, n_out: int, window=None, with_maxmag=False,
                   stacked_out=False):
    """The dense route: window, zero-fill, ortho DFT and fftshift as one
    matmul against the block-complex (2 n_in, 2 n_out) float64 matrix of
    the zero-filled ortho DFT with fftshifted columns
    (:func:`~xmris_tpu_torch.ops.kernels.dft._rect_shifted_block_matrix`,
    kept on the device by :func:`_tables_on`), summed in float64 and rounded to
    float32 (see the module docstring), then each
    voxel's max |X|^2 and its first index.  Plain PyTorch on any device;
    :func:`spectrum` takes it on the card for the shapes :func:`route`
    names ``"dense"``.  Same contract as :func:`spectrum_plain`."""
    n_in = _check_inputs(xr, xi, n_out, window, stacked_out)
    if window is not None:
        xr = xr * window
        xi = xi * window
    (matrix,) = _tables_on(xr.device, "dense", n_in, n_out)
    out = torch.matmul(torch.cat([xr, xi], dim=1).double(), matrix).float()
    _counters.launched("spectrum_dense")
    out_re = out[:, :n_out].contiguous()
    out_im = out[:, n_out:].contiguous()
    shaped = _shape_outputs(out_re, out_im, n_in, n_out, stacked_out)
    if not with_maxmag:
        return shaped
    mv, mi = torch.max(out_re * out_re + out_im * out_im, dim=1)
    return shaped + (mv, mi.to(torch.int32))


def spectrum(xr, xi, n_out: int, window=None, with_maxmag=False,
             stacked_out=False):
    """K1: the plain version for CPU tensors; on CUDA tensors the kernel of
    the shape's :func:`route`, or the dense route (not a K1 launch).

    Same contract as :func:`spectrum_plain`.
    """
    if xr.device.type == "cpu":
        return spectrum_plain(xr, xi, n_out, window, with_maxmag, stacked_out)
    if xr.device.type != "cuda":
        raise ValueError(f"spectrum: unsupported device {xr.device}")
    n_in = _check_inputs(xr, xi, n_out, window, stacked_out)
    kind = route(n_in, n_out)
    if kind == "dense":
        return spectrum_dense(xr, xi, n_out, window, with_maxmag, stacked_out)
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("spectrum: planes must be contiguous")
    b = xr.shape[0]
    if window is None:
        window = torch.ones(n_in, dtype=torch.float32, device=xr.device)
    window = window.contiguous()
    out_re = torch.empty((b, n_out), dtype=torch.float32, device=xr.device)
    out_im = torch.empty_like(out_re)
    mv = torch.empty((b,), dtype=torch.float32, device=xr.device)
    mi = torch.empty((b,), dtype=torch.int32, device=xr.device)
    lib = _build.library()
    outs = (out_re.data_ptr(), out_im.data_ptr(), mv.data_ptr(), mi.data_ptr())
    stream = _build.stream_ptr(xr.device)
    if kind == "fft":
        # 16-byte loads need 16-byte aligned rows of the planes and window.
        vec = n_in % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (xr, xi, window))
        err = lib.xmt_spectrum_fft(
            xr.data_ptr(), xi.data_ptr(), window.data_ptr(),
            *(a.data_ptr() for a in _tables_on(xr.device, "fft", n_out)),
            *outs, b, n_in, n_out.bit_length() - 1,
            float(np.float32(1.0 / math.sqrt(n_out))), int(bool(with_maxmag)),
            int(vec), stream,
        )
        _build.check("xmt_spectrum_fft", err)
    else:
        n2 = _pick_n2(n_in, n_out)
        err = lib.xmt_spectrum(
            xr.data_ptr(), xi.data_ptr(), window.data_ptr(),
            *(a.data_ptr() for a in _tables_on(xr.device, "split", n_in,
                                               n_out, n2)),
            *outs, b, n_in, n_out, n2, int(bool(with_maxmag)), stream,
        )
        _build.check("xmt_spectrum", err)
    _counters.launched("spectrum")
    shaped = _shape_outputs(out_re, out_im, n_in, n_out, stacked_out)
    return shaped + (mv, mi) if with_maxmag else shaped
