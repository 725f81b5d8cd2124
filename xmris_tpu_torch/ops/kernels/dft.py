"""Batched DFT as matmuls in planar (split real/imag) arithmetic (PyTorch
port of :mod:`xmris_tpu.ops.kernels.dft`).

The reference computes every formulation here as XLA matmuls outside any
Pallas kernel, so the port computes them with ``torch.matmul`` /
``torch.einsum`` and holds no CUDA kernel: the hand-written spectrum kernel
is K1 (:mod:`~xmris_tpu_torch.ops.kernels.dft_cuda`), which
``PipelineConfig(dft_variant=None | "pallas")`` selects.

Math (decimation for n = n1*n2, row-major reshape x[j1*n2 + j2]):

    X[k1 + n1*k2] = sum_{j2} W_n^{j2*k1} W_{n2}^{j2*k2}
                    [ sum_{j1} x[j1, j2] W_{n1}^{j1*k1} ]

so:  Y = F(n1) @ x_r          (stage-1 matmul over columns)
     Y'[k1, j2] = Y * W_n^{j2*k1}   (twiddle)
     Z = Y' @ F(n2)           (stage-2 matmul)
     X = transpose(Z).ravel() (output permutation)

Complex products expand to real matmuls.  The operands keep their device
and dtype (float32 or float64); the factor tables are built on the host in
float64 (:func:`plan_dft`, cached), rounded to the operands' dtype as the
reference casts them, and kept on the device per (device, dtype).

**Arithmetic.**  Every contraction runs on float64 copies of its operands
and rounds its sums to the operands' dtype once.  A float64 GEMM has no
TF32 mode, so the result is the same whatever
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` say, and no process-wide flag is
read or set; the products of float32 values are exact in float64, so this
is at least as accurate as an IEEE float32 GEMM (the reference's
``HIGHEST``).  ``precision`` emulates the reference's TPU matmul passes
per call: ``"default"`` rounds both operands to bfloat16 first (one MXU
pass: each operand keeps 8 significand bits, errors of ~4e-3 of max|S| at
n = 2048 on white noise); ``"high"`` splits each operand into bfloat16
hi + lo parts and sums the passes hi*hi, hi*lo and lo*hi (16 significand
bits and the lo*lo term dropped: ~5e-6 of max|S|, under 2^-16); ``"highest"``
and None are the plain contraction (~1e-7).  The emulation gives the same
numbers on the CPU and on the card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch


class DFTPlan(NamedTuple):
    """Static factorization plan + host-precomputed factor matrices."""

    n: int
    n1: int
    n2: int
    # DFT matrices and twiddles, as host float64 (cast on use)
    f1_re: np.ndarray  # (n1, n1)
    f1_im: np.ndarray
    f2_re: np.ndarray  # (n2, n2)
    f2_im: np.ndarray
    tw_re: np.ndarray  # (n1, n2)
    tw_im: np.ndarray


def _factorize(n: int) -> tuple[int, int]:
    """Split n into (n1, n2) with n1*n2 == n, both as close to sqrt(n) as
    possible (balanced factors minimize total matmul FLOPs n*(n1+n2))."""
    best = (1, n)
    best_cost = float("inf")
    for n1 in range(1, int(math.isqrt(n)) + 1):
        if n % n1 == 0:
            n2 = n // n1
            cost = n1 + n2
            if cost < best_cost:
                best_cost = cost
                best = (n1, n2)
    return max(best), min(best)


@functools.lru_cache(maxsize=64)
def plan_dft(n: int) -> DFTPlan:
    """Build (and cache) the factor matrices for an n-point DFT."""
    n1, n2 = _factorize(n)

    def dft_matrix(m):
        k = np.arange(m)
        ang = -2.0 * np.pi * np.outer(k, k) / m
        return np.cos(ang), np.sin(ang)

    f1_re, f1_im = dft_matrix(n1)
    f2_re, f2_im = dft_matrix(n2)

    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * (k1 * j2) / n
    tw_re, tw_im = np.cos(ang), np.sin(ang)
    return DFTPlan(n, n1, n2, f1_re, f1_im, f2_re, f2_im, tw_re, tw_im)


# The variant the labeled ops use by default (the reference's); the fused
# pipelines' default (dft_variant=None) is kernel K1 instead.
DEFAULT_VARIANT = "einsum"
# The matmul precision: "highest" is the exact float32 contraction that
# parity demands; "high" and "default" emulate the TPU's 3- and 1-pass
# bfloat16 MXU arithmetic (see the module docstring).
DEFAULT_PRECISION = "highest"
_PRECISIONS = ("default", "high", "highest")

_device_consts: dict = {}


def _const(table: np.ndarray, device, dtype, key) -> torch.Tensor:
    """``table`` (host float64) rounded to ``dtype`` on ``device``, cached
    per (device, dtype, key)."""
    k = (str(device), dtype) + key
    if k not in _device_consts:
        _device_consts[k] = torch.as_tensor(
            np.ascontiguousarray(table)).to(device=device, dtype=dtype)
    return _device_consts[k]


def _check_precision(precision):
    if precision is not None and precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be None, 'default', 'high' or 'highest', got "
            f"{precision!r}."
        )


def _bf16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def _contract(fn, a, b, preferred, precision=None):
    """``fn(a, b)`` (a matmul or an einsum) on float64 copies of the
    operands at the emulated ``precision``, rounded once to ``preferred``."""
    if precision == "default":
        a, b = _bf16(a), _bf16(b)
    if precision == "high":
        a_hi, b_hi = _bf16(a), _bf16(b)
        a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
        a_hi, b_hi, a_lo, b_lo = (x.double() for x in (a_hi, b_hi, a_lo, b_lo))
        out = fn(a_hi, b_hi) + fn(a_hi, b_lo) + fn(a_lo, b_hi)
    else:
        out = fn(a.double(), b.double())
    return out.to(preferred)


def _cmatmul(ar, ai, br, bi, preferred, precision=None):
    """Planar complex matmul: (ar + i*ai) @ (br + i*bi) as 4 real matmuls."""
    mm = functools.partial(_contract, torch.matmul, preferred=preferred,
                           precision=precision)
    rr = mm(ar, br)
    ii = mm(ai, bi)
    ri = mm(ar, bi)
    ir = mm(ai, br)
    return rr - ii, ri + ir


def dft_planar(
    xr: torch.Tensor,
    xi: torch.Tensor,
    n: int,
    inverse: bool = False,
    ortho: bool = True,
    variant: str | None = None,
    precision=None,
):
    """Planar DFT of the last axis of a (..., n) pair of real tensors.

    The inverse uses the conjugation identity on the same forward factors.

    ``variant`` selects the matmul formulation (all numerically equivalent):

    * ``"einsum"`` — batched middle-axis contractions (torch picks layouts).
    * ``"flat"``   — explicit transposes + flat 2-D matmuls on (B*n2, n1)
      and (B*n1, n2) panels.
    * ``"block"``  — like ``flat`` but the real/imag planes pack into one
      block-complex operand, doubling the contraction dim and halving the
      matmul count.
    * ``"full"``   — single (B, 2n) @ (2n, 2n) block-complex matmul with
      the dense DFT matrix (n^2 FLOPs, zero transposes).

    ``precision``: None, ``"default"``, ``"high"`` or ``"highest"`` (see
    the module docstring).  An unknown variant or precision raises
    ``ValueError``.
    """
    variant = variant or DEFAULT_VARIANT
    _check_precision(precision)
    precision = precision if precision is not None else DEFAULT_PRECISION
    if xr.shape[-1] != n or xi.shape != xr.shape:
        raise ValueError(
            f"dft_planar: xr/xi must be matching (..., {n}) tensors, got "
            f"{tuple(xr.shape)} and {tuple(xi.shape)}."
        )
    plan = plan_dft(n)
    dtype = xr.dtype
    preferred = dtype

    if inverse:
        # IDFT(x) = conj(DFT(conj(x))) / n  (scaling applied below)
        xi = -xi

    batch_shape = tuple(xr.shape[:-1])

    if variant == "einsum":
        outr, outi = _dft_einsum(xr, xi, plan, dtype, preferred, precision)
    elif variant == "flat":
        outr, outi = _dft_flat(xr, xi, plan, dtype, preferred, precision)
    elif variant == "block":
        outr, outi = _dft_block(xr, xi, plan, dtype, preferred, precision)
    elif variant == "full":
        outr, outi = _dft_full(xr, xi, n, dtype, preferred, precision)
    else:
        raise ValueError(f"Unknown DFT variant {variant!r}.")
    outr = outr.reshape(batch_shape + (n,))
    outi = outi.reshape(batch_shape + (n,))

    if inverse:
        outi = -outi
        scale = (1.0 / math.sqrt(n)) if ortho else (1.0 / n)
    else:
        scale = (1.0 / math.sqrt(n)) if ortho else 1.0
    if scale != 1.0:
        outr = outr * scale
        outi = outi * scale
    return outr, outi


def _plan_consts(plan: DFTPlan, device, dtype, *names):
    return tuple(_const(getattr(plan, name), device, dtype,
                        ("plan", plan.n, name)) for name in names)


def _twiddles_t(plan: DFTPlan, device, dtype):
    """The twiddles transposed to (n2, n1) = (j2, k1)."""
    return (_const(plan.tw_re.T, device, dtype, ("twt", plan.n, "re")),
            _const(plan.tw_im.T, device, dtype, ("twt", plan.n, "im")))


def _dft_einsum(xr, xi, plan: DFTPlan, dtype, preferred, precision):
    """Round-1 formulation: batched einsum contractions over middle axes."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    f1_re, f1_im, f2_re, f2_im, tw_re, tw_im = _plan_consts(
        plan, xr.device, dtype, "f1_re", "f1_im", "f2_re", "f2_im", "tw_re",
        "tw_im")

    xr2 = xr.reshape(-1, n1, n2)
    xi2 = xi.reshape(-1, n1, n2)

    ein = functools.partial(_contract, functools.partial(torch.einsum,
                                                         "kj,bjm->bkm"),
                            preferred=preferred, precision=precision)
    # Stage 1: Y[b, k1, j2] = sum_j1 F1[k1, j1] x[b, j1, j2]
    yr = ein(f1_re, xr2) - ein(f1_im, xi2)
    yi = ein(f1_re, xi2) + ein(f1_im, xr2)

    # Twiddle: elementwise (n1, n2) complex multiply
    tr = yr * tw_re - yi * tw_im
    ti = yr * tw_im + yi * tw_re

    # Stage 2: Z[b, k1, k2] = sum_j2 Y'[b, k1, j2] F2[j2, k2]
    zr, zi = _cmatmul(tr, ti, f2_re, f2_im, preferred, precision)

    # Output permutation: X[k1 + n1*k2] -> transpose (k1, k2) -> (k2, k1)
    outr = zr.transpose(1, 2).reshape(-1, n)
    outi = zi.transpose(1, 2).reshape(-1, n)
    return outr, outi


def _dft_flat(xr, xi, plan: DFTPlan, dtype, preferred, precision):
    """Flat-panel formulation: every contraction is a plain 2-D matmul whose
    contraction axis is minormost, with explicit transposes between stages.

    Layout walk (F1/F2 are symmetric, so F^T = F):
      (B, n1, n2) --T--> (B, n2, n1) --flat--> (B*n2, n1) @ F1 -> y[b, j2, k1]
      twiddle (j2, k1) elementwise
      --T--> (B, k1, j2) --flat--> (B*n1, n2) @ F2 -> z[b, k1, k2]
      --T--> (B, k2, k1) --ravel--> X[k1 + n1*k2]
    """
    n, n1, n2 = plan.n, plan.n1, plan.n2
    f1_re, f1_im, f2_re, f2_im = _plan_consts(
        plan, xr.device, dtype, "f1_re", "f1_im", "f2_re", "f2_im")
    twt_re, twt_im = _twiddles_t(plan, xr.device, dtype)

    xtr = xr.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n1)
    xti = xi.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n1)

    yr, yi = _cmatmul(xtr, xti, f1_re, f1_im, preferred, precision)

    yr = yr.reshape(-1, n2, n1)
    yi = yi.reshape(-1, n2, n1)
    tr = yr * twt_re - yi * twt_im
    ti = yr * twt_im + yi * twt_re

    tr = tr.transpose(1, 2).reshape(-1, n2)  # (B*k1, j2)
    ti = ti.transpose(1, 2).reshape(-1, n2)
    zr, zi = _cmatmul(tr, ti, f2_re, f2_im, preferred, precision)

    outr = zr.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n)
    outi = zi.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n)
    return outr, outi


@functools.lru_cache(maxsize=64)
def _block_factors(n: int):
    """Block-complex factor matrices for the flat 4-step.

    ``[yr yi] = [xr xi] @ [[Fr, Fi], [-Fi, Fr]]`` — one real matmul per
    stage with contraction dim 2*n1 (or 2*n2).
    """
    plan = plan_dft(n)

    def block(fr, fi):
        top = np.concatenate([fr, fi], axis=1)
        bot = np.concatenate([-fi, fr], axis=1)
        return np.concatenate([top, bot], axis=0)

    return (
        block(plan.f1_re, plan.f1_im),  # (2*n1, 2*n1)
        block(plan.f2_re, plan.f2_im),  # (2*n2, 2*n2)
    )


def _dft_block(xr, xi, plan: DFTPlan, dtype, preferred, precision):
    """Block-complex flat formulation: planes packed along the contraction
    axis so each stage is ONE matmul with doubled K."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    b1, b2 = (_const(f, xr.device, dtype, ("block", n, i))
              for i, f in enumerate(_block_factors(n)))
    twt_re, twt_im = _twiddles_t(plan, xr.device, dtype)

    mm = functools.partial(_contract, torch.matmul, preferred=preferred,
                           precision=precision)

    xtr = xr.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n1)
    xti = xi.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n1)

    y = mm(torch.cat([xtr, xti], dim=1), b1)  # (B*n2, 2*n1)
    yr = y[:, :n1].reshape(-1, n2, n1)
    yi = y[:, n1:].reshape(-1, n2, n1)

    tr = yr * twt_re - yi * twt_im
    ti = yr * twt_im + yi * twt_re

    tr = tr.transpose(1, 2).reshape(-1, n2)
    ti = ti.transpose(1, 2).reshape(-1, n2)
    z = mm(torch.cat([tr, ti], dim=1), b2)  # (B*n1, 2*n2)
    zr = z[:, :n2].reshape(-1, n1, n2)
    zi = z[:, n2:].reshape(-1, n1, n2)

    outr = zr.transpose(1, 2).reshape(-1, n)
    outi = zi.transpose(1, 2).reshape(-1, n)
    return outr, outi


@functools.lru_cache(maxsize=4)
def _full_block_matrix(n: int, dtype_str: str = "float32") -> np.ndarray:
    """Dense block-complex DFT matrix (2n, 2n): X = x_packed @ M.

    Built in float64 and stored at the consumer's dtype.
    """
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    fr, fi = np.cos(ang), np.sin(ang)
    top = np.concatenate([fr, fi], axis=1)
    bot = np.concatenate([-fi, fr], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.dtype(dtype_str))


def _numpy_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dft_full(xr, xi, n, dtype, preferred, precision):
    """Single dense-matrix formulation: n^2 FLOPs but zero transposes and
    one perfectly-shaped matmul."""
    name = _numpy_name(dtype)
    m = _const(_full_block_matrix(n, name), xr.device, dtype, ("full", n))
    x = torch.cat([xr.reshape(-1, n), xi.reshape(-1, n)], dim=1)
    out = _contract(torch.matmul, x, m, preferred, precision)
    return out[:, :n], out[:, n:]


# ---------------------------------------------------------------------------
# Fused spectral transform: zero-fill + ortho DFT + fftshift as ONE matmul
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _rect_shifted_block_matrix(
    n_in: int, n_out: int, dtype_str: str = "float32"
) -> np.ndarray:
    """Block-complex (2*n_in, 2*n_out) matrix computing, in one matmul,
    the ortho-normalized ``n_out``-point DFT of an ``n_in``-sample signal
    (implicit zero-fill: only the first ``n_in`` DFT-matrix rows survive)
    with the output columns pre-permuted by ``fftshift``.

    ``spec_shifted = x_packed @ M`` where ``x_packed = [x_re | x_im]``.
    """
    j = np.arange(n_in)[:, None]
    # fftshift output ordering: shifted bin k' holds original bin
    # (k' - n_out//2) mod n_out  (the roll-by-n//2 convention of ops.fourier)
    k = (np.arange(n_out)[None, :] - n_out // 2) % n_out
    ang = -2.0 * np.pi * j * k / n_out
    scale = 1.0 / math.sqrt(n_out)
    fr = np.cos(ang) * scale
    fi = np.sin(ang) * scale
    top = np.concatenate([fr, fi], axis=1)
    bot = np.concatenate([-fi, fr], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.dtype(dtype_str))


def dft_rect_shifted_planar(
    xr: torch.Tensor,
    xi: torch.Tensor,
    n_out: int,
    precision=None,
):
    """Fused zero-fill -> ortho DFT -> fftshift of a (..., n_in) planar pair.

    The whole spectral transform is one (B, 2*n_in) @ (2*n_in, 2*n_out)
    matmul against a constant: no pad, no roll, and half the FLOPs of a
    square dense DFT when n_in = n_out/2 (the standard 2x zero-fill).
    Callers multiply the apodization window into ``xr/xi`` first.
    """
    _check_precision(precision)
    precision = precision if precision is not None else DEFAULT_PRECISION
    n_in = xr.shape[-1]
    dtype = xr.dtype
    batch_shape = tuple(xr.shape[:-1])

    m = _const(_rect_shifted_block_matrix(n_in, n_out, _numpy_name(dtype)),
               xr.device, dtype, ("rect", n_in, n_out))
    x = torch.cat([xr.reshape(-1, n_in), xi.reshape(-1, n_in)], dim=1)
    out = _contract(torch.matmul, x, m, dtype, precision)
    return (
        out[:, :n_out].reshape(batch_shape + (n_out,)),
        out[:, n_out:].reshape(batch_shape + (n_out,)),
    )


def fft_ortho_planar(xr, xi):
    """Ortho-normalized forward planar FFT over the last axis."""
    return dft_planar(xr, xi, xr.shape[-1], inverse=False, ortho=True)


def ifft_ortho_planar(xr, xi):
    """Ortho-normalized inverse planar FFT over the last axis."""
    return dft_planar(xr, xi, xr.shape[-1], inverse=True, ortho=True)
