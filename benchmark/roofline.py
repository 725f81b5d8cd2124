"""The yardstick of the kernel metrics: the H100's published peaks and the
work each kernel slot's call needs, counted from its arguments.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores (the kernels here use none).  Each input
byte is counted once and each output byte once; where the work depends on
the data (the LM's done voxels, the accept gate's rejected ones) what these
inputs need is counted.  The counts are ``chip_smoke.py``'s ``_bound`` and
its K1-K4 arithmetic: at the bench shapes K1 is bound by its bytes at
0.120 ms, K2 by its operations at 0.099 ms, K3 and K4 by their bytes at
0.0049 and 0.0045 ms.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def spectrum_work(args, kwargs, out=None):
    """K1 (``KernelSet.spectrum(xr, xi, n_out, window, with_maxmag,
    stacked_out)``): the planes and the window in, the spectra (and each
    voxel's peak value and bin) out; an FFT's 5 n log2 n operations."""
    xr = args[0]
    n_out = int(args[2] if len(args) > 2 else kwargs["n_out"])
    with_peak = bool(args[4] if len(args) > 4 else kwargs.get("with_maxmag", False))
    b, n_in = xr.shape
    nbytes = b * (8 * n_in + 8 * n_out + (8 if with_peak else 0)) + 4 * n_in
    return nbytes, b * 5 * n_out * math.log2(n_out)


def _k2_sizes(params, y_re, dxdu, plan):
    b, n_in = y_re.shape
    kp = params.shape[1] // 5
    n_free = dxdu.shape[1]
    q_n = plan.q_n
    full_ops = n_in * (10 * kp + 6 + kp * (kp + 1) / 2 * (6 + 4 * (2 * q_n + 1))
                       + kp * (6 + 4 * (q_n + 1)))
    full_bytes = 4 * (kp * 5 + 2 * n_in + n_free + 1 + n_free + n_free ** 2)
    cost_ops = n_in * (10 * kp + 6)
    cost_bytes = 4 * (kp * 5 + 2 * n_in + 2)
    return b, n_in, full_ops, full_bytes, cost_ops, cost_bytes


def normal_equations_work(args, kwargs, out=None):
    """K2 (``KernelSet.normal_equations(params, y_re, y_im, t, dxdu, plan,
    voxel_mask, cost_prev)``): per voxel the model, residual and cost, and
    for a voxel that the accept gate keeps the moment sums of g and H.  A
    voxel outside ``voxel_mask`` costs nothing; one whose cost is not below
    its ``cost_prev`` only its cost.  Returns tensors where the counts
    depend on the data (read after the run)."""
    names = ("params", "y_re", "y_im", "t", "dxdu", "plan", "voxel_mask", "cost_prev")
    a = dict(zip(names, args))
    a.update(kwargs)
    b, n_in, full_ops, full_bytes, cost_ops, cost_bytes = _k2_sizes(
        a["params"], a["y_re"], a["dxdu"], a["plan"])
    mask, prev = a.get("voxel_mask"), a.get("cost_prev")
    if mask is None and prev is None:
        return b * full_bytes + 4 * n_in, b * full_ops
    import torch

    active = (torch.ones((b,), dtype=torch.bool, device=a["y_re"].device)
              if mask is None else mask.bool())
    kept = active if prev is None else active & (out[0] < prev)
    n_full = kept.sum().double()
    n_cost = active.sum().double() - n_full
    return (n_full * full_bytes + n_cost * cost_bytes + 4 * n_in,
            n_full * full_ops + n_cost * cost_ops)


def _tri(f):
    """Entries of an F x F matrix's upper triangle, all an SPD kernel reads
    of a voxel's H."""
    return f * (f + 1) // 2


def spd_solve_work(args, kwargs, out=None):
    """K3 (``KernelSet.spd_solve_damped(h, g, lam)``, H the (F*F, B) slab):
    per voxel H's upper triangle, g and lam in, the step out; a Cholesky
    factor's F^3/3 operations and the two triangular solves' 2 F^2."""
    g = args[1] if len(args) > 1 else kwargs["g"]
    b, f = g.shape
    return b * 4 * (_tri(f) + 2 * f + 1), b * (f ** 3 / 3 + 2 * f ** 2)


def spd_inverse_work(args, kwargs, out=None):
    """K4 (``KernelSet.spd_inverse_diag(h, tikhonov)``, H the (F*F, B)
    slab): per voxel H's upper triangle in, diag(H^-1) out; the factor's
    F^3/3 operations and L^-1's F^3/3."""
    h = args[0] if args else kwargs["h"]
    f, b = math.isqrt(h.shape[0]), h.shape[1]
    return b * 4 * (_tri(f) + f), b * 2 * f ** 3 / 3
