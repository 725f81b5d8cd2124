"""Bounded-parameter transform and free-to-physical parameter expansion.

Tensor math shared by the LM drivers (:mod:`xmris_tpu_torch.fitting.lm`)
and the plain versions of the kernels that run a whole fit
(:mod:`xmris_tpu_torch.ops.kernels.lm_loop_cuda`); it imports neither.

Bounds use the MINPACK/lmfit transform: ``x = lo + (sin u + 1)/2 (hi - lo)``
for two-sided bounds, a shifted hyperbola for one-sided ones, ``x = u`` for
free parameters.  ``kind`` holds one of :data:`BOTH`, :data:`LOWER`,
:data:`UPPER` and :data:`FREE` per parameter.
"""

from __future__ import annotations

import functools

import torch

BOTH, LOWER, UPPER, FREE = 0, 1, 2, 3


def _finite_or_zero(b):
    return torch.where(torch.isfinite(b), b, torch.zeros_like(b))


def external_to_internal_torch(x, lower, upper, kind):
    """Bounded external values to unbounded internal coordinates."""
    lo = _finite_or_zero(lower)
    hi = _finite_or_zero(upper)
    span_ok = hi > lo
    frac = torch.clamp(
        torch.where(
            span_ok,
            (x - lo) / torch.where(span_ok, hi - lo, torch.ones_like(hi)),
            torch.full_like(x, 0.5),
        ),
        1e-8,
        1.0 - 1e-8,
    )
    u_both = torch.arcsin(2.0 * frac - 1.0)
    v = torch.clamp(x - lo + 1.0, min=1.0 + 1e-12)
    u_lower = torch.sqrt(v * v - 1.0)
    w = torch.clamp(hi - x + 1.0, min=1.0 + 1e-12)
    u_upper = torch.sqrt(w * w - 1.0)
    out = torch.where(kind == UPPER, u_upper, x)
    out = torch.where(kind == LOWER, u_lower, out)
    return torch.where(kind == BOTH, u_both, out)


def internal_to_external_torch(u, lower, upper, kind):
    """Bounded transform of internal ``u`` and its diagonal Jacobian dx/du."""
    lo = _finite_or_zero(lower)
    hi = _finite_or_zero(upper)

    s = torch.sin(u)
    x_both = lo + (s + 1.0) * 0.5 * (hi - lo)
    d_both = 0.5 * (hi - lo) * torch.cos(u)

    root = torch.sqrt(u * u + 1.0)
    x_lower = lo - 1.0 + root
    d_lower = u / root
    x_upper = hi + 1.0 - root
    d_upper = -u / root

    is_both, is_lo, is_hi = kind == BOTH, kind == LOWER, kind == UPPER
    x = torch.where(is_both, x_both, torch.where(
        is_lo, x_lower, torch.where(is_hi, x_upper, u)))
    dxdu = torch.where(is_both, d_both, torch.where(
        is_lo, d_lower, torch.where(is_hi, d_upper, torch.ones_like(u))))
    return x, dxdu


@functools.lru_cache(maxsize=64)
def _pmap_tensors(pmap_static, device, dtype):
    """The parameter map's ``idx``, ``scale`` and ``offset`` on ``device``,
    made once: the LM expands every trip, and each copy from the host was
    three of its launches."""
    return (torch.as_tensor(pmap_static[0], device=device),
            torch.as_tensor(pmap_static[1], dtype=dtype, device=device),
            torch.as_tensor(pmap_static[2], dtype=dtype, device=device))


def expand_params_batched(x, pmap_static):
    """(..., F) free vectors -> (..., K*5) physical grids, by the hashable
    parameter map ``(idx, scale, offset, n_peaks)``: ``full[j] = offset[j]
    + scale[j] * x[idx[j]]``, ``idx[j] = -1`` for a fixed parameter."""
    idx, scale, offset = _pmap_tensors(pmap_static, x.device, x.dtype)
    gathered = x[..., torch.clamp(idx, min=0)]
    return offset + torch.where(
        idx >= 0, scale * gathered, torch.zeros_like(gathered)
    )
