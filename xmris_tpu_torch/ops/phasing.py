"""Spectral phasing: manual phase application and automatic phase search
(PyTorch port).

Port of :mod:`xmris_tpu.ops.phasing`:

* :func:`phase` applies a zero/first-order correction in degrees,
  ``exp(+1j (p0 + p1 (coord - pivot) / range))``, with lineage attrs;
* the objectives: :func:`acme_score_raw` (entropy of the first derivative
  plus the negative-area penalty), :func:`peak_minima_score_raw` and
  :func:`roi_positivity_score_raw` (a window of ``index_width`` bins
  either side of each row's ``target_idx``, masked so the index may differ
  per row); :func:`_np_objective` is the NumPy objective of the scipy
  search;
* :func:`_grid_phase_search` scores a deterministic candidate mesh,
  chunked over candidates, and polishes each row's winner: ``"gd"`` is
  backtracking gradient descent with autograd gradients (as the reference
  takes them from ``jax.value_and_grad``), ``"fused"`` the whole ACME
  polish in one launch of kernel K5 (:mod:`.kernels.acme_cuda`),
  ``"newton"``/``"bfgs"`` the damped second-order polishes of
  :func:`_second_order_polish` (Hessians from ``torch.func``);
* :func:`_de_phase_search` is the differential-evolution search
  (:mod:`xmris_tpu_torch.ops.optim`), one independent search per row, in
  voxel chunks;
* :func:`autophase` runs either on the loudest row (``mode="single"``,
  where ``optimizer="scipy"`` runs ``scipy.optimize.differential_evolution``
  on the host) or on every voxel (``mode="all"``, :func:`_autophase_all`).
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.core.config import ATTRS, DIMS
from xmris_tpu_torch.core.utils import _check_dims, complex_planes
from xmris_tpu_torch.ops.fid import apodize_exp, to_fid, to_spectrum
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.ops.optim import differential_evolution_batched
from xmris_tpu_torch.runtime.config import matching_dtypes


def phase_factor_raw(coords, p0_deg, p1_deg, pivot, x_range):
    """Complex phase factor ``exp(1j * (p0 + p1*(x-pivot)/range))`` (radians
    from degrees), on numpy or on tensors."""
    xp = torch if any(
        isinstance(v, torch.Tensor) for v in (coords, p0_deg, p1_deg, pivot)
    ) else np
    if xp is torch:
        like = next(v for v in (coords, p0_deg, p1_deg, pivot)
                    if isinstance(v, torch.Tensor))
        p0_deg, p1_deg = (torch.as_tensor(v, dtype=like.dtype, device=like.device)
                          for v in (p0_deg, p1_deg))
    p0_rad = xp.deg2rad(p0_deg)
    p1_rad = xp.deg2rad(p1_deg)
    if isinstance(x_range, (int, float)) and x_range == 0:
        phi = p0_rad
    else:
        phi = p0_rad + p1_rad * ((coords - pivot) / x_range)
    return xp.exp(1.0j * phi)


def _phased_real_planar(re, im, coords, p0, p1, pivot, x_range):
    """Real part of the phased spectrum from split planes.

    ``re``/``im`` are (..., n) rows; ``p0``/``p1`` (degrees) broadcast
    against the leading dims.
    """
    phi = torch.deg2rad(p0)[..., None] + torch.deg2rad(p1)[..., None] * (
        (coords - pivot) / x_range
    )
    return re * torch.cos(phi) - im * torch.sin(phi)


def _abs(x):
    """|x| with ``jnp.abs``'s derivative at 0 (1, where torch.abs has 0)."""
    return torch.where(x >= 0, x, -x)


def acme_score_raw(real_data):
    """ACME objective over the last axis: entropy of |first derivative|
    plus the negative-area penalty, normalized by length and the maximum of
    the real part; ``+inf`` where that maximum is not positive.  Its
    autograd gradient is ``jax.grad``'s: the maximum is ``amax``, whose
    gradient splits evenly among tied maxima as ``jnp.max``'s does, and
    ``|x|`` has derivative 1 at 0 as ``jnp.abs``."""
    ds1 = _abs((real_data[..., 1:] - real_data[..., :-1]) / 2.0)
    p1_prob = ds1 / ds1.sum(-1, keepdim=True)
    p1_prob = torch.where(p1_prob == 0, torch.ones_like(p1_prob), p1_prob)
    h1s = (-p1_prob * torch.log(p1_prob)).sum(-1)

    as_ = real_data - _abs(real_data)
    sumas = as_.sum(-1)
    pfun = torch.where(
        sumas < 0, ((as_ / 2.0) ** 2).sum(-1), torch.zeros_like(sumas)
    )
    denom = torch.amax(real_data, dim=-1)
    score = (h1s + 1000.0 * pfun) / real_data.shape[-1] / denom
    return torch.where(denom > 0, score, torch.full_like(score, math.inf))


def _roi_window(real_data, target_idx, index_width: int):
    """Positions, target index and window ``[start, end)`` of each row, each
    shaped to broadcast against ``real_data`` (..., n); ``target_idx`` is
    an int or an integer tensor broadcasting against the leading dims."""
    n = real_data.shape[-1]
    idx = torch.arange(n, device=real_data.device)
    ti = torch.as_tensor(target_idx, device=real_data.device)[..., None]
    start = torch.clamp(ti - index_width, min=0)
    end = torch.clamp(ti + index_width, max=n)
    return idx, ti, start, end


def peak_minima_score_raw(real_data, target_idx, index_width: int):
    """|min(left flank) - min(right flank)| around the target peak, over the
    last axis: the left flank is ``[target_idx - index_width, target_idx)``,
    the right ``[target_idx, target_idx + index_width)``, both clipped to
    the row; an empty flank takes the value at the target.  Masked (equal
    to slicing) so the target may differ per row."""
    idx, ti, start, end = _roi_window(real_data, target_idx, index_width)
    left = (idx >= start) & (idx < ti)
    right = (idx >= ti) & (idx < end)
    big = torch.full_like(real_data, math.inf)
    at_target = torch.take_along_dim(real_data, ti, dim=-1)[..., 0]
    mina = torch.where(left.any(-1), torch.where(left, real_data, big).amin(-1),
                       at_target)
    minb = torch.where(right.any(-1),
                       torch.where(right, real_data, big).amin(-1), at_target)
    return _abs(mina - minb)


def roi_positivity_score_raw(real_data, target_idx, index_width: int):
    """Five times the negative signal minus the positive signal within
    ``[target_idx - index_width, target_idx + index_width)`` (clipped),
    over the last axis."""
    idx, ti, start, end = _roi_window(real_data, target_idx, index_width)
    roi = (idx >= start) & (idx < end)
    zero = torch.zeros_like(real_data)
    pos_reward = torch.where(roi & (real_data > 0), real_data, zero).sum(-1)
    neg_penalty = torch.where(roi & (real_data < 0), -real_data, zero).sum(-1)
    return neg_penalty * 5.0 - pos_reward


# method -> score(real rows, target index, index width)
_SCORES = {
    "acme": lambda data, ti, iw: acme_score_raw(data),
    "peak_minima": peak_minima_score_raw,
    "positivity": roi_positivity_score_raw,
}


def _np_objective(method, data, coords, pivot, x_range, target_idx,
                  index_width):
    """The NumPy objective of ``(p0[, p1])`` on one complex row (the scipy
    search's): the raw ACME formula (no ``+inf`` guard), or an ROI score
    on slices."""
    def objective(ph):
        p0 = ph[0]
        p1 = ph[1] if len(ph) > 1 else 0.0
        phi = np.radians(p0) + np.radians(p1) * ((coords - pivot) / x_range)
        d = np.real(data * np.exp(1.0j * phi))
        if method == "acme":
            ds1 = np.abs((d[1:] - d[:-1]) / 2.0)
            p = ds1 / np.sum(ds1)
            p[p == 0] = 1
            h1s = np.sum(-p * np.log(p))
            as_ = d - np.abs(d)
            pfun = np.sum((as_ / 2) ** 2) if np.sum(as_) < 0 else 0.0
            return (h1s + 1000 * pfun) / d.shape[-1] / np.max(d)
        start = max(0, target_idx - index_width)
        end = min(len(d), target_idx + index_width)
        if method == "peak_minima":
            mina = np.min(d[start:target_idx]) if start < target_idx else d[target_idx]
            minb = np.min(d[target_idx:end]) if end > target_idx else d[target_idx]
            return np.abs(mina - minb)
        if method == "positivity":
            roi = d[start:end]
            return np.sum(np.abs(roi[roi < 0])) * 5.0 - np.sum(roi[roi > 0])
        raise ValueError(f"Unknown method {method!r}")

    return objective


# The reference's settings: candidate meshes and polish length.
N_P0 = 36
N_P1 = 41
POLISH_ITERS = 40


@functools.lru_cache(maxsize=16)
def _search_constants(dtype, device: str):
    """Candidate meshes and the unit-space span as tensors on ``device``
    (made once)."""
    step = 360.0 / N_P0
    meshes = (
        np.linspace(-180.0, 180.0, N_P0, endpoint=False),
        np.linspace(-4000.0, 4000.0, N_P1),
        np.linspace(-1.5 * step, 1.5 * step, 7),
        np.asarray([360.0, 8000.0]),
    )
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in meshes)


def resolve_polish(polish_optimizer: str, rows_re, method: str = "acme") -> str:
    """The reference's ``"auto"`` rule on this card: the fused kernel for the
    ACME objective on a float32 batch of more than one row on a CUDA
    device, else ``"gd"`` (the single-pivot row and the ROI methods keep
    gd, as in the reference)."""
    if polish_optimizer != "auto":
        return polish_optimizer
    fused = (method == "acme" and rows_re.is_cuda and rows_re.shape[0] > 1
             and rows_re.dtype == torch.float32)
    return "fused" if fused else "gd"


def _grid_phase_search(rows_re, rows_im, coords, x_range, pivots,
                       p0_only: bool, *, method: str = "acme", t_idx=None,
                       index_width: int = 1, polish_optimizer: str = "gd",
                       cand_chunk: int = 4, newton_iters: int | None = None,
                       kernels: KernelSet = DISPATCH):
    """Phase search on (V, n_f) rows: candidate scan + polish.

    The reference's ``_grid_phase_search``.  ``method`` names the objective
    (:data:`_SCORES`); the ROI methods read each row's ``t_idx`` (V,) and
    ``index_width`` (ACME ignores both; ``t_idx`` defaults to 0).  The scan
    scores candidates on rows decimated to ~512 points (stride ``n_f //
    512``) for ACME and at full resolution for the ROI methods, whose
    window a stride would shift or collapse: p0 on a 36-point mesh; for p0
    + p1 a coordinate descent (marginal p0, then p1 given p0 on a 41-point
    mesh, then a 7-point p0 refinement).  Candidates are scored
    ``cand_chunk`` at a time (the reference's ``lax.scan`` over chunks,
    which bounds the (V, chunk, n) temporaries at grid scale); a chunk's
    winner replaces the running best only when strictly better, so ties go
    to the first candidate, and a voxel whose every candidate scores
    ``inf`` keeps 0.

    The polish (``polish_optimizer``, see :func:`resolve_polish` for
    ``"auto"``): ``"gd"`` is the reference's backtracking gradient descent
    in unit space (span 360 / 8000), with p0 wrapped into [-180, 180) and
    p1 clipped to [-4000, 4000]; for p0 only on decimated rows, the first
    iterations run there (the target index and width divided by the
    stride).  ``"fused"`` runs it as ``kernels.acme_polish`` (K5 on CUDA
    tensors; ACME only, an ROI method raises ``ValueError``).
    ``"newton"``/``"bfgs"`` run :func:`_second_order_polish` at full
    resolution for ``newton_iters`` iterations (default 18 / 28).  Returns
    (V, 2) degrees.
    """
    polish_optimizer = resolve_polish(polish_optimizer, rows_re, method)
    if polish_optimizer not in ("gd", "fused", "newton", "bfgs"):
        raise ValueError(
            f"polish_optimizer must be 'gd', 'newton', 'bfgs', or 'fused', "
            f"got {polish_optimizer!r}."
        )
    if polish_optimizer == "fused" and method != "acme":
        raise ValueError(
            "polish_optimizer='fused' implements the ACME objective "
            "only; use 'gd'/'newton'/'bfgs' for the ROI methods."
        )
    score = _SCORES[method]
    dtype = rows_re.dtype
    dev = rows_re.device
    v, n_f = rows_re.shape
    if t_idx is None:
        t_idx = torch.zeros((v,), dtype=torch.long, device=dev)
    dec = max(1, n_f // 512) if method == "acme" else 1
    rows_re_d = rows_re[:, ::dec]
    rows_im_d = rows_im[:, ::dec]
    coords_d = coords[::dec]
    t_idx_d = t_idx // dec
    iw_d = max(1, index_width // dec)
    piv = pivots[:, None]  # (V, 1) broadcasts against candidates
    p0_c, p1_c, dp0, span = _search_constants(dtype, str(dev))

    def scan_axis(values, p0_base, p1_base, axis):
        """Score ``base + c`` for every candidate ``c`` along one axis,
        holding the other at its per-voxel base; per-voxel winner."""
        pad = (-values.shape[0]) % cand_chunk
        if pad:
            values = torch.cat([values, values[-1:].expand(pad)])
        base = p0_base if axis == 0 else p1_base
        best_e = torch.full((v,), math.inf, dtype=dtype, device=dev)
        best_v = torch.zeros((v,), dtype=dtype, device=dev)
        for chunk in values.view(-1, cand_chunk):
            zero = torch.zeros_like(chunk)
            p0v = p0_base[:, None] + (chunk if axis == 0 else zero)
            p1v = p1_base[:, None] + (chunk if axis == 1 else zero)
            d = _phased_real_planar(
                rows_re_d[:, None, :], rows_im_d[:, None, :], coords_d, p0v,
                p1v, piv[:, :, None], x_range,
            )
            e = score(d, t_idx_d[:, None], iw_d)  # (V, C)
            i = torch.argmin(e, dim=1)  # a NaN wins, as in jnp.argmin
            e_min = e.gather(1, i[:, None])[:, 0]
            better = e_min < best_e
            best_e = torch.where(better, e_min, best_e)
            best_v = torch.where(better, base + chunk[i], best_v)
        return best_v

    zero_v = torch.zeros((v,), dtype=dtype, device=dev)
    if p0_only:
        best_p = torch.stack([scan_axis(p0_c, zero_v, zero_v, 0), zero_v], 1)
    else:
        p0_a = scan_axis(p0_c, zero_v, zero_v, 0)
        p1_b = scan_axis(p1_c, p0_a, zero_v, 1)
        p0_r = scan_axis(dp0, p0_a, p1_b, 0)
        best_p = torch.stack([p0_r, p1_b], dim=1)

    if polish_optimizer in ("newton", "bfgs"):
        if newton_iters is None:
            newton_iters = 18 if polish_optimizer == "newton" else 28
        return _second_order_polish(
            best_p, rows_re, rows_im, coords, pivots, x_range, t_idx,
            index_width, newton_iters, polish_optimizer, method, p0_only)

    # The two-phase polish (decimated first) is quality-neutral only for
    # the 1-D p0 search; p0 + p1 polishes on the exact objective.
    two_phase = p0_only and dec > 1
    fine_iters = max(POLISH_ITERS // 3, 8) if two_phase else POLISH_ITERS

    if polish_optimizer == "fused":
        xr = float(x_range)
        half_cell = 0.5 / max(N_P0, 2)
        if two_phase:
            best_p, _ = kernels.acme_polish(
                rows_re_d.contiguous(), rows_im_d.contiguous(),
                coords_d.contiguous(), pivots, best_p, xr,
                n_iter=POLISH_ITERS - fine_iters, p0_only=True,
                half_cell=half_cell,
            )
        best_p, _ = kernels.acme_polish(
            rows_re.contiguous(), rows_im.contiguous(), coords.contiguous(),
            pivots, best_p, xr, n_iter=fine_iters, p0_only=p0_only,
            half_cell=half_cell,
        )
        return best_p

    def wrap_params(p):
        p0 = torch.remainder(p[:, 0] + 180.0, 360.0) - 180.0
        p1 = torch.clamp(p[:, 1], -4000.0, 4000.0)
        return torch.stack([p0, p1], dim=1)

    def polish(best_p, re_, im_, crd, ti, iw, iters):
        def value_and_grad(p):
            with torch.enable_grad():
                pv = p.detach().requires_grad_(True)
                p1 = torch.zeros_like(pv[:, 1]) if p0_only else pv[:, 1]
                f = score(
                    _phased_real_planar(re_, im_, crd, pv[:, 0], p1, piv,
                                        x_range),
                    ti, iw,
                )
                (grad,) = torch.autograd.grad(f.sum(), pv)
            return f.detach(), grad

        f, g_raw = value_and_grad(best_p)
        # First trial step spans about half a mesh cell.
        g0 = _finite(g_raw) * span
        half_cell = 0.5 / N_P0
        gmax = g0.abs().max(dim=1).values
        lr = half_cell / torch.clamp(gmax, min=torch.finfo(dtype).tiny)
        lr = torch.where(gmax > 0, lr, torch.full_like(lr, 1e-2))
        p = best_p
        for _ in range(iters):
            g = _finite(g_raw) * span
            p_new = wrap_params(p - (lr[:, None] * g) * span)
            f_new, g_new = value_and_grad(p_new)
            better = f_new < f
            p = torch.where(better[:, None], p_new, p)
            f = torch.where(better, f_new, f)
            g_raw = torch.where(better[:, None], g_new, g_raw)
            lr = torch.where(better, lr * 1.2, lr * 0.5)
        return p

    if two_phase:
        best_p = polish(best_p, rows_re_d, rows_im_d, coords_d, t_idx_d, iw_d,
                        POLISH_ITERS - fine_iters)
    return polish(best_p, rows_re, rows_im, coords, t_idx, index_width,
                  fine_iters)


def _finite(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _unit_objective(method: str, p0_only: bool, coords, x_range, index_width,
                    span):
    """One row's objective of the unit-space phases ``u`` (``u * span`` in
    degrees; p1 = 0 with ``p0_only``): ``f(u, row_re, row_im, pivot,
    t_idx)``, a scalar, for ``torch.func`` transforms."""
    score = _SCORES[method]

    def one_obj(u, row_re, row_im, pivot, ti):
        p0 = u[0] * span[0]
        p1 = torch.zeros_like(p0) if p0_only else u[1] * span[1]
        d = _phased_real_planar(row_re, row_im, coords, p0, p1, pivot, x_range)
        return score(d, ti, index_width)

    return one_obj


def unit_hessians(one_obj, u, rows_re, rows_im, pivots, t_idx):
    """Per-row exact Hessians (V, n, n) of ``one_obj`` at ``u`` (V, n):
    forward-over-reverse, ``vmap(jacfwd(grad))``, as the reference's
    ``jax.vmap(jax.jacfwd(jax.grad(...)))``."""
    from torch.func import grad, jacfwd, vmap

    return vmap(jacfwd(grad(one_obj)))(u, rows_re, rows_im, pivots, t_idx)


def _second_order_polish(best_p, rows_re, rows_im, coords, pivots, x_range,
                         t_idx, index_width: int, iters: int, mode: str,
                         method: str, p0_only: bool):
    """Levenberg-damped second-order polish of (V, 2) degrees on the exact
    objective (reference ``polish_second_order``), in unit space (span 360
    / 8000).

    ``"newton"``: every iteration the exact 1x1 / 2x2 Hessian
    (:func:`unit_hessians`) and gradient, a damped closed-form step and one
    trial evaluation.  ``"bfgs"``: the exact Hessian once at the seed, then
    rank-2 BFGS updates from the gradient pairs of the trial evaluations
    (an update only where the trial was accepted and both curvature terms
    exceed 1e-12).  The damping adds ``lam * max(|H_ii|, 1e-6)`` to the
    diagonal (Marquardt), ``lam`` starts at 1e-2 and goes x0.33 on an
    accepted trial, x4 on a rejected one; a Hessian with a non-finite entry
    becomes the identity, a singular 2x2 system takes no step.  p0 wraps
    into [-180, 180), p1 is clipped to [-4000, 4000].
    """
    from torch.func import grad, grad_and_value, vmap

    dtype, dev = rows_re.dtype, rows_re.device
    v = rows_re.shape[0]
    n_par = 1 if p0_only else 2
    span = _search_constants(dtype, str(dev))[3][:n_par]
    tiny = torch.finfo(dtype).tiny
    eye = torch.eye(n_par, dtype=dtype, device=dev)
    one_obj = _unit_objective(method, p0_only, coords, x_range, index_width,
                              span)
    rows = (rows_re, rows_im, pivots, t_idx)

    def obj(u):
        return vmap(one_obj)(u, *rows)

    def value_and_grad(u):
        g, f = vmap(grad_and_value(one_obj))(u, *rows)
        return f, g

    def clip_u(u):
        p0u = (torch.remainder(u[:, 0] * span[0] + 180.0, 360.0) - 180.0) / span[0]
        if p0_only:
            return p0u[:, None]
        p1u = torch.clamp(u[:, 1], -4000.0 / 8000.0, 4000.0 / 8000.0)
        return torch.stack([p0u, p1u], dim=1)

    def sanitize_h(h):
        bad = ~torch.isfinite(h).all(dim=2).all(dim=1)
        return torch.where(bad[:, None, None], eye, h)

    def damped_step(g, h, lam):
        g = _finite(g)
        dmag = torch.clamp(torch.diagonal(h, dim1=1, dim2=2).abs(), min=1e-6)
        hd = h + lam[:, None, None] * (dmag[:, :, None] * eye)
        if n_par == 1:
            return -g / hd[:, :, 0]
        a, b = hd[:, 0, 0], hd[:, 0, 1]
        c, e = hd[:, 1, 0], hd[:, 1, 1]
        det = a * e - b * c
        safe = det.abs() > tiny
        det = torch.where(safe, det, torch.ones_like(det))
        s = torch.stack([-(e * g[:, 0] - b * g[:, 1]) / det,
                         -(a * g[:, 1] - c * g[:, 0]) / det], dim=1)
        return torch.where(safe[:, None], s, torch.zeros_like(s))

    with torch.no_grad():
        u = clip_u(best_p[:, :n_par] / span)
        lam = torch.full((v,), 1e-2, dtype=dtype, device=dev)
        if mode == "newton":
            f = obj(u)
            for _ in range(iters):
                h = sanitize_h(unit_hessians(one_obj, u, *rows))
                g = vmap(grad(one_obj))(u, *rows)
                u_new = clip_u(u + damped_step(g, h, lam))
                f_new = obj(u_new)
                better = f_new < f
                u = torch.where(better[:, None], u_new, u)
                f = torch.where(better, f_new, f)
                lam = torch.where(better, lam * 0.33, lam * 4.0)
        else:  # bfgs
            f, g = value_and_grad(u)
            g = _finite(g)
            bmat = sanitize_h(unit_hessians(one_obj, u, *rows))
            for _ in range(iters):
                u_new = clip_u(u + damped_step(g, bmat, lam))
                f_new, g_new = value_and_grad(u_new)
                ok = torch.isfinite(f_new) & (f_new < f)
                s_vec = u_new - u
                y = g_new - g
                sy = (s_vec * y).sum(1)
                bs = torch.einsum("vij,vj->vi", bmat, s_vec)
                sbs = (s_vec * bs).sum(1)
                upd = (ok & (sy > 1e-12) & (sbs > 1e-12)
                       & torch.isfinite(y).all(dim=1))
                sy_s = torch.where(upd, sy, torch.ones_like(sy))
                sbs_s = torch.where(upd, sbs, torch.ones_like(sbs))
                b_new = (bmat
                         + y[:, :, None] * y[:, None, :] / sy_s[:, None, None]
                         - bs[:, :, None] * bs[:, None, :] / sbs_s[:, None, None])
                u = torch.where(ok[:, None], u_new, u)
                f = torch.where(ok, f_new, f)
                g = torch.where(ok[:, None], g_new, g)
                bmat = torch.where(upd[:, None, None], b_new, bmat)
                lam = torch.where(ok, lam * 0.33, lam * 4.0)
        p0f = torch.remainder(u[:, 0] * span[0] + 180.0, 360.0) - 180.0
        p1f = torch.zeros_like(p0f) if p0_only else u[:, 1] * span[1]
    return torch.stack([p0f, p1f], dim=1)


# Per-voxel DE: the bytes of one (chunk, population, n_freq) float32 plane
# of the objective's working set; the score keeps several such planes live.
# At the bench shape (30 members, 2048 points) this is 8192 voxels a chunk:
# on an H100 (700 W) the search took 1.972 s a grid, 16 384 voxels 1.930 s
# at twice the memory, 4096 2.064 s, 2048 2.527 s (PERF.md section 6).
DE_PLANE_BYTES = 2 << 30


def de_chunk_rows(n_rows: int, n_pop: int, n_freq: int) -> int:
    """Rows of one DE chunk: the largest power of two whose (rows, n_pop,
    n_freq) float32 plane fits :data:`DE_PLANE_BYTES`, at most ``n_rows``."""
    rows = max(1, DE_PLANE_BYTES // (4 * n_pop * n_freq))
    rows = 1 << (rows.bit_length() - 1)
    return max(1, min(rows, n_rows))


def _de_phase_search(rows_re, rows_im, coords, x_range, pivots,
                     p0_only: bool, *, method: str = "acme", t_idx=None,
                     index_width: int = 1, seed: int = 42, popsize: int = 15,
                     maxiter: int = 1000, polish_iters: int = 60,
                     chunk: int | None = None):
    """Phases of (V, n_f) rows by differential evolution on the ``method``
    objective (:data:`_SCORES`; the ROI methods read ``t_idx`` (V,) and
    ``index_width``): one independent best1bin search per row (tol 0.01,
    then a ``polish_iters`` gradient polish; the reference's
    ``optimizer="de"``), p0 in [-180, 180] and p1 in [-4000, 4000] degrees
    (p1 = 0 with ``p0_only``).  Rows run in chunks of ``chunk`` (default
    :func:`de_chunk_rows`), one generator seeded from ``seed`` drawing for
    them in turn.  Returns (V, 2) degrees."""
    bounds = [(-180.0, 180.0)] if p0_only else [(-180.0, 180.0),
                                                (-4000.0, 4000.0)]
    v, n_f = rows_re.shape
    n_pop = max(popsize * len(bounds), 5)
    if chunk is None:
        chunk = de_chunk_rows(v, n_pop, n_f)
    dev, dtype = rows_re.device, rows_re.dtype
    score = _SCORES[method]
    if t_idx is None:
        t_idx = torch.zeros((v,), dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    bounds_t = torch.as_tensor(bounds, dtype=dtype, device=dev)
    out = []
    for start in range(0, v, chunk):
        sl = slice(start, start + chunk)
        re_c, im_c, piv_c, ti_c = (rows_re[sl], rows_im[sl], pivots[sl],
                                   t_idx[sl])

        def energy(x, rows):
            p1 = torch.zeros_like(x[..., 0]) if p0_only else x[..., 1]
            return score(_phased_real_planar(
                re_c[rows][:, None, :], im_c[rows][:, None, :], coords,
                x[..., 0], p1, piv_c[rows][:, None, None], x_range),
                ti_c[rows][:, None], index_width)

        res = differential_evolution_batched(
            energy, bounds_t, re_c.shape[0], seed=gen, popsize=popsize,
            maxiter=maxiter, tol=0.01, polish_iters=polish_iters)
        out.append(res.x)
    xs = torch.cat(out)
    if p0_only:
        xs = torch.cat([xs, torch.zeros_like(xs)], dim=1)
    return xs


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def phase(
    da: XmrArray,
    dim: str = DIMS.frequency,
    p0: float = 0.0,
    p1: float = 0.0,
    pivot: float | None = None,
) -> XmrArray:
    """Apply zero- and first-order phase correction (degrees) to a spectrum.

    ``p1`` is the total phase twist across the full coordinate range,
    anchored at ``pivot`` (default: the coordinate of the global maximum
    magnitude).  The phase parameters are recorded in ``attrs``; phasing in
    another coordinate than a previous phase operation warns.
    """
    _check_dims(da, dim, "phase")
    coords = da.coords[dim].values.astype(np.float64)

    if pivot is None:
        values = da.values
        flat_idx = int(np.argmax(np.abs(values)))
        target_idx = np.unravel_index(flat_idx, da.shape)[da.get_axis_num(dim)]
        pivot = float(coords[target_idx])

    x_range = float(coords.max()) - float(coords.min())
    factor = phase_factor_raw(coords, float(p0), float(p1), float(pivot), x_range)
    _, cplx = matching_dtypes(da.dtype)
    factor = np.asarray(factor, dtype=cplx)
    if factor.ndim == 0:
        # Zero coordinate range: the p1 term vanishes and the scalar p0
        # factor broadcasts.
        factor = np.full(coords.shape, factor, dtype=cplx)

    da_phased = (da * XmrArray(factor, (dim,))).transpose(*da.dims)
    da_phased.name = da.name
    da_phased.attrs = da.attrs.copy()

    if ATTRS.phase_pivot_coord in da_phased.attrs:
        old_coord = da_phased.attrs[ATTRS.phase_pivot_coord]
        if old_coord != dim:
            warnings.warn(
                f"Applying phase in '{dim}', but previous phase operations "
                f"were recorded in '{old_coord}'. Ensure your pivot value "
                f"({pivot}) matches the current dimension's units."
            )

    da_phased.attrs[ATTRS.phase_p0] = p0
    da_phased.attrs[ATTRS.phase_p1] = p1
    da_phased.attrs[ATTRS.phase_pivot] = pivot
    da_phased.attrs[ATTRS.phase_pivot_coord] = dim
    return da_phased


def _planes(data, device):
    """Real and imaginary planes of a payload on ``device``: float64 for
    complex128, float32 for anything else."""
    t = torch.as_tensor(data)
    real_dtype = torch.float64 if t.dtype == torch.complex128 else torch.float32
    return tuple(p.to(real_dtype) for p in complex_planes(t, device))


def autophase(
    da: XmrArray,
    dim: str = DIMS.frequency,
    method: str = "acme",
    mode: str = "single",
    peak_width: float = 0.5,
    target_coord: float | None = None,
    p0_only: bool = False,
    lb: float = 0.0,
    temp_time_dim: str = DIMS.time,
    optimizer: str = "de",
    seed: int = 42,
    polish_optimizer: str = "auto",
    device="cuda",
    kernels: KernelSet = DISPATCH,
    **kwargs,
) -> XmrArray:
    """Find and apply a phase correction (reference ``autophase``).

    ``method``: ``"acme"`` (default), ``"peak_minima"`` or ``"positivity"``
    (:data:`_SCORES`); the ROI methods score a window of ``index_width =
    max(1, round(peak_width / 2 / step))`` bins either side of the target
    (``target_coord``'s nearest bin, else the row's loudest).
    ``mode="single"`` searches the 1-D slice holding the global maximum and
    applies the result globally; ``mode="all"`` searches every voxel
    (:func:`_autophase_all`).  ``optimizer="de"`` (the default) is
    differential evolution seeded from ``seed`` with a 60-step gradient
    polish (:func:`_de_phase_search`; one search per voxel in ``"all"``);
    ``optimizer="grid"`` the deterministic candidate scan + polish of
    :func:`_grid_phase_search`, whose ``polish_optimizer`` is ``"auto"``,
    ``"gd"``, ``"fused"``, ``"newton"`` or ``"bfgs"``;
    ``optimizer="scipy"`` (single mode only) runs
    ``scipy.optimize.differential_evolution`` (best1bin, tol 0.01, ``seed``,
    ``disp`` from ``kwargs``, default False) on the host with
    :func:`_np_objective`, the reference's reproduction path.  The other
    searches run on ``device`` (the card unless the caller passes
    ``"cpu"``); the result's payload is numpy for a numpy input and a
    tensor for a tensor input.  ``kernels`` selects the kernel wrappers
    (default) or their plain versions.  Bounds: p0 in [-180, 180] degrees;
    p1 in [-4000, 4000] degrees unless ``p0_only`` locks p1 = 0.
    """
    _check_dims(da, dim, "autophase")
    kwargs.setdefault("disp", False)
    if mode not in ("single", "all"):
        raise ValueError("Mode must be 'single' or 'all'.")
    if method not in _SCORES:
        raise ValueError("Method must be 'acme', 'peak_minima', or 'positivity'")

    coords = da.coords[dim].values.astype(np.float64)
    x_range = float(coords.max() - coords.min())
    step_size = float(np.abs(coords[1] - coords[0]))
    index_width = max(1, int(round((peak_width / 2.0) / step_size)))

    if mode == "all":
        if optimizer not in ("de", "grid"):
            raise ValueError(
                "mode='all' supports optimizer='de' (per-voxel differential "
                "evolution) or optimizer='grid' (candidate grid + gradient "
                "polish); the scipy path is single-mode only."
            )
        return _autophase_all(
            da, dim, target_coord, p0_only, lb, temp_time_dim,
            optimizer=optimizer, seed=seed,
            polish_optimizer=polish_optimizer, device=device, kernels=kernels,
            method=method, index_width=index_width,
        )
    if optimizer not in ("de", "grid", "scipy"):
        raise ValueError("optimizer must be 'de', 'grid', or 'scipy'.")

    values = da.values
    unraveled = np.unravel_index(int(np.argmax(np.abs(values))), da.shape)
    if target_coord is not None:
        target_idx = int(np.argmin(np.abs(coords - target_coord)))
        pivot = float(target_coord)
    else:
        target_idx = int(unraveled[da.get_axis_num(dim)])
        pivot = float(coords[target_idx])

    opt_da = da.isel({d: int(unraveled[i]) for i, d in enumerate(da.dims)
                      if d != dim})
    if lb > 0:
        opt_da = to_spectrum(
            apodize_exp(to_fid(opt_da, dim=dim, out_dim=temp_time_dim),
                        dim=temp_time_dim, lb=lb),
            dim=temp_time_dim, out_dim=dim,
        )
    if optimizer == "scipy":
        import scipy.optimize

        objective = _np_objective(method, opt_da.values, coords, pivot,
                                  x_range, target_idx, index_width)
        bounds = [(-180.0, 180.0)] if p0_only else [(-180.0, 180.0),
                                                    (-4000.0, 4000.0)]
        opt = scipy.optimize.differential_evolution(
            objective, bounds=bounds, strategy="best1bin", tol=0.01,
            seed=seed, disp=kwargs.get("disp"),
        )
        p0_opt = float(opt.x[0])
        p1_opt = 0.0 if p0_only else float(opt.x[1])
        return phase(da, dim=dim, p0=p0_opt, p1=p1_opt, pivot=pivot)

    re, im = _planes(opt_da.data, device)
    args = (re[None, :], im[None, :],
            torch.as_tensor(coords, dtype=re.dtype, device=re.device), x_range,
            torch.tensor([pivot], dtype=re.dtype, device=re.device), p0_only)
    roi = dict(method=method, index_width=index_width,
               t_idx=torch.tensor([target_idx], device=re.device))
    if optimizer == "de":
        xs = _de_phase_search(*args, seed=seed, **roi)
    else:
        xs = _grid_phase_search(*args, polish_optimizer=polish_optimizer,
                                cand_chunk=16, kernels=kernels, **roi)
    p0_opt = float(xs[0, 0])
    p1_opt = 0.0 if p0_only else float(xs[0, 1])
    return phase(da, dim=dim, p0=p0_opt, p1=p1_opt, pivot=pivot)


def _autophase_all(
    da: XmrArray,
    dim: str,
    target_coord: float | None,
    p0_only: bool,
    lb: float,
    temp_time_dim: str,
    optimizer: str = "grid",
    seed: int = 42,
    polish_optimizer: str = "auto",
    device="cuda",
    kernels: KernelSet = DISPATCH,
    method: str = "acme",
    index_width: int = 1,
) -> XmrArray:
    """Per-voxel autophase: one search per 1-D spectrum on ``device``, the
    grid search (``optimizer="grid"``) on all voxels in one batch, or one
    differential evolution per voxel (``"de"``, :func:`_de_phase_search`)
    in chunks of :func:`de_chunk_rows` voxels, on the ``method`` objective
    (the ROI methods' window is ``index_width`` bins either side of the
    target).

    The search reads the lb-smoothed spectra (``lb > 0``); the phases are
    applied to the original data.  Each voxel's target is its maximum-
    magnitude bin and its pivot that coordinate (or ``target_coord`` and
    its nearest bin); ``phase_p0``/``phase_p1``/``phase_pivot`` in the
    result's attrs are numpy arrays over the voxel dims.
    """
    src = da.to(device)
    work = src
    if lb > 0:
        work = to_spectrum(
            apodize_exp(to_fid(src, dim=dim, out_dim=temp_time_dim),
                        dim=temp_time_dim, lb=lb),
            dim=temp_time_dim, out_dim=dim,
        )
    coords = np.asarray(da.coords[dim].values, dtype=np.float64)
    x_range = float(coords.max() - coords.min())
    order = [d for d in da.dims if d != dim] + [dim]
    n_points = da.sizes[dim]
    voxel_shape = tuple(da.sizes[d] for d in order[:-1])

    rows_re, rows_im = _planes(
        work.transpose(*order).data.reshape(-1, n_points), device)
    n_rows, dev = rows_re.shape[0], rows_re.device
    coords_t = torch.as_tensor(coords, dtype=rows_re.dtype, device=dev)
    if target_coord is not None:
        pivots = torch.full((n_rows,), float(target_coord),
                            dtype=rows_re.dtype, device=dev)
        ti = int(np.argmin(np.abs(coords - target_coord)))
        t_idx = torch.full((n_rows,), ti, dtype=torch.long, device=dev)
    else:
        t_idx = torch.argmax(rows_re * rows_re + rows_im * rows_im, 1)
        pivots = coords_t[t_idx]

    roi = dict(method=method, t_idx=t_idx, index_width=index_width)
    if optimizer == "de":
        sol = _de_phase_search(rows_re, rows_im, coords_t, x_range, pivots,
                               p0_only, seed=seed, **roi)
    else:
        sol = _grid_phase_search(
            rows_re, rows_im, coords_t, x_range, pivots, p0_only,
            polish_optimizer=polish_optimizer, cand_chunk=4, kernels=kernels,
            **roi,
        )
    p0s = sol[:, 0]
    p1s = torch.zeros_like(p0s) if p0_only else sol[:, 1]

    if work is src:
        orig_re, orig_im = rows_re, rows_im
    else:
        orig_re, orig_im = _planes(
            src.transpose(*order).data.reshape(-1, n_points), device)
    phi = torch.deg2rad(p0s)[:, None] + torch.deg2rad(p1s)[:, None] * (
        (coords_t[None, :] - pivots[:, None]) / x_range
    )
    c, s = torch.cos(phi), torch.sin(phi)
    phased = torch.complex(orig_re * c - orig_im * s, orig_re * s + orig_im * c)
    phased = phased.reshape(voxel_shape + (n_points,))
    if not isinstance(da.data, torch.Tensor):
        _, cplx = matching_dtypes(da.dtype)
        phased = phased.cpu().numpy().astype(cplx)
    out = da.transpose(*order).copy(data=phased).transpose(*da.dims)
    out.attrs = da.attrs.copy()
    out.attrs[ATTRS.phase_p0] = p0s.cpu().numpy().reshape(voxel_shape)
    out.attrs[ATTRS.phase_p1] = p1s.cpu().numpy().reshape(voxel_shape)
    out.attrs[ATTRS.phase_pivot] = pivots.cpu().numpy().reshape(voxel_shape)
    out.attrs[ATTRS.phase_pivot_coord] = dim
    return out
