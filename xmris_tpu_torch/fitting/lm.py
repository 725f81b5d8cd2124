"""Batched bounded Levenberg-Marquardt for AMARES Eq.6 models (PyTorch).

Port of :mod:`xmris_tpu.fitting.lm`.  The host half (bound classification,
the parameter map, the static plans) is numpy; the device half is plain
PyTorch around the port's hand-written CUDA kernels:

* :func:`lm_fit_batched_planar` — the pure-tensor LM the one-voxel template
  fit uses (host-side setup, ``torch.linalg`` Cholesky);
* :func:`lm_fit_batched_slab` — the grid-scale LM loop of the reference's
  ``_lm_fit_batched_pallas_impl`` on its v9 + slab branch: one normal-
  equations kernel launch (K2) and one damped SPD solve (K3) per iteration,
  the Hessian kept in the voxel-minor slab layout throughout;
* :func:`crlb_from_hessian_slab` — CRLBs from the carried Hessian (K4).

Bounds use the MINPACK/lmfit transform (``x = lo + (sin u + 1)/2 (hi - lo)``
for two-sided bounds, shifted hyperbola for one-sided), as in the
reference.  All device math is planar float32: complex FIDs travel as
(real, imag) planes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels.lm_cuda import NormalEqPlan

_BOTH, _LOWER, _UPPER, _FREE = 0, 1, 2, 3


def classify_bounds(lower: np.ndarray, upper: np.ndarray) -> np.ndarray:
    kind = np.full(lower.shape, _FREE, dtype=np.int32)
    has_lo = np.isfinite(lower)
    has_hi = np.isfinite(upper)
    kind[has_lo & has_hi] = _BOTH
    kind[has_lo & ~has_hi] = _LOWER
    kind[~has_lo & has_hi] = _UPPER
    return kind


def external_to_internal(x, lower, upper, kind):
    """Map bounded external values to unbounded internal coordinates."""
    lo = np.where(np.isfinite(lower), lower, 0.0)
    hi = np.where(np.isfinite(upper), upper, 0.0)
    x = np.asarray(x, dtype=np.float64)

    frac = np.clip(
        np.where(hi > lo, (x - lo) / np.where(hi > lo, hi - lo, 1.0), 0.5),
        1e-8,
        1 - 1e-8,
    )
    u_both = np.arcsin(2.0 * frac - 1.0)
    v = np.maximum(x - lo + 1.0, 1.0 + 1e-12)
    u_lower = np.sqrt(v * v - 1.0)
    w = np.maximum(hi - x + 1.0, 1.0 + 1e-12)
    u_upper = np.sqrt(w * w - 1.0)

    return np.select(
        [kind == _BOTH, kind == _LOWER, kind == _UPPER],
        [u_both, u_lower, u_upper],
        x,
    )


def _finite_or_zero(b):
    return torch.where(torch.isfinite(b), b, torch.zeros_like(b))


def external_to_internal_torch(x, lower, upper, kind):
    """Tensor counterpart of :func:`external_to_internal` (same formulas)."""
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
    out = torch.where(kind == _UPPER, u_upper, x)
    out = torch.where(kind == _LOWER, u_lower, out)
    return torch.where(kind == _BOTH, u_both, out)


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

    is_both, is_lo, is_hi = kind == _BOTH, kind == _LOWER, kind == _UPPER
    x = torch.where(is_both, x_both, torch.where(
        is_lo, x_lower, torch.where(is_hi, x_upper, u)))
    dxdu = torch.where(is_both, d_both, torch.where(
        is_lo, d_lower, torch.where(is_hi, d_upper, torch.ones_like(u))))
    return x, dxdu


# ---------------------------------------------------------------------------
# Eq.6 model + analytic Jacobian, planar arithmetic
# ---------------------------------------------------------------------------


class ParamMap(NamedTuple):
    """Affine map from the free parameter vector to the (K, 5) physical grid.

    ``full[j] = offset[j] + scale[j] * x_free[idx[j]]`` with ``idx[j] = -1``
    for fixed parameters.  Column order: amplitude, chemical shift [ppm],
    linewidth [Hz], phase [deg], g.
    """

    idx: np.ndarray  # (K*5,) int32
    scale: np.ndarray  # (K*5,) float
    offset: np.ndarray  # (K*5,) float
    n_peaks: int


def hashable_pmap(pmap: ParamMap):
    """ParamMap as a hashable tuple (the static plans are cached on it)."""
    return (
        tuple(int(v) for v in pmap.idx),
        tuple(float(v) for v in pmap.scale),
        tuple(float(v) for v in pmap.offset),
        int(pmap.n_peaks),
    )


def _expand_params_batched(x, pmap_static):
    """(..., F) free vectors -> (..., K*5) physical grids."""
    idx = torch.as_tensor(pmap_static[0], device=x.device)
    scale = torch.as_tensor(pmap_static[1], dtype=x.dtype, device=x.device)
    offset = torch.as_tensor(pmap_static[2], dtype=x.dtype, device=x.device)
    gathered = x[..., torch.clamp(idx, min=0)]
    return offset + torch.where(
        idx >= 0, scale * gathered, torch.zeros_like(gathered)
    )


def expand_params(x_free, pmap_static):
    """(..., F) free vector -> (..., K, 5) physical parameter grid."""
    full = _expand_params_batched(x_free, pmap_static)
    return full.reshape(full.shape[:-1] + (pmap_static[3], 5))


def eq6_basis_planar(t, grid, mhz: float):
    """Per-peak planar basis B_k = a_k e^{i phi} E_k(t) and the model.

    ``grid`` is (..., K, 5); returns ``(m_re, m_im, b_re, b_im)`` with the
    basis planes shaped (..., n_t, K) and the model (..., n_t).
    """
    amp = grid[..., None, :, 0]
    f_hz = grid[..., None, :, 1] * mhz
    d = math.pi * grid[..., None, :, 2]
    phi = torch.deg2rad(grid[..., None, :, 3])
    g = grid[..., None, :, 4]

    t_col = t[:, None]
    envelope = amp * torch.exp(-d * (1.0 - g + g * t_col) * t_col)
    angle = 2.0 * math.pi * f_hz * t_col + phi
    b_re = envelope * torch.cos(angle)
    b_im = envelope * torch.sin(angle)
    return b_re.sum(-1), b_im.sum(-1), b_re, b_im


def eq6_jacobian_planar(t, grid, b_re, b_im, mhz: float):
    """Analytic planar Jacobian d(model)/d(physical params).

    Returns two (..., n_t, K, 5) planes; every partial reweights the basis
    (see the reference's ``eq6_jacobian_planar``): multiplying by ``i*c``
    maps planes (re, im) -> (-c*im, c*re).
    """
    amp = grid[..., None, :, 0]
    d = math.pi * grid[..., None, :, 2]
    g = grid[..., None, :, 4]
    t_col = t[:, None]

    safe_amp = torch.where(amp == 0, torch.ones_like(amp), amp)
    w_cs = 2.0 * math.pi * mhz * t_col
    w_lw = -math.pi * (1.0 - g + g * t_col) * t_col
    w_ph = math.pi / 180.0
    w_g = -d * (t_col * t_col - t_col)

    j_re = torch.stack(
        [b_re / safe_amp, -w_cs * b_im, w_lw * b_re, -w_ph * b_im, w_g * b_re],
        dim=-1,
    )
    j_im = torch.stack(
        [b_im / safe_amp, w_cs * b_re, w_lw * b_im, w_ph * b_re, w_g * b_im],
        dim=-1,
    )
    return j_re, j_im


@functools.lru_cache(maxsize=64)
def _scatter_matrix(pmap_static, n_free: int) -> np.ndarray:
    """Dense (K*5, F) matrix folding scale factors + free-slot routing."""
    idx = np.asarray(pmap_static[0])
    scale = np.asarray(pmap_static[1])
    s = np.zeros((len(idx), n_free), dtype=np.float64)
    for j, (slot, sc) in enumerate(zip(idx, scale)):
        if slot >= 0:
            s[j, slot] += sc
    return s


def active_param_rows(pmap_static) -> tuple[int, ...]:
    """Flat physical-parameter indices with a nonzero scatter-matrix row."""
    return tuple(int(j) for j, ix in enumerate(pmap_static[0]) if ix >= 0)


def lorentzian_env_flags(pmap_static) -> tuple[bool, ...]:
    """Per-peak flags: g fixed at exactly 0 (purely Lorentzian)."""
    idx, _, offset, n_peaks = pmap_static
    return tuple(
        idx[k * 5 + 4] < 0 and float(offset[k * 5 + 4]) == 0.0
        for k in range(n_peaks)
    )


@functools.lru_cache(maxsize=64)
def varpro_plan(pmap_static):
    """Plan of the reference's VARPRO linear re-solve: the peaks whose
    amplitude AND phase are free and untied.  ``None`` when no peak
    qualifies, else a dict of numpy arrays (see the reference)."""
    idx, scale, offset, n_peaks = pmap_static
    counts: dict[int, int] = {}
    for s in idx:
        if s >= 0:
            counts[int(s)] = counts.get(int(s), 0) + 1
    rows = []
    for k in range(n_peaks):
        ja, jp = 5 * k, 5 * k + 3
        sa, sp = int(idx[ja]), int(idx[jp])
        if sa < 0 or sp < 0 or sa == sp:
            continue
        if counts[sa] != 1 or counts[sp] != 1:
            continue
        if float(scale[ja]) == 0.0 or float(scale[jp]) == 0.0:
            continue
        rows.append(
            (sa, sp, float(scale[ja]), float(offset[ja]),
             float(scale[jp]), float(offset[jp]))
        )
    if not rows:
        return None
    arr = np.asarray(rows, np.float64)
    return {
        "sa": arr[:, 0].astype(np.int32),
        "sp": arr[:, 1].astype(np.int32),
        "scale_a": arr[:, 2], "offset_a": arr[:, 3],
        "scale_p": arr[:, 4], "offset_p": arr[:, 5],
    }


def uses_slab_hessian(spd_pallas: bool, kernel_version: int) -> bool:
    """The slab-mode rule of the reference: the Hessian stays in the
    normal-equations kernel's slab layout exactly when the kernel SPD
    solve consumes it (v9 + ``spd_pallas``)."""
    return spd_pallas and kernel_version == 9


def auto_varpro(pmap_static) -> bool:
    """The reference's auto-enable rule for the VARPRO override: any free g
    AND a qualifying amplitude/phase pair."""
    idx = pmap_static[0]
    has_free_g = any(idx[k * 5 + 4] >= 0 for k in range(pmap_static[3]))
    return has_free_g and varpro_plan(pmap_static) is not None


class LMResult(NamedTuple):
    x_free: torch.Tensor  # (B, F) final external free parameters
    cost: torch.Tensor  # (B,) final sum-of-squares
    n_iter: torch.Tensor  # (B,) accepted steps
    converged: torch.Tensor  # (B,) bool (finite cost + accept or done)
    done: torch.Tensor  # (B,) bool


# ---------------------------------------------------------------------------
# Pure-tensor LM (the one-voxel template fit)
# ---------------------------------------------------------------------------


def lm_fit_batched_planar(
    fids_re,  # (B, n_t)
    fids_im,  # (B, n_t)
    t,  # (n_t,)
    u0,  # (F,) shared or (B, F) per-voxel initial internal params
    lower,
    upper,
    kind,
    pmap_static,
    mhz: float,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
) -> LMResult:
    """Bounded LM on every row of the planar batch (reference
    ``lm_fit_batched_planar``).

    The reference vmaps a per-voxel ``while_loop``; here the batch runs one
    Python loop in which voxels that are done keep their state, which is
    the vmapped loop's semantics.  Host-side setup code: it reads the
    done mask on the host once per iteration and uses ``torch.linalg``.
    """
    dtype = fids_re.dtype
    t = t.to(dtype)
    lower = lower.to(dtype)
    upper = upper.to(dtype)
    u0 = u0.to(dtype)
    b = fids_re.shape[0]
    if u0.ndim == 1:
        u0 = u0[None, :].expand(b, -1)
    n_free = u0.shape[-1]
    smat = torch.as_tensor(
        _scatter_matrix(pmap_static, n_free), dtype=dtype, device=u0.device
    )
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    eye = torch.eye(n_free, dtype=dtype, device=u0.device)

    def evaluate(u):
        x, dxdu = internal_to_external_torch(u, lower, upper, kind)
        grid = expand_params(x, pmap_static)
        m_re, m_im, b_re, b_im = eq6_basis_planar(t, grid, mhz)
        cost = ((fids_re - m_re) ** 2 + (fids_im - m_im) ** 2).sum(-1)
        return dict(u=u, dxdu=dxdu, grid=grid, m_re=m_re, m_im=m_im,
                    b_re=b_re, b_im=b_im, cost=cost)

    st = evaluate(u0)
    lam = torch.full((b,), lam0, dtype=dtype, device=u0.device)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=u0.device)
    streak = torch.zeros_like(n_acc)
    done = torch.zeros((b,), dtype=torch.bool, device=u0.device)

    for _ in range(max_iter):
        active = ~done
        if not bool(active.any()):
            break
        j_re_p, j_im_p = eq6_jacobian_planar(
            t, st["grid"], st["b_re"], st["b_im"], mhz
        )
        j_re = (j_re_p.flatten(-2) @ smat) * st["dxdu"][:, None, :]
        j_im = (j_im_p.flatten(-2) @ smat) * st["dxdu"][:, None, :]
        r_re = fids_re - st["m_re"]
        r_im = fids_im - st["m_im"]
        h = j_re.transpose(1, 2) @ j_re + j_im.transpose(1, 2) @ j_im
        grad = (j_re.transpose(1, 2) @ r_re[..., None]
                + j_im.transpose(1, 2) @ r_im[..., None])[..., 0]

        diag = torch.diagonal(h, dim1=1, dim2=2)
        damped = (h + lam[:, None, None] * torch.diag_embed(
            torch.clamp(diag, min=1e-12)) + 1e-12 * eye)
        chol, info = torch.linalg.cholesky_ex(damped)
        delta = torch.cholesky_solve(grad[..., None], chol)[..., 0]
        # A failed factorization is NaN, as jnp.linalg.cholesky reports it.
        delta = torch.where((info == 0)[:, None], delta,
                            torch.full_like(delta, float("nan")))

        solve_ok = torch.isfinite(delta).all(-1)
        delta = torch.where(solve_ok[:, None], delta, torch.zeros_like(delta))
        pred_rel = (grad * delta).sum(-1) / torch.clamp(st["cost"], min=tiny)
        done_new = done | (
            (pred_rel >= 0.0) & (pred_rel <= 64.0 * eps) & (lam < lam0)
            & solve_ok
        )

        trial = evaluate(st["u"] + delta)
        ok = (torch.isfinite(trial["cost"]) & (trial["cost"] < st["cost"])
              & ~done_new)
        rel_drop = (st["cost"] - trial["cost"]) / torch.clamp(
            st["cost"], min=tiny
        )
        # Voxels that were done before this trip keep everything.
        take = ok & active
        st = {
            k: torch.where(take.reshape((-1,) + (1,) * (v.ndim - 1)),
                           trial[k], v)
            for k, v in st.items()
        }
        lam_new = torch.clamp(
            torch.where(ok, lam * 0.33, lam * 2.5), 1e-12, 1e12
        )
        lam = torch.where(active, lam_new, lam)
        n_acc = n_acc + take.to(torch.int32)
        plateau = ~ok & (rel_drop.abs() <= 64.0 * eps)
        streak = torch.where(
            active, torch.where(plateau, streak + 1, 0), streak
        )
        done_new = (done_new | (ok & (rel_drop < ftol) & (lam < lam0))
                    | (streak >= 3))
        done = torch.where(active, done_new, done)

    x_final, _ = internal_to_external_torch(st["u"], lower, upper, kind)
    converged = torch.isfinite(st["cost"]) & ((n_acc > 0) | done)
    return LMResult(x_free=x_final, cost=st["cost"], n_iter=n_acc,
                    converged=converged, done=done)


# ---------------------------------------------------------------------------
# Grid-scale LM on the hand-written kernels (v9 + slab branch)
# ---------------------------------------------------------------------------


def normal_eq_plan(pmap_static, n_free: int, mhz: float, factored: bool):
    """The kernel's static prior structure (reference ``_select_pallas_kernel``
    for ``kernel_version=9`` with the free-space fold)."""
    active = active_param_rows(pmap_static)
    return NormalEqPlan(
        n_peaks=int(pmap_static[3]),
        n_free=int(n_free),
        mhz=float(mhz),
        active=active,
        g_zero=lorentzian_env_flags(pmap_static),
        fold_slots=tuple(int(pmap_static[0][j]) for j in active),
        fold_scales=tuple(float(pmap_static[1][j]) for j in active),
        factored=bool(factored),
    )


def lm_fit_batched_slab(
    fids_re,
    fids_im,
    t,
    u0,
    lower,
    upper,
    kind,
    pmap_static,
    mhz: float,
    *,
    kernels,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
    plateau_streak: int = 3,
    uniform_t_ok: bool = False,
):
    """Bounded LM over the grid on the normal-equations and SPD kernels.

    Port of the reference's ``_lm_fit_batched_pallas_impl`` on its v9 +
    slab branch (no VARPRO, no accept gate, no whole-loop v10): one K2
    evaluation per iteration returns (cost, g, H) at the trial point,
    rejected steps keep the carried accepted-state H/g and only re-damp.

    The reference loop runs while ``(i < max_iter) & ~all(done)``; this
    one reads ``done.all()`` on the host once per iteration, which gives
    the same trip count (at most ``max_iter`` syncs per grid).  Done
    voxels are frozen, and K2 skips them.

    ``kernels`` is a :class:`~xmris_tpu_torch.ops.kernels.KernelSet`.
    Returns ``(LMResult, h_slab)`` with ``h_slab`` the (F*F, B) external-
    space Hessian in the voxel-minor slab layout (see
    :func:`_slab_result_tail`).
    """
    if auto_varpro(pmap_static):
        raise NotImplementedError(
            "the VARPRO override (priors with a free g) is not ported yet; "
            "see ROADMAP.md queue 1, item 6"
        )
    dtype = torch.float32  # the kernels are float32
    fids_re = fids_re.to(dtype).contiguous()
    fids_im = fids_im.to(dtype).contiguous()
    t = t.to(dtype).contiguous()
    lower = lower.to(dtype)
    upper = upper.to(dtype)
    u = u0.to(dtype)
    b = fids_re.shape[0]
    if u.ndim == 1:
        u = u[None, :].expand(b, -1)
    u = u.contiguous()
    n_free = u.shape[-1]
    n_t = fids_re.shape[-1]
    plan = normal_eq_plan(
        pmap_static, n_free, mhz, uniform_t_ok and n_t % 128 == 0
    )
    eps = torch.finfo(dtype).eps

    def full_eval(u, voxel_mask=None):
        x, dxdu = internal_to_external_torch(u, lower, upper, kind)
        grids = _expand_params_batched(x, pmap_static)
        return kernels.normal_equations(
            grids.contiguous(), fids_re, fids_im, t, dxdu.contiguous(), plan,
            voxel_mask=voxel_mask,
        )

    cost, g, h = full_eval(u)
    lam = torch.full((b,), lam0, dtype=dtype, device=u.device)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=u.device)
    streak = torch.zeros_like(n_acc)
    done = torch.zeros((b,), dtype=torch.bool, device=u.device)

    for _ in range(max_iter):
        if bool(done.all()):
            break
        delta_raw = kernels.spd_solve_damped(h, g, lam)
        solve_ok = torch.isfinite(delta_raw).all(-1)
        delta = torch.where(
            solve_ok[:, None], delta_raw, torch.zeros_like(delta_raw)
        )
        u_t = u + delta
        # Predicted-decrease exit (see the reference's LM loop).
        pred_rel = (g * delta).sum(-1) / torch.clamp(cost, min=1e-30)
        done = done | (
            (pred_rel >= 0.0) & (pred_rel <= 64.0 * eps) & (lam < lam0)
            & solve_ok
        )

        cost_t, g_t, h_t = full_eval(u_t, voxel_mask=~done)
        ok = torch.isfinite(cost_t) & (cost_t < cost) & ~done
        rel_drop = (cost - cost_t) / torch.clamp(cost, min=1e-30)

        u = torch.where(ok[:, None], u_t, u)
        cost = torch.where(ok, cost_t, cost)
        g = torch.where(ok[:, None], g_t, g)
        h = torch.where(ok[None, :], h_t, h)  # voxels are the minor axis
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 2.5), 1e-12, 1e12)
        n_acc = n_acc + ok.to(torch.int32)
        plateau = ~ok & ~done & (rel_drop.abs() <= 64.0 * eps)
        streak = torch.where(plateau, streak + 1, 0)
        done = (
            done
            | (ok & (rel_drop < ftol) & (lam < lam0))
            | (streak >= plateau_streak)
        )
    return _slab_result_tail(u, cost, n_acc, done, h, lower, upper, kind)


def _slab_result_tail(u, cost, n_acc, done, h_slab, lower, upper, kind):
    """Bound back-transform, convergence flags and the external-space
    Hessian (reference ``_pallas_result_tail``, slab branch).

    The carried H is D H_ext D with D = diag(dx/du) at the final state;
    the scaling is divided back out on the (F, F, B) view of the slab.  A
    parameter pinned at a bound (dx/du ~ 0) has its row and column zeroed,
    which :func:`crlb_from_hessian_slab` reports as an infinite CRLB.
    """
    x_final, dxdu_fin = internal_to_external_torch(u, lower, upper, kind)
    converged = torch.isfinite(cost) & ((n_acc > 0) | done)
    result = LMResult(x_free=x_final, cost=cost, n_iter=n_acc,
                      converged=converged, done=done)
    pinned = dxdu_fin.abs() < 1e-12
    safe_d = torch.where(pinned, torch.ones_like(dxdu_fin), dxdu_fin)
    inv = torch.where(pinned, torch.zeros_like(safe_d), 1.0 / safe_d)
    inv_t = inv.t()  # (F, B)
    f, b = inv_t.shape
    h4 = h_slab.view(f, f, b) * inv_t[:, None, :] * inv_t[None, :, :]
    return result, h4.reshape(f * f, b)


def crlb_from_hessian_slab(h_slab, cost, n_t: int, *, f: int, kernels):
    """CRLB standard deviations from the slab-form external Hessian
    (reference ``crlb_from_hessian_slab``): sigma^2 from the final cost per
    real channel, diag(H^-1) from K4 with an in-kernel 1e-12 Tikhonov
    term, and ``inf`` for a parameter whose Fisher diagonal is <= 0."""
    dof = max(2.0 * n_t - f, 1.0)
    sigma2 = cost / dof
    diag_inv = kernels.spd_inverse_diag(h_slab, tikhonov=1e-12)
    diag_h = h_slab.view(f, f, -1).diagonal(dim1=0, dim2=1)  # (B, f)
    sds = torch.sqrt(torch.clamp(sigma2[:, None] * diag_inv, min=0.0))
    sds = torch.where(diag_h <= 0.0, torch.full_like(sds, math.inf), sds)
    return sds, sigma2
