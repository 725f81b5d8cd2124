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
* :func:`crlb_from_hessian_slab` — CRLBs from the carried Hessian (K4);
* :func:`lm_fit_batched_pallas` — the public kernel LM (``fit_amares``'s),
  with every branch of the reference's LM driver that ``kernel_version``,
  ``spd_pallas`` and ``gate_rejects`` select: the slab loop (v9, K2 + K3),
  the dense per-iteration loop (v1 K14, v2 K13, v3 K7, v5 K12, v6 K11, v7
  K10, v8 K9 or v9 K2, with the damped solve K6a or the plain
  ``spd_solve_small``) and the whole-loop kernel (v10, K8);
* :func:`crlb_from_hessian` (K6b) and :func:`crlb_batched_pallas` — CRLBs
  from a dense Hessian, the latter from one normal-equations evaluation;
* :func:`crlb_batched_planar` — CRLBs from the analytic Jacobian, the
  pure-tensor engine's;
* :func:`_varpro_override` — the VARPRO step of free-g priors, plain
  tensor glue between the kernel launches of either per-iteration loop;
* :func:`lm_fit_batched`, :func:`crlb_batched` and
  :func:`eq6_model_and_basis` — the complex-input wrappers.

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

from xmris_tpu_torch.core.utils import complex_planes
from xmris_tpu_torch.ops.bounds import (
    BOTH,
    FREE,
    LOWER,
    UPPER,
    expand_params_batched,
    external_to_internal_torch,
    internal_to_external_torch,
)
from xmris_tpu_torch.ops.kernels import DISPATCH
from xmris_tpu_torch.ops.kernels.lm_cuda import NormalEqPlan
from xmris_tpu_torch.ops.kernels.lm_jac_cuda import t_is_uniform as _t_is_uniform
from xmris_tpu_torch.ops.kernels.spd import (
    spd_inverse_diag_small,
    spd_solve_small,
)
from xmris_tpu_torch.runtime.profiling import count, to_host

def classify_bounds(lower: np.ndarray, upper: np.ndarray) -> np.ndarray:
    kind = np.full(lower.shape, FREE, dtype=np.int32)
    has_lo = np.isfinite(lower)
    has_hi = np.isfinite(upper)
    kind[has_lo & has_hi] = BOTH
    kind[has_lo & ~has_hi] = LOWER
    kind[~has_lo & has_hi] = UPPER
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
        [kind == BOTH, kind == LOWER, kind == UPPER],
        [u_both, u_lower, u_upper],
        x,
    )


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


def expand_params(x_free, pmap_static):
    """(..., F) free vector -> (..., K, 5) physical parameter grid."""
    full = expand_params_batched(x_free, pmap_static)
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


class _VarproConsts(NamedTuple):
    """A VARPRO plan's per-fit constants on the fit's device: the S
    amplitude and phase slots, their scales and offsets, and with a slab H
    the slab rows of the Gram blocks (``None`` for the dense layout)."""

    sa: torch.Tensor
    sp: torch.Tensor
    scale_a: torch.Tensor
    offset_a: torch.Tensor
    scale_p: torch.Tensor
    offset_p: torch.Tensor
    rows_aa: torch.Tensor | None
    rows_ap: torch.Tensor | None


def _varpro_consts(plan, dtype, device, slab_f=None) -> _VarproConsts:
    """Upload a :func:`varpro_plan` once per fit (see :class:`_VarproConsts`)."""
    sa_np = [int(v) for v in plan["sa"]]
    sp_np = [int(v) for v in plan["sp"]]

    def slab_rows(cols):
        if slab_f is None:
            return None
        return torch.as_tensor([i * slab_f + j for i in sa_np for j in cols],
                               device=device)

    return _VarproConsts(
        torch.as_tensor(sa_np, device=device),
        torch.as_tensor(sp_np, device=device),
        *(torch.as_tensor(plan[k], dtype=dtype, device=device)
          for k in ("scale_a", "offset_a", "scale_p", "offset_p")),
        slab_rows(sa_np), slab_rows(sp_np))


def _varpro_override(u_t, u, g, h, lam, lower, upper, kind, plan, lam0,
                     slab_f=None):
    """Kaufman variable-projection step (reference ``_varpro_override``):
    the trial's amplitude/phase slots of the ``plan`` peaks jump to the
    exact complex-LS optimum of the carried linearization at the accepted
    point ``u``, while the LM step moves the shifts, linewidths and g.

    With ``row_a(k) = m_a e^{i phi_k} P_k`` and ``row_p(k) = m_p i c_k P_k``
    (``m_*`` = scale x dx/du), the carried H and g hold ``Re Z_kl``,
    ``-a_l Im Z_kl`` and the projections ``v_k``; solving ``Z c' = v + Z a``
    as a 2S real block system (the plain unrolled ``spd_solve_small``, as
    the reference's XLA solve) gives the new amplitudes ``|c'|`` and phase
    corrections ``arg c'``.  Each phase is wrapped into the 360-degree
    window centred on its bounds (or on its current value).  A voxel keeps
    the plain LM trial when the solve is not finite, an amplitude is at or
    below 1e-5, a transform factor is pinned (|m| <= 1e-10) or ``lam >
    10 lam0``.

    ``h`` is the dense (B, F, F) internal-space Hessian, or with
    ``slab_f=F`` the (F*F, B) voxel-minor slab, whose Gram entries are the
    rows ``sa[k]*F + sa[l]``.  ``plan`` is a :func:`varpro_plan` or its
    uploaded :class:`_VarproConsts` (which the LM loop's hook builds once
    per fit).
    """
    c = plan if isinstance(plan, _VarproConsts) else _varpro_consts(
        plan, u.dtype, u.device, slab_f)
    sa, sp = c.sa, c.sp
    scale_a, offset_a, scale_p, offset_p = (c.scale_a, c.offset_a, c.scale_p,
                                            c.offset_p)

    x, dxdu = internal_to_external_torch(u, lower, upper, kind)
    a = offset_a + scale_a * x[:, sa]  # (B, S) amplitudes
    m_a = scale_a * dxdu[:, sa]
    m_p = scale_p * dxdu[:, sp] * (math.pi / 180.0)
    mpa = m_p * a

    s = sa.shape[0]
    if c.rows_aa is None:
        h_aa = h[:, sa[:, None], sa[None, :]]
        h_ap = h[:, sa[:, None], sp[None, :]]
    else:
        h_aa = h[c.rows_aa].t().reshape(-1, s, s)
        h_ap = h[c.rows_ap].t().reshape(-1, s, s)
    re_z = h_aa / (m_a[:, :, None] * m_a[:, None, :])
    im_z = -h_ap / (m_a[:, :, None] * mpa[:, None, :])
    # Hermitian symmetrization (Im Z has a zero diagonal in exact arithmetic).
    re_z = 0.5 * (re_z + re_z.transpose(1, 2))
    im_z = 0.5 * (im_z - im_z.transpose(1, 2))

    v_re = g[:, sa] / m_a
    v_im = g[:, sp] / mpa
    n_re = v_re + torch.einsum("bkl,bl->bk", re_z, a)
    n_im = v_im + torch.einsum("bkl,bl->bk", im_z, a)

    ridge = (1e-6 / s) * torch.diagonal(re_z, dim1=1, dim2=2).sum(-1)
    eye2 = torch.eye(2 * s, dtype=u.dtype, device=u.device)
    block = torch.cat([torch.cat([re_z, -im_z], dim=2),
                       torch.cat([im_z, re_z], dim=2)], dim=1)
    block = block + ridge[:, None, None] * eye2[None]
    sol = spd_solve_small(block, torch.cat([n_re, n_im], dim=1))
    cr, ci = sol[:, :s], sol[:, s:]

    amp_new = torch.sqrt(cr * cr + ci * ci)
    dphi = torch.atan2(ci, cr) * (180.0 / math.pi)
    ph_new = offset_p + scale_p * x[:, sp] + dphi
    xp_new = (ph_new - offset_p) / scale_p
    period = 360.0 / scale_p.abs()
    lo_p, hi_p = lower[sp][None, :], upper[sp][None, :]
    center = torch.where(torch.isfinite(lo_p) & torch.isfinite(hi_p),
                         0.5 * (lo_p + hi_p), x[:, sp])
    xp_new = center + torch.remainder(
        xp_new - center + 0.5 * period, period) - 0.5 * period
    x_new = x.clone()
    x_new[:, sa] = (amp_new - offset_a) / scale_a
    x_new[:, sp] = xp_new
    u_new = external_to_internal_torch(x_new, lower, upper, kind)

    ok = (torch.isfinite(sol).all(1) & (a > 1e-5).all(1)
          & (m_a.abs() > 1e-10).all(1) & (mpa.abs() > 1e-10).all(1)
          & (lam <= 10.0 * lam0))[:, None]
    u_t = u_t.clone()
    u_t[:, sa] = torch.where(ok, u_new[:, sa], u_t[:, sa])
    u_t[:, sp] = torch.where(ok, u_new[:, sp], u_t[:, sp])
    return u_t


def _varpro_hook(varpro, pmap_static, lower, upper, kind, lam0, slab_f=None):
    """The LM loop's ``override`` for ``varpro``, or ``None``."""
    plan = varpro_plan(pmap_static) if varpro else None
    if plan is None:
        return None
    return functools.partial(
        _varpro_override, lower=lower, upper=upper, kind=kind,
        plan=_varpro_consts(plan, lower.dtype, lower.device, slab_f),
        lam0=lam0)


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
        if not to_host(active.any()):
            break
        count("lm.iterations")
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


def lm_fit_batched(fids, t, u0, lower, upper, kind, pmap_static, mhz: float,
                   max_iter: int = 50, lam0: float = 1e-3, ftol: float = 1e-10):
    """Complex-input wrapper of :func:`lm_fit_batched_planar` (reference
    ``lm_fit_batched``): ``fids`` (B, n_t) complex, numpy or a tensor, is
    split into planes on ``t``'s device."""
    re, im = complex_planes(fids, t.device)
    return lm_fit_batched_planar(re, im, t, u0, lower, upper, kind,
                                 pmap_static, mhz, max_iter=max_iter,
                                 lam0=lam0, ftol=ftol)


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
    gate_rejects: bool = False,
    varpro: bool = False,
):
    """Bounded LM over the grid on the normal-equations and SPD kernels.

    Port of the reference's ``_lm_fit_batched_pallas_impl`` on its v9 +
    slab branch: one K2 evaluation per iteration returns (cost, g, H) at
    the trial point, rejected steps keep the carried accepted-state H/g and
    only re-damp.  ``gate_rejects`` passes the carried cost to K2 as its
    accept gate: a trial that does not improve gets its cost only (the loop
    never selects its g and H).  ``varpro`` applies the VARPRO override
    (:func:`_varpro_override`) to each trial, its Gram entries read off
    the slab.

    The reference loop runs while ``(i < max_iter) & ~all(done)``; this
    one reads the count of voxels not done on the host once per iteration,
    which gives the same trip count (at most ``max_iter`` syncs per grid).
    Done voxels are frozen, and K2 skips them; once a grid-sized batch is
    down to its last few voxels the loop runs on those alone
    (:func:`_lm_loop`'s ``subset``).

    ``kernels`` is a :class:`~xmris_tpu_torch.ops.kernels.KernelSet`.
    Returns ``(LMResult, h_slab)`` with ``h_slab`` the (F*F, B) external-
    space Hessian in the voxel-minor slab layout (see
    :func:`_slab_result_tail`).
    """
    fids_re, fids_im, t, u, lower, upper = _as_kernel_inputs(
        fids_re, fids_im, t, u0, lower, upper)
    n_free = u.shape[-1]
    plan = normal_eq_plan(
        pmap_static, n_free, mhz, uniform_t_ok and fids_re.shape[-1] % 128 == 0
    )

    def evaluator(re, im):
        def full_eval(u, voxel_mask=None, cost_prev=None):
            x, dxdu = internal_to_external_torch(u, lower, upper, kind)
            grids = expand_params_batched(x, pmap_static)
            return kernels.normal_equations(
                grids.contiguous(), re, im, t, dxdu.contiguous(), plan,
                voxel_mask=voxel_mask,
                cost_prev=cost_prev if gate_rejects else None,
            )
        return full_eval

    u, cost, n_acc, done, h = _lm_loop(
        evaluator(fids_re, fids_im), kernels.spd_solve_damped, u,
        voxel_axis=1, max_iter=max_iter, lam0=lam0, ftol=ftol,
        plateau_streak=plateau_streak,
        override=_varpro_hook(varpro, pmap_static, lower, upper, kind, lam0,
                              slab_f=n_free),
        subset=lambda rows: evaluator(fids_re.index_select(0, rows),
                                      fids_im.index_select(0, rows)),
    )
    return _slab_result_tail(u, cost, n_acc, done, h, lower, upper, kind)


def _as_kernel_inputs(fids_re, fids_im, t, u0, lower, upper):
    """float32 (the kernels' type), contiguous planes and time axis, and
    the seed broadcast to (B, F)."""
    dtype = torch.float32
    fids_re = fids_re.to(dtype).contiguous()
    fids_im = fids_im.to(dtype).contiguous()
    u = u0.to(dtype)
    if u.ndim == 1:
        u = u[None, :].expand(fids_re.shape[0], -1)
    return (fids_re, fids_im, t.to(dtype).contiguous(), u.contiguous(),
            lower.to(dtype), upper.to(dtype))


# The LM loop goes on with its last voxels alone once a batch of at least
# COMPACT_MIN_BATCH voxels is down to 1 / COMPACT_SHARE of them.  On the
# 12-line prior a grid's last voxel may take 11 more trips than the rest
# (an accept-reject walk at the cost's float32 resolution that only the
# plateau streak ends), each of which ran K3 and the H select over the
# whole grid.
COMPACT_SHARE = 16
COMPACT_MIN_BATCH = 1024


def _lm_loop(full_eval, solve, u, *, voxel_axis, max_iter, lam0, ftol,
             plateau_streak, override=None, subset=None):
    """The per-iteration LM loop of the reference driver.

    ``full_eval(u, voxel_mask, cost_prev)`` returns ``(cost, g, h)`` at
    internal ``u``: voxels whose mask entry is False may come back
    unspecified, and (with an accept gate) so may the g and H of a voxel
    whose cost is not below its ``cost_prev``.  Neither is ever selected:
    every carried value is chosen by ``torch.where`` on ``ok``, which
    requires an improving cost of a voxel that is not done.  ``solve(h, g,
    lam)`` is the damped step; ``h`` has its voxels on axis ``voxel_axis``
    (1 for the slab, 0 for dense matrices).  ``override(u_t, u, g, h,
    lam)``, when given, rewrites the trial point after the damped step and
    before its evaluation (the VARPRO override).  ``subset(rows)``, when
    given (and no override), returns ``full_eval`` for the voxels ``rows``
    alone: once a batch of at least ``COMPACT_MIN_BATCH`` voxels has at most
    1 / ``COMPACT_SHARE`` of them left, the loop gathers their state, goes
    on with them alone, and scatters it back at the end.  Each voxel's
    arithmetic is its own, so the outputs are the whole batch's loop's, up
    to the rounding of the predicted decrease's sum over F, whose order may
    follow the batch's size.  Returns ``(u, cost, n_acc, done, h)`` at the
    last accepted state.
    """
    eps = torch.finfo(torch.float32).eps
    b = u.shape[0]
    cost, g, h = full_eval(u)
    lam = torch.full((b,), lam0, dtype=torch.float32, device=u.device)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=u.device)
    streak = torch.zeros_like(n_acc)
    done = torch.zeros((b,), dtype=torch.bool, device=u.device)
    whole = None  # the whole batch's outputs and the rows gathered from it
    if override is not None or b < COMPACT_MIN_BATCH:
        subset = None

    def sel_h(ok, new, old):
        shape = [1] * new.ndim
        shape[voxel_axis] = ok.shape[0]
        return torch.where(ok.reshape(shape), new, old)

    for _ in range(max_iter):
        left = to_host((~done).sum())
        if left == 0:
            break
        if subset is not None and whole is None and left * COMPACT_SHARE <= b:
            # The rows not done, ascending (a stable sort of the flags, so
            # no second host read).
            rows = torch.sort(done.to(torch.uint8), stable=True).indices[:left]
            whole = (rows, u, cost, h, n_acc, done)
            u, cost, g, lam, n_acc, streak, done = (
                x.index_select(0, rows)
                for x in (u, cost, g, lam, n_acc, streak, done))
            h = h.index_select(voxel_axis, rows)
            full_eval = subset(rows)
        count("lm.iterations")
        delta_raw = solve(h, g, lam)
        solve_ok = torch.isfinite(delta_raw).all(-1)
        delta = torch.where(
            solve_ok[:, None], delta_raw, torch.zeros_like(delta_raw)
        )
        u_t = u + delta
        if override is not None:
            u_t = override(u_t, u, g, h, lam)
        # Predicted-decrease exit (see the reference's LM loop).
        pred_rel = (g * delta).sum(-1) / torch.clamp(cost, min=1e-30)
        done = done | (
            (pred_rel >= 0.0) & (pred_rel <= 64.0 * eps) & (lam < lam0)
            & solve_ok
        )

        cost_t, g_t, h_t = full_eval(u_t, voxel_mask=~done, cost_prev=cost)
        ok = torch.isfinite(cost_t) & (cost_t < cost) & ~done
        rel_drop = (cost - cost_t) / torch.clamp(cost, min=1e-30)

        u = torch.where(ok[:, None], u_t, u)
        cost = torch.where(ok, cost_t, cost)
        g = torch.where(ok[:, None], g_t, g)
        h = sel_h(ok, h_t, h)
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 2.5), 1e-12, 1e12)
        n_acc = n_acc + ok.to(torch.int32)
        plateau = ~ok & ~done & (rel_drop.abs() <= 64.0 * eps)
        streak = torch.where(plateau, streak + 1, 0)
        done = (
            done
            | (ok & (rel_drop < ftol) & (lam < lam0))
            | (streak >= plateau_streak)
        )
    if whole is not None:
        rows, u_all, cost_all, h_all, n_acc_all, done_all = whole
        u = u_all.index_copy(0, rows, u)
        cost = cost_all.index_copy(0, rows, cost)
        h = h_all.index_copy(voxel_axis, rows, h)
        n_acc = n_acc_all.index_copy(0, rows, n_acc)
        done = done_all.index_copy(0, rows, done)
    return u, cost, n_acc, done, h


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


def slab_to_bff(h_slab, f: int):
    """(F*F, B) voxel-minor slab -> dense (B, F, F) row-major matrices."""
    return h_slab.view(f, f, -1).permute(2, 0, 1).contiguous()


def check_kernel_version(kernel_version: int) -> None:
    """Accept the versions the reference accepts: 1-3 and 5-9 (the per-
    iteration normal-equations kernels) and 10 or above (the whole-loop K8;
    its per-evaluation callers take K2, as the reference's
    ``_select_pallas_kernel`` resolves them).  Any other version raises the
    reference's ``ValueError``."""
    if kernel_version < 10 and kernel_version not in (1, 2, 3, 5, 6, 7, 8, 9):
        raise ValueError(
            f"kernel_version={kernel_version!r} does not exist; "
            "valid versions are 1-3 and 5-10 (9 is the default)"
        )


def lm_fit_batched_pallas(
    fids_re,
    fids_im,
    t,
    u0,
    lower,
    upper,
    kind,
    pmap_static,
    mhz: float,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
    kernel_version: int = 9,
    return_hessian: bool | str = False,
    require_uniform_t: bool = False,
    gate_rejects: bool = False,
    plateau_streak: int = 3,
    varpro: bool | None = None,
    spd_pallas: bool = True,
    *,
    kernels=DISPATCH,
):
    """Bounded LM on the hand-written kernels (reference
    ``lm_fit_batched_pallas``, same signature and returns).

    ``kernel_version`` resolves as the reference's ``_select_pallas_kernel``
    does: 9 (default) evaluates with K2 each iteration; 1 with K14, 2 with
    K13 and 3 with K7 (one function, every physical row); 5 with K12, 6
    with K11 (the active rows; K11 skips done voxels); 7 with K10 (K11 on
    the block-factored basis) when ``n_t % 128 == 0``, else K11; 8 with K9
    (three moments) when every g is fixed at 0, else K11; 10 and above run
    the whole fit in one K8 launch.  The step of the per-iteration loop is
    K3 on the slab (v9 with ``spd_pallas``), K6a on dense matrices (the
    other versions with ``spd_pallas``) or, with ``spd_pallas=False``, the
    reference's plain ``spd_solve_small`` on dense matrices.  The block-
    factored basis of v9/v10 is used when ``t`` is uniform (or
    ``require_uniform_t`` vouches for it).  Version 7 with
    ``n_t % 128 == 0`` raises the reference's ``ValueError`` on a non-
    uniform ``t``: the port's axis is always concrete, and the reference
    checks a concrete axis whatever ``require_uniform_t`` says.

    ``gate_rejects`` turns on K2's accept gate (v9): a trial whose cost does
    not improve skips its moments, g and H.  At 10 and above it falls back
    to the per-iteration v9 path, as in the reference.  Other versions
    ignore it.  The reference's ``v_tile`` and ``interpret`` (TPU tiling,
    Pallas interpret mode) have no counterpart: tensors on the CPU take the
    kernels' plain versions.

    ``varpro=None`` (auto) turns the VARPRO override
    (:func:`_varpro_override`) on exactly when the prior has a free g and
    an amplitude/phase pair qualifies (:func:`auto_varpro`); True/False
    force it (True is a no-op without a qualifying pair).  The override is
    driver work between launches, so with it on, 10 and above run the
    per-iteration v9 loop (K2 + K3), as in the reference.

    Returns the :class:`LMResult`, or with ``return_hessian=True``
    ``(LMResult, h_ext)``: the dense (B, F, F) external-space Gauss-Newton
    Hessian at the optimum (rows of parameters pinned at a bound zeroed),
    the Fisher information :func:`crlb_from_hessian` takes;
    ``return_hessian="slab"`` keeps it as the (F*F, B) slab (v9 with
    ``spd_pallas`` only) for :func:`crlb_from_hessian_slab`.
    """
    t_uniform = _t_is_uniform(t)
    if kernel_version == 7 and fids_re.shape[-1] % 128 == 0 and not t_uniform:
        raise ValueError(
            "kernel_version=7 requires a uniformly sampled time axis; "
            "got non-uniform spacing. Use kernel_version=6/8 instead."
        )
    if varpro is None:
        varpro = auto_varpro(pmap_static)
    return _lm_fit_batched_pallas_impl(
        fids_re, fids_im, t, u0, lower, upper, kind, pmap_static, mhz,
        kernels=kernels, max_iter=max_iter, lam0=lam0, ftol=ftol,
        kernel_version=kernel_version, return_hessian=return_hessian,
        uniform_t_ok=require_uniform_t or t_uniform,
        plateau_streak=plateau_streak,
        varpro=bool(varpro) and varpro_plan(pmap_static) is not None,
        spd_pallas=spd_pallas, gate_rejects=gate_rejects,
    )


def _lm_fit_batched_pallas_impl(
    fids_re, fids_im, t, u0, lower, upper, kind, pmap_static, mhz: float, *,
    kernels, max_iter: int, lam0: float, ftol: float, kernel_version: int,
    return_hessian, uniform_t_ok: bool, plateau_streak: int, varpro: bool,
    spd_pallas: bool, gate_rejects: bool = False,
):
    """The driver's branches (reference ``_lm_fit_batched_pallas_impl``):
    the whole-loop K8, the slab loop, or the dense per-iteration loop.
    ``varpro`` (resolved by the caller) applies the VARPRO override to
    every trial of the per-iteration loops."""
    check_kernel_version(kernel_version)
    # The override and the accept gate are launch-loop concepts: with
    # either, 10 and above run the per-iteration v9 loop.
    whole_loop = kernel_version >= 10 and not varpro and not gate_rejects
    if kernel_version >= 10 and not whole_loop:
        kernel_version = 9
    if whole_loop:
        if return_hessian == "slab":
            raise ValueError(
                "return_hessian='slab' requires the per-iteration v9 path"
            )
        re, im, t, u, lo, hi = _as_kernel_inputs(fids_re, fids_im, t, u0,
                                                 lower, upper)
        plan = normal_eq_plan(pmap_static, u.shape[-1], mhz,
                              uniform_t_ok and re.shape[-1] % 128 == 0)
        u, cost, n_acc, done, h = kernels.lm_loop_v10(
            u, re, im, t, lo, hi, kind, plan, pmap_static, max_iter=max_iter,
            lam0=lam0, ftol=ftol, plateau_streak=plateau_streak,
        )
        return _pallas_result_tail(u, cost, n_acc, done, h, lo, hi, kind,
                                   return_hessian)
    slab_mode = uses_slab_hessian(spd_pallas, kernel_version)
    if return_hessian == "slab" and not slab_mode:
        raise ValueError(
            "return_hessian='slab' requires the slab-mode path "
            "(spd_pallas=True, kernel_version=9)"
        )
    if slab_mode:
        res, h_slab = lm_fit_batched_slab(
            fids_re, fids_im, t, u0, lower, upper, kind, pmap_static, mhz,
            kernels=kernels, max_iter=max_iter, lam0=lam0, ftol=ftol,
            plateau_streak=plateau_streak, uniform_t_ok=uniform_t_ok,
            gate_rejects=gate_rejects, varpro=varpro,
        )
        if return_hessian == "slab":
            return res, h_slab
        return (res, slab_to_bff(h_slab, res.x_free.shape[-1])
                ) if return_hessian else res

    re, im, t, u, lo, hi = _as_kernel_inputs(fids_re, fids_im, t, u0, lower,
                                             upper)
    evaluate = _dense_normal_equations(
        kernel_version, pmap_static, u.shape[-1], mhz,
        uniform_t_ok and re.shape[-1] % 128 == 0, kernels, re, im, t,
        gate_rejects=gate_rejects,
    )

    def full_eval(u, voxel_mask=None, cost_prev=None):
        x, dxdu = internal_to_external_torch(u, lo, hi, kind)
        return evaluate(expand_params_batched(x, pmap_static).contiguous(),
                        dxdu.contiguous(), voxel_mask, cost_prev)

    solve = kernels.spd_solve_damped_dense if spd_pallas else _damped_solve_small
    u, cost, n_acc, done, h = _lm_loop(
        full_eval, solve, u, voxel_axis=0, max_iter=max_iter, lam0=lam0,
        ftol=ftol, plateau_streak=plateau_streak,
        override=_varpro_hook(varpro, pmap_static, lo, hi, kind, lam0),
    )
    return _pallas_result_tail(u, cost, n_acc, done, h, lo, hi, kind,
                               return_hessian)


def _physical_normal_equations(kernel_version, pmap_static, n_t, mhz,
                               kernels):
    """The reference's ``_select_pallas_kernel`` for versions 1-8:
    ``(evaluate, rows)`` with ``evaluate(grids, re, im, t, voxel_mask) ->
    (cost, g, h)`` in physical space over ``rows`` (the prior's active
    rows, or ``None`` for all 5K).  6, 7 and 8 take the voxel mask; 7 falls
    back to K11 when ``n_t % 128 != 0``, 8 when a g is not fixed at 0.
    The LM driver checked the time axis and the prior, so K10 and K9 skip
    their host-side checks (``validate=False``)."""
    n_peaks = int(pmap_static[3])
    if kernel_version in (1, 2, 3):
        fn = {1: kernels.normal_equations_v1, 2: kernels.normal_equations_v2,
              3: kernels.normal_equations_v3}[kernel_version]
        return (lambda grids, re, im, t, mask:
                fn(grids, re, im, t, n_peaks, mhz)), None
    active = active_param_rows(pmap_static)
    flags = lorentzian_env_flags(pmap_static)
    if kernel_version == 8 and all(flags):
        return (lambda grids, re, im, t, mask: kernels.normal_equations_v8(
            grids, re, im, t, n_peaks, mhz, active, voxel_mask=mask,
            validate=False)), active
    if kernel_version == 7 and n_t % 128 == 0:
        return (lambda grids, re, im, t, mask: kernels.normal_equations_v7(
            grids, re, im, t, n_peaks, mhz, active, flags, voxel_mask=mask,
            validate=False)), active
    if kernel_version >= 6:
        return (lambda grids, re, im, t, mask: kernels.normal_equations_v6(
            grids, re, im, t, n_peaks, mhz, active, voxel_mask=mask)), active
    return (lambda grids, re, im, t, mask: kernels.normal_equations_v5(
        grids, re, im, t, n_peaks, mhz, active)), active


def _dense_normal_equations(kernel_version, pmap_static, n_free, mhz,
                            factored, kernels, re, im, t, gate_rejects=False):
    """``evaluate(grids, dxdu, voxel_mask, cost_prev) -> (cost, g (B, F),
    h (B, F, F))`` in internal free space: K2 (v9, its slab made dense;
    ``cost_prev`` is its accept gate with ``gate_rejects``), or a physical-
    space kernel of :func:`_physical_normal_equations` folded by the
    scatter matrix and dx/du (the reference's einsums, full float32
    products outside the kernel; ``cost_prev`` unused)."""
    if kernel_version >= 9:
        plan = normal_eq_plan(pmap_static, n_free, mhz, factored)

        def evaluate(grids, dxdu, voxel_mask, cost_prev=None):
            cost, g, h = kernels.normal_equations(
                grids, re, im, t, dxdu, plan, voxel_mask=voxel_mask,
                cost_prev=cost_prev if gate_rejects else None)
            return cost, g, slab_to_bff(h, n_free)

        return evaluate
    phys, rows = _physical_normal_equations(kernel_version, pmap_static,
                                            re.shape[-1], mhz, kernels)
    smat_np = _scatter_matrix(pmap_static, n_free)
    if rows is not None:
        smat_np = smat_np[list(rows), :]
    smat = torch.as_tensor(smat_np, dtype=torch.float32, device=re.device)

    def evaluate(grids, dxdu, voxel_mask, cost_prev=None):
        cost, g_p, h_p = phys(grids, re, im, t, voxel_mask)
        g = torch.einsum("bp,pf->bf", g_p, smat) * dxdu
        h = torch.einsum("pf,bpq,qh->bfh", smat, h_p, smat)
        h = h * dxdu[:, :, None] * dxdu[:, None, :]
        return cost, g.contiguous(), h.contiguous()

    return evaluate


def _damped_solve_small(h, g, lam):
    """The reference's ``spd_pallas=False`` step: damping in tensor ops,
    then the unrolled ``spd_solve_small``."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)[None]
    diag = torch.diagonal(h, dim1=1, dim2=2)
    damped = h + (
        lam[:, None, None] * torch.clamp(diag, min=1e-12)[:, None, :] * eye
    ) + 1e-12 * eye
    return spd_solve_small(damped, g)


def _pallas_result_tail(u, cost, n_acc, done, h_fin, lower, upper, kind,
                        return_hessian):
    """Bound back-transform, convergence flags and, with
    ``return_hessian``, the external-space Hessian of a dense carried H
    (reference ``_pallas_result_tail``): the carried H is D H_ext D with
    D = diag(dx/du); a parameter pinned at a bound (dx/du ~ 0) has its row
    and column zeroed, which :func:`crlb_from_hessian` reports as an
    infinite CRLB."""
    x_final, dxdu_fin = internal_to_external_torch(u, lower, upper, kind)
    converged = torch.isfinite(cost) & ((n_acc > 0) | done)
    result = LMResult(x_free=x_final, cost=cost, n_iter=n_acc,
                      converged=converged, done=done)
    if not return_hessian:
        return result
    pinned = dxdu_fin.abs() < 1e-12
    safe_d = torch.where(pinned, torch.ones_like(dxdu_fin), dxdu_fin)
    h_ext = h_fin / (safe_d[:, :, None] * safe_d[:, None, :])
    keep = (~pinned).to(h_ext.dtype)
    return result, h_ext * keep[:, :, None] * keep[:, None, :]


def crlb_from_hessian(h_ext, cost, n_t: int, use_pallas: bool = True, *,
                      kernels=DISPATCH):
    """CRLB standard deviations from a dense (B, F, F) GN Hessian (reference
    ``crlb_from_hessian``): sigma^2 = cost / max(2 n_t - F, 1) per real
    channel, diag(H^-1) of ``h_ext + 1e-12 I`` from
    ``kernels.spd_inverse_diag_dense`` (K6b on the card; with
    ``use_pallas=False`` the reference's plain ``spd_inverse_diag``), and
    ``inf`` for a parameter whose Fisher diagonal is <= 0 (unidentifiable).
    Returns ``(sds (B, F), sigma2 (B,))``."""
    n_free = h_ext.shape[-1]
    eye = torch.eye(n_free, dtype=h_ext.dtype, device=h_ext.device)
    h = (h_ext + 1e-12 * eye[None]).contiguous()
    dof = max(2.0 * n_t - n_free, 1.0)
    sigma2 = cost / dof
    if use_pallas:
        diag_inv = kernels.spd_inverse_diag_dense(h)
    else:
        diag_inv = spd_inverse_diag_small(h)
    sds = torch.sqrt(torch.clamp(sigma2[:, None] * diag_inv, min=0.0))
    unident = torch.diagonal(h_ext, dim1=1, dim2=2) <= 0.0
    sds = torch.where(unident, torch.full_like(sds, math.inf), sds)
    return sds, sigma2


def crlb_batched_pallas(fids_re, fids_im, t, x_free, pmap_static, mhz: float,
                        kernel_version: int = 9, *, kernels=DISPATCH):
    """CRLBs from one normal-equations evaluation at the optimum (reference
    ``crlb_batched_pallas``): the Gauss-Newton H at external ``x_free``
    (K2 with a unit dx/du for 9 and above, the direct basis; for 1-8 the
    physical-space kernel the LM driver resolves, folded by the scatter
    matrix), then :func:`crlb_from_hessian` (K6b).  As in the reference,
    7 takes the block-factored K10 whenever ``n_t % 128 == 0``, with no
    check that ``t`` is uniform.  Returns ``(sds (B, F), sigma2 (B,))``."""
    check_kernel_version(kernel_version)
    dtype = torch.float32
    re = fids_re.to(dtype).contiguous()
    im = fids_im.to(dtype).contiguous()
    t = t.to(dtype).contiguous()
    x_free = x_free.to(dtype)
    n_free = x_free.shape[-1]
    evaluate = _dense_normal_equations(
        kernel_version, pmap_static, n_free, mhz, False, kernels, re, im, t)
    cost, _, h = evaluate(expand_params_batched(x_free, pmap_static)
                          .contiguous(), torch.ones_like(x_free), None)
    return crlb_from_hessian(h, cost, t.shape[0], kernels=kernels)


def crlb_batched_planar(fids_re, fids_im, t, x_free, pmap_static, mhz: float):
    """CRLB standard deviations of the free parameters from the analytic
    Jacobian at ``x_free`` (reference ``crlb_batched_planar``): sigma^2 from
    the final residuals per real channel, covariance ``sigma^2 (J_re^T J_re
    + J_im^T J_im + 1e-12 I)^-1`` in external parameter space.  Returns
    ``(sds (B, F), sigma2 (B,))`` in the planes' dtype."""
    dtype = fids_re.dtype
    t = t.to(dtype)
    x_free = x_free.to(dtype)
    n_free = x_free.shape[-1]
    smat = torch.as_tensor(
        _scatter_matrix(pmap_static, n_free), dtype=dtype, device=x_free.device
    )
    grid = expand_params(x_free, pmap_static)
    m_re, m_im, b_re, b_im = eq6_basis_planar(t, grid, mhz)
    j_re_p, j_im_p = eq6_jacobian_planar(t, grid, b_re, b_im, mhz)
    j_re = j_re_p.flatten(-2) @ smat
    j_im = j_im_p.flatten(-2) @ smat
    r2 = ((fids_re - m_re) ** 2 + (fids_im - m_im) ** 2).sum(-1)
    sigma2 = r2 / max(2.0 * t.shape[0] - n_free, 1.0)
    h = j_re.transpose(1, 2) @ j_re + j_im.transpose(1, 2) @ j_im
    eye = torch.eye(n_free, dtype=dtype, device=x_free.device)
    cov = sigma2[:, None, None] * torch.linalg.inv(h + 1e-12 * eye)
    sds = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0))
    return sds, sigma2


def crlb_batched(fids, t, x_free, pmap_static, mhz: float):
    """Complex-input wrapper of :func:`crlb_batched_planar` (reference
    ``crlb_batched``)."""
    re, im = complex_planes(fids, t.device)
    return crlb_batched_planar(re, im, t, x_free, pmap_static, mhz)


def eq6_model_and_basis(t, grid, mhz: float):
    """Complex model (..., n_t) and basis (..., n_t, K) of a (..., K, 5)
    grid (reference ``eq6_model_and_basis``)."""
    m_re, m_im, b_re, b_im = eq6_basis_planar(t, grid, mhz)
    return torch.complex(m_re, m_im), torch.complex(b_re, b_im)
