"""AMARES grid seeding and the seeded whole-grid fit (PyTorch port).

Port of the grid path of :mod:`xmris_tpu.fitting.amares`: the highest-SNR
template voxel (:func:`select_template_fid`, :func:`template_optimum`), the
static seeding plan (:func:`seed_plan`), the shared-basis linear LS
amplitude/phase seed, and :func:`seeded_fit_grid_raw`, which chains
amplitude rescaling, the LS seed, the bound transform, the kernel LM and
the CRLBs for every voxel of a grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmris_tpu_torch.fitting.lm import (
    crlb_from_hessian_slab,
    eq6_basis_planar,
    expand_params,
    external_to_internal,
    external_to_internal_torch,
    hashable_pmap,
    lm_fit_batched_planar,
    lm_fit_batched_slab,
    uses_slab_hessian,
)
from xmris_tpu_torch.fitting.prior import PriorKnowledge
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet


def select_template_fid(fid_arrs: np.ndarray, announce: bool = True) -> int:
    """Index of the highest-SNR FID: signal = mean |first 10 points|,
    noise = std of the last fifth."""
    n_time = fid_arrs.shape[-1]
    signal_region = np.mean(np.abs(fid_arrs[:, 0:10]), axis=1)
    noise_pts = max(10, n_time // 5)
    noise_region = np.std(fid_arrs[:, -noise_pts:], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        snr_array = np.where(noise_region == 0, 0, signal_region / noise_region)
    best_idx = int(np.nanargmax(snr_array))
    if announce:
        print(
            f"Auto-selected FID index {best_idx} for initialization "
            f"(SNR: {snr_array[best_idx]:.2f})"
        )
    return best_idx


def template_optimum(
    fid_arrs: np.ndarray,
    pk: PriorKnowledge,
    t,
    mhz: float,
    template_fid: np.ndarray | None = None,
    max_iter: int = 60,
) -> np.ndarray:
    """Fit the (auto-selected) highest-SNR voxel once with the pure-tensor
    LM and return its free-parameter optimum, the template every voxel's
    seed starts from.  Falls back to the prior's initial values when the
    template fit fails.  ``t`` is the (n_t,) time axis tensor; the fit runs
    on its device."""
    if template_fid is None:
        template_fid = fid_arrs[select_template_fid(fid_arrs, announce=False)]
    dev = t.device
    u0_t = torch.as_tensor(
        external_to_internal(pk.init_free[None, :], pk.lower, pk.upper, pk.kind),
        device=dev,
    )
    res = lm_fit_batched_planar(
        torch.as_tensor(np.ascontiguousarray(template_fid.real)[None, :],
                        device=dev),
        torch.as_tensor(np.ascontiguousarray(template_fid.imag)[None, :],
                        device=dev),
        t, u0_t,
        torch.as_tensor(pk.lower, device=dev),
        torch.as_tensor(pk.upper, device=dev),
        torch.as_tensor(pk.kind, device=dev),
        hashable_pmap(pk.pmap), mhz, max_iter=max_iter,
    )
    x_t = res.x_free[0].cpu().numpy()
    if bool(res.converged[0]) and np.isfinite(x_t).all():
        return x_t
    return pk.init_free


def seed_plan(pk: PriorKnowledge):
    """Static description of the per-voxel seeding writes.

    Returns ``(amp_slots, ls_plan)``: the free amplitude slots rescaled by
    each voxel's first-point magnitude, and ``(slot, peak, col, offset, lo,
    hi)`` entries — one per free untied amplitude (col 0) / phase (col 3)
    slot — that receive the linear LS seed.
    """
    amp_slots = tuple(
        int(pk.pmap.idx[k * 5])
        for k in range(pk.n_peaks)
        if pk.pmap.idx[k * 5] >= 0 and pk.pmap.scale[k * 5] == 1.0
    )
    plan = []
    staged: set[int] = set()
    for k in range(pk.n_peaks):
        for col in (0, 3):
            j = k * 5 + col
            slot = int(pk.pmap.idx[j])
            if slot < 0 or slot in staged or pk.pmap.scale[j] != 1.0:
                continue
            staged.add(slot)
            plan.append(
                (slot, k, col, float(pk.pmap.offset[j]),
                 float(pk.lower[slot]), float(pk.upper[slot]))
            )
    return amp_slots, tuple(plan)


def _ls_amp_phase_for_grid(y_re, y_im, grid, t, mhz):
    """Shared-basis linear LS of complex amplitudes against a (K, 5) grid.

    Returns ``(a_r, a_i, cost)`` with the coefficient planes shaped (K, B)
    and the per-voxel optimal residual cost ``||y||^2 - Re(N^H a)`` (B,).
    The matrix products are full fp32 ``torch.matmul``; the (2K, 2K) shared
    system is solved once for all voxels.
    """
    _, _, b_re, b_im = eq6_basis_planar(t, grid, mhz)  # (n_t, K)
    g_r = b_re.T @ b_re + b_im.T @ b_im
    g_i = b_re.T @ b_im - b_im.T @ b_re
    n_r = b_re.T @ y_re.T + b_im.T @ y_im.T
    n_i = b_re.T @ y_im.T - b_im.T @ y_re.T
    k = g_r.shape[0]
    ridge = 1e-8 * torch.trace(g_r) / k
    g_r = g_r + ridge * torch.eye(k, dtype=g_r.dtype, device=g_r.device)
    block = torch.cat(
        [torch.cat([g_r, -g_i], dim=1), torch.cat([g_i, g_r], dim=1)], dim=0
    )
    rhs = torch.cat([n_r, n_i], dim=0)  # (2K, B)
    sol = torch.linalg.solve(block, rhs)
    yy = (y_re * y_re + y_im * y_im).sum(1)
    cost = yy - (sol * rhs).sum(0)
    return sol[:k], sol[k:], cost


def _linear_seed_solve(y_re, y_im, x_t, t, pmap_static, mhz):
    """Per-voxel LS amplitudes and phases (degrees) at the template's
    shifts/linewidths/g, each (B, K)."""
    grid = expand_params(x_t, pmap_static).clone()
    grid[:, 0] = 1.0  # unit amplitude
    grid[:, 3] = 0.0  # zero phase
    a_r, a_i, _ = _ls_amp_phase_for_grid(y_re, y_im, grid, t, mhz)
    amp = torch.sqrt(a_r * a_r + a_i * a_i)
    phase = torch.atan2(a_i, a_r) * (180.0 / math.pi)
    return amp.T, phase.T


def _wrap_phase_window_torch(vals, lo: float, hi: float):
    """Map seeded phases (degrees) into the 360-degree window centred on
    the bound interval (half-bounded: the first period past the finite
    edge; unbounded: unchanged)."""
    if np.isfinite(lo) and np.isfinite(hi):
        c = 0.5 * (lo + hi)
        return c + torch.remainder(vals - c + 180.0, 360.0) - 180.0
    if np.isfinite(lo):
        return lo + torch.remainder(vals - lo, 360.0)
    if np.isfinite(hi):
        return hi - torch.remainder(hi - vals, 360.0)
    return vals


def _nudge_into_bounds_torch(vals, lo: float, hi: float):
    """Clip seeded values inside the bounds with the prior parser's off-edge
    margin (the bound transform has zero slope at the edge)."""
    if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
        m = 1e-3 * (hi - lo)
        return torch.clamp(vals, lo + m, hi - m)
    if np.isfinite(lo):
        return torch.clamp(vals, min=lo + max(1e-3, abs(lo) * 1e-3))
    if np.isfinite(hi):
        return torch.clamp(vals, max=hi - max(1e-3, abs(hi) * 1e-3))
    return vals


def seed_grid(re, im, t, x_template, lower, upper, kind, *, pmap_static,
              mhz: float, amp_slots: tuple, ls_plan: tuple):
    """Per-voxel initial INTERNAL parameters (B, F) of the grid fit.

    Every voxel starts from the template optimum; free amplitudes are
    rescaled by the voxel's first-point magnitude over the template total
    (clipped to [0.1, 100]); the ``ls_plan`` slots get the shared-basis LS
    amplitudes/phases (wrapped into the phase window, nudged inside the
    bounds; a non-finite LS value keeps the scaled template entry); then
    the bound transform.  Inputs are float32 planes (B, n_t).
    """
    b = re.shape[0]
    n_free = x_template.shape[-1]
    x0 = x_template[None, :].expand(b, n_free).clone()
    if amp_slots:
        slots = list(amp_slots)
        total = x_template[slots].abs().sum()
        y0_mag = torch.sqrt(re[:, 0] ** 2 + im[:, 0] ** 2)
        factor = torch.where(
            total > 0,
            torch.clamp(y0_mag / torch.clamp(total, min=1e-30), 0.1, 100.0),
            torch.ones_like(y0_mag),
        )
        x0[:, slots] = x0[:, slots] * factor[:, None]

    if ls_plan:
        amp, ph = _linear_seed_solve(re, im, x_template, t, pmap_static, mhz)
        for slot, k, col, offset, lo, hi in ls_plan:
            vals = (amp[:, k] if col == 0 else ph[:, k]) - offset
            if col == 3:
                vals = _wrap_phase_window_torch(vals, lo, hi)
            vals = _nudge_into_bounds_torch(vals, lo, hi)
            x0[:, slot] = torch.where(torch.isfinite(vals), vals, x0[:, slot])

    return external_to_internal_torch(
        x0, lower[None, :], upper[None, :], kind[None, :]
    ).to(torch.float32)


def seeded_fit_grid_raw(
    re,
    im,
    t,
    x_template,
    lower,
    upper,
    kind,
    *,
    pmap_static,
    mhz: float,
    amp_slots: tuple,
    ls_plan: tuple,
    max_iter: int = 24,
    lam0: float = 1e-3,
    kernel_version: int = 9,
    plateau_streak: int = 3,
    uniform_t_ok: bool = False,
    spd_pallas: bool = True,
    kernels: KernelSet = DISPATCH,
):
    """Whole-grid seeding + batched LM + CRLB (reference
    ``seeded_fit_grid_raw``, ``engine="pallas"`` slab path).

    :func:`seed_grid`, then the K2/K3 LM loop
    (:func:`~xmris_tpu_torch.fitting.lm.lm_fit_batched_slab`) and the K4
    CRLBs.  Returns ``(x_free, cost, converged, crlb_sds)``.
    """
    if not uses_slab_hessian(spd_pallas, kernel_version):
        raise NotImplementedError(
            "only kernel_version=9 with spd_pallas=True (the slab path) is "
            "ported; the other LM kernels are ROADMAP.md queue 2, K6-K14"
        )
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    t = t.to(torch.float32)
    x_template = x_template.to(torch.float32)
    u0 = seed_grid(
        re, im, t, x_template, lower, upper, kind, pmap_static=pmap_static,
        mhz=mhz, amp_slots=amp_slots, ls_plan=ls_plan,
    )
    res, h_slab = lm_fit_batched_slab(
        re, im, t, u0, lower, upper, kind, pmap_static, mhz,
        kernels=kernels, max_iter=max_iter, lam0=lam0,
        plateau_streak=plateau_streak, uniform_t_ok=uniform_t_ok,
    )
    sds, _ = crlb_from_hessian_slab(
        h_slab, res.cost, re.shape[-1], f=x_template.shape[-1],
        kernels=kernels,
    )
    return res.x_free, res.cost, res.converged, sds
