"""AMARES batch fitting: grid seeding, the seeded whole-grid fit and the
public :func:`fit_amares` (PyTorch port).

Port of :mod:`xmris_tpu.fitting.amares`: the highest-SNR template voxel
(:func:`select_template_planes` on a grid's planes where they lie,
:func:`select_template_fid` on a numpy array, :func:`template_optimum`),
the static seeding plans (:func:`seed_plan`, :func:`g_seed_plan`), the
shared-basis linear LS amplitude/phase seed and its scan over candidate g
values for a free-g prior (:func:`_linear_seed_scan_g`), one seeding on
the planes for both fits (:func:`seed_grid` and
:func:`template_seeded_x0`), :func:`seeded_fit_grid_raw` (amplitude
rescaling, the LS seed, the bound transform, the LM and the CRLBs for
every voxel of a grid, as one call), planes uploaded ahead of a fit
(:func:`stage_device_fids`), and :func:`fit_amares`, the labeled entry
point that returns an :class:`~xmris_tpu_torch.core.array.XmrDataset` with
the reference's variables, dims, coords and attrs.
"""

from __future__ import annotations

import functools
import math
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from xmris_tpu_torch import __version__ as _version
from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset
from xmris_tpu_torch.core.utils import card_device, complex_planes
from xmris_tpu_torch.fitting.lm import (
    LMResult,
    _lm_fit_batched_pallas_impl,
    auto_varpro,
    check_kernel_version,
    crlb_batched_planar,
    crlb_from_hessian,
    crlb_from_hessian_slab,
    eq6_basis_planar,
    expand_params,
    external_to_internal,
    external_to_internal_torch,
    hashable_pmap,
    lm_fit_batched_pallas,
    lm_fit_batched_planar,
    uses_slab_hessian,
)
from xmris_tpu_torch.fitting.prior import PriorKnowledge, load_prior_knowledge
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.runtime.profiling import (
    count,
    span,
    spanned,
    to_card,
    to_host,
)


def select_template_fid(fid_arrs: np.ndarray, announce: bool = True) -> int:
    """Index of the highest-SNR FID of a numpy (B, n_t) array:
    :func:`select_template_planes` on CPU tensors of its planes."""
    return select_template_planes(*complex_planes(fid_arrs, "cpu"),
                                  announce=announce)[0]


def select_template_planes(re, im, announce: bool = True) -> tuple[int, float]:
    """The highest-SNR voxel of a grid's ``(re, im)`` planes, (B, n_t),
    where they lie: signal = mean |first 10 points|, noise = the
    population std of the complex last ``max(10, n_t // 5)`` points, SNR 0
    where the noise is 0, NaN SNRs skipped (an all-NaN grid raises
    ``ValueError`` as ``np.nanargmax`` does), the first of equal maxima.
    Computed in float64 over those columns only; the index and its SNR come
    to the host in one read.  Returns ``(index, snr)``."""
    n_time = re.shape[-1]
    noise_pts = max(10, n_time // 5)
    f64 = torch.float64
    s_re, s_im = re[:, 0:10].to(f64), im[:, 0:10].to(f64)
    signal = torch.sqrt(s_re * s_re + s_im * s_im).mean(1)
    n_re, n_im = re[:, -noise_pts:].to(f64), im[:, -noise_pts:].to(f64)
    d_re = n_re - n_re.mean(1, keepdim=True)
    d_im = n_im - n_im.mean(1, keepdim=True)
    noise = torch.sqrt((d_re * d_re + d_im * d_im).mean(1))
    snr = torch.where(noise == 0, torch.zeros_like(signal), signal / noise)
    best = torch.argmax(torch.where(torch.isnan(snr), -math.inf, snr))
    best_idx, best_snr = to_host(torch.stack([best.to(f64), snr[best]])).tolist()
    if math.isnan(best_snr):
        raise ValueError("All-NaN slice encountered")
    best_idx = int(best_idx)
    if announce:
        print(
            f"Auto-selected FID index {best_idx} for initialization "
            f"(SNR: {best_snr:.2f})"
        )
    return best_idx, best_snr


def template_optimum(
    fid_arrs: np.ndarray,
    pk: PriorKnowledge,
    t,
    mhz: float,
    template_fid: np.ndarray | torch.Tensor | None = None,
    max_iter: int = 60,
    verbose: bool = False,
) -> np.ndarray:
    """Fit the (auto-selected) highest-SNR voxel once with the pure-tensor
    LM and return its free-parameter optimum, the template every voxel's
    seed starts from.  Falls back to the prior's initial values when the
    template fit fails.  ``t`` is the (n_t,) time axis tensor; the fit runs
    on its device, in the template FID's precision.  ``template_fid`` may
    be a tensor (a row of the grid where it lies), else numpy; without it
    the template is :func:`select_template_fid`'s voxel of the numpy
    ``fid_arrs``."""
    if template_fid is None:
        template_fid = fid_arrs[select_template_fid(fid_arrs, announce=False)]
    dev = t.device
    z = (template_fid.detach() if isinstance(template_fid, torch.Tensor)
         else np.asarray(template_fid))
    re_t, im_t = complex_planes(z.reshape(1, -1), dev)
    u0_t = to_card(
        external_to_internal(pk.init_free[None, :], pk.lower, pk.upper, pk.kind),
        dev,
    )
    res = lm_fit_batched_planar(
        re_t, im_t, t, u0_t,
        to_card(pk.lower, dev), to_card(pk.upper, dev), to_card(pk.kind, dev),
        hashable_pmap(pk.pmap), mhz, max_iter=max_iter,
    )
    x_t, converged = _read_together((res.x_free, res.converged))
    if converged[0] and np.isfinite(x_t[0]).all():
        if verbose:
            print(f"Template fit converged (cost {to_host(res.cost[0]):.3e}); "
                  "seeding grid.")
        return x_t[0]
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


def _linear_seed_scan_g(y_re, y_im, x_t, t, pmap_static, mhz, g_values):
    """Per-voxel lineshape-mixing seed (reference ``_linear_seed_scan_g``):
    the shared-basis LS amplitudes/phases at the template's shifts and
    linewidths for each candidate g of ``g_values`` in turn (one shared
    (2K, 2K) solve each; peaks whose g the prior fixes keep the template
    value), then each voxel's argmin-cost candidate, ties to the first.

    Returns ``(amp, phase_deg, g_best, best_cost)``: (B, K), (B, K), (B,),
    (B,).
    """
    base = expand_params(x_t, pmap_static).clone()
    base[:, 0] = 1.0  # unit amplitude
    base[:, 3] = 0.0  # zero phase
    idx, n_peaks = pmap_static[0], pmap_static[3]
    free_g = torch.as_tensor([idx[k * 5 + 4] >= 0 for k in range(n_peaks)],
                             device=base.device)
    sols = []
    for g_cand in g_values:
        grid = base.clone()
        grid[:, 4] = torch.where(
            free_g, torch.full_like(base[:, 4], float(g_cand)), base[:, 4])
        sols.append(_ls_amp_phase_for_grid(y_re, y_im, grid, t, mhz))
    costs = torch.stack([c for _, _, c in sols])  # (C, B)
    best = torch.argmin(costs, dim=0)  # the first of equal costs

    def gather(planes):  # (C, K, B) -> (B, K) at each voxel's candidate
        st = torch.stack(planes).permute(2, 0, 1)
        return st.gather(1, best[:, None, None].expand(-1, 1, st.shape[2]))[:, 0]

    a_r = gather([a for a, _, _ in sols])
    a_i = gather([a for _, a, _ in sols])
    amp = torch.sqrt(a_r * a_r + a_i * a_i)
    phase = torch.atan2(a_i, a_r) * (180.0 / math.pi)
    g_best = torch.as_tensor(g_values, dtype=base.dtype, device=base.device)[best]
    return amp, phase, g_best, costs.min(dim=0).values


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


def _scaled_template_seed(y0_re, y0_im, x_template, amp_slots: tuple):
    """``x_template`` broadcast to (B, F), its free amplitude slots scaled
    by each voxel's first-point magnitude ``|y0|`` over the template total
    (clipped to [0.1, 100]; unscaled when that total is not positive).
    Works where the first points lie, in ``x_template``'s dtype."""
    b = y0_re.shape[0]
    n_free = x_template.shape[-1]
    x0 = x_template[None, :].expand(b, n_free).clone()
    if amp_slots:
        slots = list(amp_slots)
        total = x_template[slots].abs().sum()
        y0_mag = torch.sqrt(y0_re ** 2 + y0_im ** 2)
        factor = torch.where(
            total > 0,
            torch.clamp(y0_mag / torch.clamp(total, min=1e-30), 0.1, 100.0),
            torch.ones_like(y0_mag),
        )
        x0[:, slots] = x0[:, slots] * factor[:, None]
    return x0


def _linear_seed_writes(x0, re, im, x_template, t, *, pmap_static,
                        mhz: float, ls_plan: tuple, g_scan: tuple = (),
                        g_plan: tuple = ()):
    """Write the linear seed into ``x0`` (B, F) in place and return it.

    With ``g_scan`` candidates and a ``g_plan`` (:func:`g_seed_plan`), the
    g scan (:func:`_linear_seed_scan_g`) seeds every free g slot with each
    voxel's winning candidate and supplies the matching amplitudes/phases,
    whatever ``ls_plan`` holds; otherwise the shared-basis LS at the
    template's g does.  The ``ls_plan`` slots get those amplitudes/phases,
    wrapped into the phase window and nudged inside the bounds; a
    non-finite value keeps the entry.  The solves run on ``re``/``im``,
    ``x_template`` and ``t`` in their dtype, where they lie.
    """

    def put(slot, vals):
        x0[:, slot] = torch.where(torch.isfinite(vals), vals, x0[:, slot])

    amp = ph = None
    if g_scan and g_plan:
        amp, ph, g_best, _ = _linear_seed_scan_g(
            re, im, x_template, t, pmap_static, mhz, g_scan)
        for slot, offset, lo, hi in g_plan:
            put(slot, _nudge_into_bounds_torch(g_best - offset, lo, hi))
    elif ls_plan:
        amp, ph = _linear_seed_solve(re, im, x_template, t, pmap_static, mhz)
    if amp is not None:
        for slot, k, col, offset, lo, hi in ls_plan:
            vals = (amp[:, k] if col == 0 else ph[:, k]) - offset
            if col == 3:
                vals = _wrap_phase_window_torch(vals, lo, hi)
            put(slot, _nudge_into_bounds_torch(vals, lo, hi))
    return x0


def seed_grid(re, im, t, x_template, lower, upper, kind, *, pmap_static,
              mhz: float, amp_slots: tuple, ls_plan: tuple,
              g_scan: tuple = (), g_plan: tuple = ()):
    """Per-voxel initial INTERNAL parameters (B, F) of the grid fit: the
    scaled template seed (:func:`_scaled_template_seed`), the linear seed
    (:func:`_linear_seed_writes`, the g scan with ``g_scan`` and a
    ``g_plan``), then the bound transform.  Inputs are float32 planes
    (B, n_t)."""
    x0 = _scaled_template_seed(re[:, 0], im[:, 0], x_template, amp_slots)
    x0 = _linear_seed_writes(x0, re, im, x_template, t,
                             pmap_static=pmap_static, mhz=mhz,
                             ls_plan=ls_plan, g_scan=g_scan, g_plan=g_plan)
    return external_to_internal_torch(
        x0, lower[None, :], upper[None, :], kind[None, :]
    ).to(torch.float32)


@spanned("fit")
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
    engine: str = "pallas",
    g_scan: tuple = (),
    g_plan: tuple = (),
    spd_pallas: bool = True,
    kernels: KernelSet = DISPATCH,
):
    """Whole-grid seeding + batched LM + CRLB (reference
    ``seeded_fit_grid_raw``).

    :func:`seed_grid` (with the g scan when ``g_scan`` and ``g_plan`` are
    given), then, with ``engine="pallas"``, the kernel LM that
    ``kernel_version`` and ``spd_pallas`` select (the driver of
    :func:`~xmris_tpu_torch.fitting.lm.lm_fit_batched_pallas`, with the
    VARPRO override on for a free-g prior) and the CRLBs from its Hessian:
    on the slab path (v9 with ``spd_pallas``) K4 on the slab, otherwise
    :func:`crlb_from_hessian` on the dense Hessian (K6b, or the plain
    inverse diagonal without ``spd_pallas``).  Any other ``engine`` runs
    the pure-tensor :func:`lm_fit_batched_planar` and
    :func:`crlb_batched_planar`, as the reference's ``"xla"``.  Returns
    ``(x_free, cost, converged, crlb_sds)``.
    """
    check_kernel_version(kernel_version)
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    t = t.to(torch.float32)
    x_template = x_template.to(torch.float32)
    with span("fit.seed"):
        u0 = seed_grid(
            re, im, t, x_template, lower, upper, kind,
            pmap_static=pmap_static, mhz=mhz, amp_slots=amp_slots,
            ls_plan=ls_plan, g_scan=g_scan, g_plan=g_plan,
        )
    if engine != "pallas":
        with span("fit.lm"):
            res = lm_fit_batched_planar(re, im, t, u0, lower, upper, kind,
                                        pmap_static, mhz, max_iter=max_iter)
        with span("fit.crlb"):
            sds, _ = crlb_batched_planar(re, im, t, res.x_free, pmap_static,
                                         mhz)
        return res.x_free, res.cost, res.converged, sds
    slab = uses_slab_hessian(spd_pallas, kernel_version)
    with span("fit.lm"):
        res, h = _lm_fit_batched_pallas_impl(
            re, im, t, u0, lower, upper, kind, pmap_static, mhz,
            kernels=kernels, max_iter=max_iter, lam0=lam0, ftol=1e-10,
            kernel_version=kernel_version,
            return_hessian="slab" if slab else True,
            uniform_t_ok=uniform_t_ok, plateau_streak=plateau_streak,
            varpro=auto_varpro(pmap_static), spd_pallas=spd_pallas,
        )
    with span("fit.crlb"):
        if slab:
            sds, _ = crlb_from_hessian_slab(
                h, res.cost, re.shape[-1], f=x_template.shape[-1],
                kernels=kernels,
            )
        else:
            sds, _ = crlb_from_hessian(h, res.cost, re.shape[-1],
                                       use_pallas=spd_pallas, kernels=kernels)
    return res.x_free, res.cost, res.converged, sds


# ---------------------------------------------------------------------------
# The public fit
# ---------------------------------------------------------------------------


def g_seed_plan(pk: PriorKnowledge):
    """``(slot, offset, lo, hi)`` per distinct free untied (scale == 1) g
    slot; empty when the prior fixes every g."""
    plan = []
    seen: set[int] = set()
    for k in range(pk.n_peaks):
        j = k * 5 + 4
        slot = int(pk.pmap.idx[j])
        if slot < 0 or slot in seen or pk.pmap.scale[j] != 1.0:
            continue
        seen.add(slot)
        plan.append((slot, float(pk.pmap.offset[j]), float(pk.lower[slot]),
                     float(pk.upper[slot])))
    return tuple(plan)


def _flatten_to_spectra(da: XmrArray, dim: str):
    """Time-last transpose + row-major flatten to ``(n_spectra, n_time)``,
    with the voxel shape and the other dims: a tensor payload stays a
    tensor on its device (a view where its layout allows), anything else
    becomes numpy."""
    if dim not in da.dims:
        raise ValueError(f"Dimension '{dim}' missing in DataArray.")
    other_dims = [d for d in da.dims if d != dim]
    da_t = da.transpose(*(other_dims + [dim]))
    n_time = da.sizes[dim]
    data = da_t.data
    if isinstance(data, torch.Tensor):
        fids = data.detach().reshape(-1, n_time)
    else:
        fids = np.asarray(data).reshape(-1, n_time)
    return fids, tuple(da_t.shape[:-1]), other_dims


class StagedFids(NamedTuple):
    """A grid's planes uploaded ahead of its fit (:func:`stage_device_fids`).

    ``re``/``im`` sit at indices 0/1 like a plain ``(re, im)`` pair;
    ``dims``/``shape`` record the time-last layout they were staged in, so
    that :func:`fit_amares` rejects planes staged along another ``dim``;
    ``ready`` is the CUDA event the upload recorded (``None`` on the CPU),
    which a consumer waits on before the first use.
    """

    re: torch.Tensor
    im: torch.Tensor
    dims: tuple = ()
    shape: tuple = ()
    ready: object = None


def _check_staged(device_fids, expected, layout, dim):
    """The reference's checks of ``device_fids`` against a fit's flattening:
    the planes' shapes, and a :class:`StagedFids`' staged layout."""
    shapes = tuple(tuple(p.shape) for p in device_fids[:2])
    if shapes != (expected, expected):
        raise ValueError(
            f"device_fids planes have shapes {shapes[0]} / {shapes[1]}, "
            f"expected {expected}; stage them with stage_device_fids(da, "
            f"dim={dim!r}).")
    staged = (getattr(device_fids, "dims", ()), getattr(device_fids, "shape", ()))
    if staged[0] and staged != layout:
        raise ValueError(
            f"device_fids were staged for layout dims={staged[0]} "
            f"shape={staged[1]}, but this fit flattens to dims={layout[0]} "
            f"shape={layout[1]}; stage them with stage_device_fids(da, "
            f"dim={dim!r}) on the same array.")


def _stage_planes(fids, device):
    """``(re, im, ready)``: from the host to a CUDA device the complex
    array goes from pinned memory to the card with ``non_blocking`` copies
    on a side stream, split there into planes allocated on the current
    stream, and ``ready`` is the event recorded after the split; a tensor
    already on a card, or a CPU ``device``, gets :func:`complex_planes`
    (no copy for a tensor on ``device``) and ``None``."""
    device = torch.device(device)
    on_host = not isinstance(fids, torch.Tensor) or fids.device.type == "cpu"
    if device.type != "cuda" or not on_host:
        return (*complex_planes(fids, device), None)
    host = (fids if isinstance(fids, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(fids)))
    host = host.contiguous().pin_memory()
    real = torch.float64 if host.dtype in (torch.complex128, torch.float64) \
        else torch.float32
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    buf = torch.empty(host.shape, dtype=host.dtype, device=device)
    re = torch.empty(host.shape, dtype=real, device=device)
    im = torch.empty(host.shape, dtype=real, device=device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        buf.copy_(host, non_blocking=True)
        if buf.is_complex():
            re.copy_(buf.real)
            im.copy_(buf.imag)
        else:
            re.copy_(buf)
            im.zero_()
        ready = torch.cuda.Event()
        ready.record(side)
    for x in (buf, re, im):
        x.record_stream(side)
    return re, im, ready


def _wait_staged(device_fids):
    """Make the current stream wait for a staged upload's event."""
    ready = getattr(device_fids, "ready", None)
    if ready is not None:
        torch.cuda.current_stream(device_fids[0].device).wait_event(ready)


def stage_device_fids(da: XmrArray, dim: str = "time", device="cuda"):
    """Upload a grid's planes for ``fit_amares(device_fids=...)`` (reference
    ``stage_device_fids``): flattened as :func:`fit_amares` flattens the
    grid (time-last transpose, row-major voxels), on ``device`` (the card
    unless the caller passes ``"cpu"``).  From the host the upload to the
    card is asynchronous (:func:`_stage_planes`); the consuming fit waits
    for it.  A tensor payload on ``device`` is split where it lies.
    Returns a :class:`StagedFids` tagged with the staged layout."""
    fids, voxel_shape, other_dims = _flatten_to_spectra(da, dim)
    re, im, ready = _stage_planes(fids, device)
    return StagedFids(re, im, dims=tuple(other_dims) + (dim,),
                      shape=tuple(voxel_shape) + (fids.shape[1],),
                      ready=ready)


def _template_seed_x0(re_all, im_all, pk: PriorKnowledge, t, mhz: float,
                      template_fid, *, fit_template: bool,
                      scale_amplitudes: bool, max_iter: int, verbose: bool,
                      linear_seed: bool, g_scan) -> torch.Tensor:
    """:func:`template_seeded_x0` on the grid's planes where they lie: the
    external x0 (B, F), a float64 tensor on their device."""
    x_template = pk.init_free
    if fit_template:
        if template_fid is None:
            idx, _ = select_template_planes(re_all, im_all, announce=False)
            template_fid = torch.complex(re_all[idx], im_all[idx])
        x_template = template_optimum(
            None, pk, t, mhz, template_fid=template_fid,
            max_iter=max_iter, verbose=verbose,
        )
    dev = re_all.device
    x_t = to_card(np.asarray(x_template, np.float64), dev)
    amp_slots, ls_plan = seed_plan(pk)
    x0 = _scaled_template_seed(
        re_all[:, 0].to(torch.float64), im_all[:, 0].to(torch.float64), x_t,
        amp_slots if scale_amplitudes else ())
    if not linear_seed:
        return x0
    if isinstance(g_scan, str):
        raise TypeError(
            "g_scan must be a tuple of candidate mixing fractions or None; "
            "the 'auto' policy is resolved by fit_amares, not here")
    f32 = torch.float32
    try:  # into a copy: a write that fails midway leaves x0 whole
        return _linear_seed_writes(
            x0.clone(), re_all.to(f32), im_all.to(f32), x_t.to(f32),
            t.to(f32), pmap_static=hashable_pmap(pk.pmap), mhz=float(mhz),
            ls_plan=ls_plan, g_scan=tuple(float(g) for g in g_scan or ()),
            g_plan=g_seed_plan(pk))
    except Exception as exc:
        warnings.warn(
            f"linear seed skipped ({exc!r}); using template seed",
            RuntimeWarning,
            stacklevel=3,
        )
    return x0


def template_seeded_x0(
    fid_arrs: np.ndarray | None,
    pk: PriorKnowledge,
    t,
    mhz: float,
    template_fid: np.ndarray | None = None,
    fit_template: bool = True,
    scale_amplitudes: bool = True,
    max_iter: int = 60,
    verbose: bool = False,
    linear_seed: bool = True,
    g_scan: tuple | None = None,
    device_fids: tuple | None = None,
) -> np.ndarray:
    """Per-voxel initial values (B, n_free) seeded from a template-voxel fit
    (reference ``template_seeded_x0``): :func:`seed_grid`'s seed before
    the bound transform, in float64 where the planes lie, read to the host
    once.

    ``template_fid`` (default: :func:`select_template_planes`' voxel) is
    fitted once unless ``fit_template`` is off; ``scale_amplitudes`` turns
    the amplitude scaling on, ``linear_seed`` the linear seed, with the g
    scan over ``g_scan``, a tuple of candidate mixing fractions (a string
    raises ``TypeError``: ``"auto"`` is :func:`fit_amares`'s).  A linear
    seed that fails warns (``RuntimeWarning``) and leaves the scaled
    template seed.  ``t`` is the time-axis tensor, the device of the work;
    the planes are ``device_fids`` when the caller holds them (``fid_arrs``
    may then be None), else one upload of ``fid_arrs``.
    """
    if device_fids is None:
        device_fids = complex_planes(fid_arrs, t.device)
    _wait_staged(device_fids)
    x0 = _template_seed_x0(
        device_fids[0], device_fids[1], pk, t, mhz, template_fid,
        fit_template=fit_template, scale_amplitudes=scale_amplitudes,
        max_iter=max_iter, verbose=verbose, linear_seed=linear_seed,
        g_scan=g_scan)
    return to_host(x0).numpy()


def _read_together(tensors):
    """(B, ...) tensors of one device to numpy in ONE host read, in their
    widest dtype (which holds the narrower floats and the flags exactly),
    each back in its own."""
    cols = [a.reshape(a.shape[0], -1) for a in tensors]
    wide = functools.reduce(torch.promote_types, (a.dtype for a in tensors))
    host = to_host(torch.cat([c.to(wide) for c in cols], 1))
    edges = np.cumsum([0] + [c.shape[1] for c in cols])
    return [host[:, i:j].reshape(a.shape).to(a.dtype).numpy()
            for a, i, j in zip(tensors, edges[:-1], edges[1:])]


def _reconstruct_batch(xs, t, pmap_static, mhz: float):
    """The Eq.6 model of free vectors ``xs`` (B, F), complex numpy (B, n_t)."""
    m_re, m_im, _, _ = eq6_basis_planar(
        t, expand_params(xs.to(t.device), pmap_static), mhz)
    return to_host(m_re).numpy() + 1j * to_host(m_im).numpy()


def _resolve_mesh(mesh, dev: torch.device):
    """The reference's normalization of ``fit_amares(mesh=)`` to a 1-D
    :class:`~xmris_tpu_torch.parallel.mesh.Mesh` or None: ``"auto"`` is
    every CUDA device when there are several and the fit runs on the card
    (else no mesh), an int is :func:`make_mesh` of that many devices of
    ``dev``'s kind; a bad string, any other object and a mesh of more than
    one axis raise ``ValueError``."""
    from xmris_tpu_torch.parallel.mesh import Mesh, make_mesh

    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(
                f"mesh={mesh!r}: expected a Mesh, a device count, 'auto', "
                "or None.")
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = n if n > 1 else None
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        mesh = make_mesh(mesh, device=dev.type)
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise ValueError(
            f"mesh={mesh!r}: expected a Mesh, a device count, 'auto', or None.")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}; fit_amares shards the voxel "
            "batch over a 1-D mesh: pass make_mesh(n) or a single-axis Mesh.")
    return mesh


@spanned("fit_amares")
def fit_amares(
    da: XmrArray,
    prior_knowledge_file: str | Path | PriorKnowledge,
    dim: str = "time",
    mhz: float | None = None,
    sw: float | None = None,
    deadtime: float | None = None,
    method: str = "leastsq",
    initialize_with_lm: bool = True,
    num_workers: int = 4,
    init_fid: np.ndarray | None = None,
    verbose: bool = False,
    max_iter: int = 60,
    chunk_size: int | None = None,
    engine: str = "auto",
    scale_init_amplitudes: bool = True,
    kernel_version: int = 9,
    g_scan: tuple | str | None = "auto",
    return_curves: bool = True,
    device_fids: tuple | None = None,
    mesh=None,
    device="cuda",
    kernels: KernelSet = DISPATCH,
) -> XmrDataset:
    """Fit the AMARES Eq.6 model to every voxel of an N-D FID array.

    Parameters mirror the reference's ``fit_amares``; ``num_workers`` is
    accepted and ignored (the device batch is the parallelism).  The fit
    infers ``mhz`` (``attrs["MHz"]``), ``sw`` and ``deadtime`` from the
    time coordinate, flattens the grid, fits the template FID (``init_fid``
    or the highest-SNR voxel) with the pure-tensor LM, seeds every voxel
    from it (:func:`template_seeded_x0`), runs the batched LM and, with
    ``initialize_with_lm``, a refinement pass from each voxel's own
    solution, keeping the lower cost per voxel.  CRLBs, CRLB % of the
    amplitude, SNR and the failure masking (non-converged voxels keep
    zeros) follow the reference, and so does the returned dataset:
    ``raw_data``/``fit_data``/``residuals`` over the original dims (unless
    ``return_curves=False``), ``amplitude``/``chem_shift``/``linewidth``/
    ``phase``/``crlb``/``snr`` over the voxel dims x ``Metabolite``, and
    ``fit_converged``.

    It runs on ``device``: the card unless the caller passes ``"cpu"``.
    ``engine`` maps one to one onto the reference's: ``"pallas"`` runs the
    hand-written kernels (``kernel_version`` 9: K2 normal equations and K3
    damped SPD solve per LM iteration; 1, 2, 3, 5, 6, 7 or 8: K14, K13, K7,
    K12, K11, K10 or K9 (resolved as the LM driver resolves them) and K6a;
    10: the whole fit in one K8 launch; the CRLB diagonal through K6b),
    ``"xla"``
    the pure-tensor planar LM with CRLBs from the analytic Jacobian,
    ``"auto"`` the kernels
    on a CUDA device and the pure-tensor LM on the CPU.  ``chunk_size=None``
    fits the whole grid in one batch on the kernel engine and in chunks of
    4096 on the tensor engine.  ``kernels`` selects the kernel wrappers
    (default) or their plain versions.

    ``g_scan`` seeds a free g per voxel (:func:`_linear_seed_scan_g`):
    ``"auto"`` scans (0.0, 0.2, 0.4, 0.6, 0.8) when the prior leaves a g
    free and is a no-op otherwise, a tuple gives the candidates, ``None``
    turns the scan off.  A free-g prior's LM runs with the VARPRO override
    (:func:`~xmris_tpu_torch.fitting.lm.lm_fit_batched_pallas`), so
    ``kernel_version`` 10 then runs the v9 loop.

    The grid becomes (re, im) planes on ``device`` once, at the start:
    a tensor payload is split where it lies (no copy when it is on
    ``device``), a numpy one is uploaded once.  The template scan
    (:func:`select_template_planes`), the seed and the fit read those
    planes; the grid comes back to the host only for ``raw_data`` and
    ``residuals`` (``return_curves=True``, a CUDA payload: one copy).
    The seeds, both LM passes and the CRLBs stay on ``device``; a chunk's
    parameters, convergence flags, CRLB SDs and noise variance come to
    the host in one read, at the pack.
    ``device_fids`` takes the grid's planes uploaded ahead of the call by
    :func:`stage_device_fids` on the same array and ``dim`` (or a plain
    ``(re, im)`` pair): their shapes, and a :class:`StagedFids`' layout,
    must be this call's.  The call and its stages are spans of
    :mod:`~xmris_tpu_torch.runtime.profiling` (``fit_amares`` and
    ``fit_amares.ingest``, ``.seed``, ``.fit``, ``.crlb_model``,
    ``.pack``), recorded under a profiler or inside
    :func:`~xmris_tpu_torch.runtime.profiling.recording`; counter
    ``fit_amares.resident`` adds 1 for a call that copies the grid neither
    way: its planes come from a tensor payload or staged planes on
    ``device``, and no curves come back from a card.

    ``mesh`` splits the voxel axis of each chunk over a 1-D
    :class:`~xmris_tpu_torch.parallel.mesh.Mesh` (a device count, a mesh,
    or ``"auto"``: every CUDA device when there are several, else none;
    :func:`_resolve_mesh`): the chunk is edge-padded to a multiple of the
    mesh size, each shard fitted on its device (a host thread per device)
    (:func:`~xmris_tpu_torch.parallel.fit.lm_fit_batched_pallas_sharded`:
    K2 + K3 per shard; the tensor engine's LM likewise), the results
    gathered on the mesh's first device and trimmed, and the CRLBs taken
    there from the gathered (B, F, F) Hessian (K6b).  Staged
    ``device_fids`` split onto the shards the same way.
    """
    if dim not in da.dims:
        raise ValueError(f"Dimension '{dim}' missing in DataArray.")
    dev = card_device(device, "fit_amares")
    mesh = _resolve_mesh(mesh, dev)
    if mesh is not None:
        from xmris_tpu_torch.parallel.fit import lm_fit_batched_pallas_sharded
        from xmris_tpu_torch.parallel.mesh import (
            edge_pad_rows,
            map_shards,
            pad_to_multiple,
        )

    # 1. Physical parameter inference.
    with span("fit_amares.ingest"):
        if mhz is None:
            mhz = da.attrs.get("MHz")
            if mhz is None:
                raise ValueError("mhz must be provided or present in da.attrs['MHz']")
        mhz = float(mhz)
        t_coords = da.coords[dim].values.astype(np.float64)
        if sw is None:
            sw = 1.0 / float(t_coords[1] - t_coords[0])
        if deadtime is None:
            deadtime = float(t_coords[0])

        # 2. Flatten N-D -> (n_spectra, n_time), a tensor where it lies.
        fids, voxel_shape, other_dims = _flatten_to_spectra(da, dim)
        n_spectra, n_time = fids.shape

        # The planes on the fit's device, shared by the template scan, the
        # seed and the fit: the caller's staged ones, or the payload split
        # where it lies, or ONE upload.  ``moved``: this call copies the
        # grid.
        if device_fids is not None:
            _check_staged(device_fids, (n_spectra, n_time),
                          (tuple(other_dims) + (dim,),
                           tuple(voxel_shape) + (n_time,)), dim)
            _wait_staged(device_fids)
            re_all, im_all = (p.to(dev) for p in device_fids[:2])
            moved = re_all.device != device_fids[0].device
        else:
            re_all, im_all = complex_planes(fids, dev)
            moved = not (isinstance(fids, torch.Tensor)
                         and fids.device == re_all.device)

        # 3. The template FID: the caller's or the highest-SNR voxel.
        if init_fid is not None:
            template_fid = np.asarray(init_fid).reshape(-1)
            if template_fid.shape[0] != n_time:
                raise ValueError(
                    f"init_fid has {template_fid.shape[0]} points, expected {n_time}."
                )
        else:
            idx, _ = select_template_planes(re_all, im_all)
            template_fid = torch.complex(re_all[idx], im_all[idx])

    # 4. Prior knowledge.
    with span("fit_amares.seed"):
        pk = (
            prior_knowledge_file
            if isinstance(prior_knowledge_file, PriorKnowledge)
            else load_prior_knowledge(prior_knowledge_file)
        )
        pmap_static = hashable_pmap(pk.pmap)
        if engine == "auto":
            engine = "pallas" if dev.type == "cuda" else "xla"
        if engine not in ("pallas", "xla"):
            raise ValueError(f"engine must be 'auto', 'pallas' or 'xla', got {engine!r}")

        timeaxis = np.arange(n_time, dtype=np.float64) * (1.0 / sw) + deadtime
        t = to_card(timeaxis, dev)
        lower = to_card(pk.lower, dev)
        upper = to_card(pk.upper, dev)
        kind = to_card(pk.kind, dev)

        if g_scan == "auto":
            g_scan = (0.0, 0.2, 0.4, 0.6, 0.8) if g_seed_plan(pk) else None
        x0 = _template_seed_x0(
            re_all, im_all, pk, t, mhz, template_fid,
            fit_template=initialize_with_lm,
            scale_amplitudes=scale_init_amplitudes, max_iter=max_iter,
            verbose=verbose, linear_seed=True, g_scan=g_scan)
        u0 = external_to_internal_torch(x0, lower, upper, kind)

    # 5. Batched bounded LM over voxel chunks.
    if chunk_size is None:
        chunk_size = n_spectra if engine == "pallas" else 4096

    def run_lm(re_c, im_c, u_init):
        """(LMResult, dense external Hessian or None).  With a mesh the
        chunk is edge-padded to a multiple of its size, fitted sharded and
        trimmed: the pad voxels are copies whose results are dropped."""
        b = re_c.shape[0]
        if mesh is not None:
            n_pad = pad_to_multiple(b, mesh.size)
            re_c, im_c, u_init = (edge_pad_rows(a, n_pad)
                                  for a in (re_c, im_c, u_init))
        if engine == "pallas":
            if mesh is not None:
                res, h = lm_fit_batched_pallas_sharded(
                    re_c, im_c, t, u_init, lower, upper, kind, pmap_static,
                    mhz, mesh=mesh, axis_name=mesh.axis_names[0],
                    max_iter=max_iter, kernel_version=kernel_version,
                    return_hessian=True, kernels=kernels)
                return LMResult(*(f[:b] for f in res)), h[:b]
            return lm_fit_batched_pallas(
                re_c, im_c, t, u_init, lower, upper, kind, pmap_static, mhz,
                max_iter=max_iter, kernel_version=kernel_version,
                return_hessian=True, kernels=kernels,
            )

        def planar(re_s, im_s, u_s, t, lower, upper, kind):
            return lm_fit_batched_planar(
                re_s, im_s, t, u_s, lower, upper, kind, pmap_static, mhz,
                max_iter=max_iter)

        if mesh is None:
            return planar(re_c, im_c, u_init, t, lower, upper, kind), None
        res = map_shards(planar, mesh, (re_c, im_c, u_init),
                         (t, lower, upper, kind), mesh.axis_names[0])
        return LMResult(*(f[:b] for f in res)), None

    with span("fit_amares.fit"):
        t_before = time.perf_counter()
        x_parts, conv_parts, h_parts, cost_parts = [], [], [], []
        for start in range(0, n_spectra, chunk_size):
            rows = slice(start, start + chunk_size)
            re_c, im_c = re_all[rows], im_all[rows]
            res, h_pick = run_lm(re_c, im_c, u0[rows])
            x, cost_pick, conv = res.x_free, res.cost, res.converged
            if initialize_with_lm:
                # Refinement pass from each voxel's own optimum with a fresh
                # damping schedule; keep the better solution per voxel.
                u_refined = external_to_internal_torch(
                    x.to(torch.float64),
                    *(a.to(x.device) for a in (lower, upper, kind)))
                res2, h2 = run_lm(re_c, im_c, u_refined)
                better = res2.cost < res.cost
                x = torch.where(better[:, None], res2.x_free, x)
                cost_pick = torch.where(better, res2.cost, res.cost)
                if h_pick is not None:
                    h_pick = torch.where(better[:, None, None], h2, h_pick)
                conv = res.converged | res2.converged
            x_parts.append(x)
            conv_parts.append(conv)
            cost_parts.append(cost_pick)
            if h_pick is not None:
                h_parts.append(h_pick)

        print(f"Fitting {n_spectra} spectra with batched device LM took "
              f"{time.perf_counter() - t_before:.2f} seconds.")

    # 6. Physical parameters, CRLBs, reconstructed fits.
    with span("fit_amares.crlb_model"):
        sds_parts, sigma_parts, fit_parts = [], [], []
        for ci, start in enumerate(range(0, n_spectra, chunk_size)):
            rows = slice(start, start + chunk_size)
            if h_parts:
                # The LM returned the GN Hessian (the Fisher information) at
                # each voxel's chosen optimum: no extra model evaluation.
                sds, sigma2 = crlb_from_hessian(h_parts[ci], cost_parts[ci],
                                                n_time, kernels=kernels)
            else:
                sds, sigma2 = crlb_batched_planar(re_all[rows], im_all[rows], t,
                                                  x_parts[ci], pmap_static, mhz)
            sds_parts.append(sds)
            sigma_parts.append(sigma2)
            if return_curves:
                fit_parts.append(_reconstruct_batch(x_parts[ci], t, pmap_static,
                                                    mhz))
        fit_data = np.concatenate(fit_parts, axis=0) if return_curves else None

    with span("fit_amares.pack"):
        # A chunk's x, convergence, CRLB SDs and sigma^2: ONE host read.
        host = [_read_together(parts) for parts in
                zip(x_parts, conv_parts, sds_parts, sigma_parts)]
        x_free, converged, sds_free, sigma2 = (
            np.concatenate(cols, axis=0) for cols in zip(*host))

        metabolites = np.asarray(pk.metabolites, dtype=object)
        n_metab = pk.n_peaks
        pm = pk.pmap
        safe_idx = np.maximum(pm.idx, 0)
        full_flat = pm.offset[None, :] + np.where(
            pm.idx[None, :] >= 0, pm.scale[None, :] * x_free[:, safe_idx], 0.0
        )
        grids = full_flat.reshape(n_spectra, n_metab, 5)

        amplitudes = grids[:, :, 0]
        chem_shifts = grids[:, :, 1]
        linewidths = grids[:, :, 2]
        phases = grids[:, :, 3]

        # CRLB(%) of each amplitude; a tied amplitude scales its slot's bound.
        crlbs = np.zeros((n_spectra, n_metab))
        for k in range(n_metab):
            j = k * 5
            slot = int(pk.pmap.idx[j])
            if slot >= 0:
                sd_amp = np.abs(pk.pmap.scale[j]) * sds_free[:, slot]
                with np.errstate(divide="ignore", invalid="ignore"):
                    crlbs[:, k] = np.where(
                        amplitudes[:, k] != 0,
                        100.0 * sd_amp / np.abs(amplitudes[:, k]),
                        0.0,
                    )

        # SNR per metabolite: amplitude over the per-real-channel noise std.
        noise_std = np.sqrt(np.maximum(sigma2, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            snrs = np.where(
                noise_std[:, None] > 0, np.abs(amplitudes) / noise_std[:, None], 0.0
            )

        # Failed voxels keep zeros.
        failed = ~converged | ~np.isfinite(grids).all(axis=(1, 2))
        for arr in (amplitudes, chem_shifts, linewidths, phases, crlbs, snrs):
            arr[failed] = 0.0
        if return_curves:
            fit_data[failed] = 0.0

        # 7. Pack the dataset in the original layout.
        def to_voxel_shape(arr, extra=()):
            return arr.reshape(voxel_shape + extra)

        ds = XmrDataset()
        param_dims = tuple(other_dims) + ("Metabolite",)
        metab_coord = {"Metabolite": Coord("Metabolite", metabolites)}

        def voxel_coords(dims):
            return {cname: Coord(c.dim, c.values, c.attrs)
                    for cname, c in da.coords.items() if c.dim in dims}

        time_dims = tuple(other_dims) + (dim,)

        def back(arr, dims):
            x = XmrArray(arr, dims=dims)
            x.coords = voxel_coords(dims)
            if set(dims) == set(da.dims):
                return x.transpose(*(d for d in da.dims if d in dims))
            return x

        if return_curves:
            raw = fids
            if isinstance(fids, torch.Tensor):  # one host copy from a card
                on_card = fids.device.type != "cpu"
                raw = to_host(fids).numpy() if on_card else fids.numpy()
                moved |= on_card
            raw_nd = to_voxel_shape(raw, (n_time,))
            fit_nd = to_voxel_shape(fit_data, (n_time,))
            ds["raw_data"] = back(raw_nd, time_dims)
            ds["fit_data"] = back(fit_nd, time_dims)
            ds["residuals"] = back(raw_nd - fit_nd, time_dims)

        for name, arr in (
            ("amplitude", amplitudes),
            ("chem_shift", chem_shifts),
            ("linewidth", linewidths),
            ("phase", phases),
            ("crlb", crlbs),
            ("snr", snrs),
        ):
            var = XmrArray(to_voxel_shape(arr, (n_metab,)), dims=param_dims)
            var.coords = {**voxel_coords(other_dims),
                          **{k: c.copy() for k, c in metab_coord.items()}}
            ds[name] = var

        if other_dims:
            conv_var = XmrArray(to_voxel_shape(converged.astype(bool)),
                                dims=tuple(other_dims))
            conv_var.coords = voxel_coords(other_dims)
        else:
            conv_var = XmrArray(np.asarray(converged[:1]), dims=("spectrum",))
        ds["fit_converged"] = conv_var

        # 8. Lineage.
        ds.attrs = da.attrs.copy()
        ds.attrs.update({
            "fit_method": method,
            "prior_knowledge_file": str(
                pk.source if isinstance(prior_knowledge_file, PriorKnowledge)
                else prior_knowledge_file
            ),
            "amares_version": f"xmris_tpu_torch-{_version}",
        })
    if not moved:
        count("fit_amares.resident")
    return ds
