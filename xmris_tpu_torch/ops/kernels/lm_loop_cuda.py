"""K8: the whole bounded LM fit of every voxel in one launch (v10).

Replaces ``xmris_tpu/ops/kernels/lm_pallas.py::lm_loop_pallas_v10``.  The
CUDA source is ``csrc/lm_v10.cu`` (its header comment gives the bound on the
H100 and the design); it evaluates through the block evaluation of
``csrc/lm_v9_eval.cuh`` (bit for bit K2's warp evaluation) and solves with
K3's arithmetic in K3's order, in one warp's registers.
:func:`lm_loop_v10_plain` repeats its trips with the plain K2 evaluation and
the plain K3 solve.

Inputs: the (B, F) internal seed ``u0``, the planar FIDs (B, n_t), ``t``
(n_t,), the (F,) bounds and bound kinds, the K2 plan of the prior
(:class:`~xmris_tpu_torch.ops.kernels.lm_cuda.NormalEqPlan`) and its
``pmap_static``.  Returns ``(u (B, F), cost (B,), n_acc (B,) int32, done
(B,) bool, h (B, F, F))`` with ``h`` the carried Gauss-Newton Hessian of the
final accepted state, folded to internal free space (``D H_ext D``,
D = diag(dx/du)), as the reference returns it; ``with_trips`` adds each
voxel's number of evaluations (B,) int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xmris_tpu_torch.ops.bounds import (
    expand_params_batched,
    internal_to_external_torch,
)
from xmris_tpu_torch.ops.kernels import _build, _counters, lm_cuda
from xmris_tpu_torch.ops.kernels.spd import solve_damped_bff

_EPS64 = 64.0 * float(np.finfo(np.float32).eps)


def _check_inputs(u0, y_re, y_im, t, lower, upper, kind, plan, pmap_static):
    b, n_t = y_re.shape
    f = plan.n_free
    if u0.shape != (b, f):
        raise ValueError(f"u0 must be (B, {f}), got {tuple(u0.shape)}")
    if y_im.shape != (b, n_t) or t.shape != (n_t,):
        raise ValueError("y_re/y_im must be (B, n_t) and t (n_t,)")
    if lower.shape != (f,) or upper.shape != (f,) or kind.shape != (f,):
        raise ValueError(f"lower, upper and kind must be ({f},)")
    if len(pmap_static[0]) != 5 * plan.n_peaks:
        raise ValueError("pmap_static does not match the plan's peaks")
    if plan.factored and n_t % lm_cuda._BLOCK_T:
        raise ValueError(f"the factored basis needs n_t % {lm_cuda._BLOCK_T} == 0")
    tensors = (u0, y_re, y_im, t, lower, upper)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("the whole-loop LM takes float32 tensors")
    if any(x.device != y_re.device for x in tensors + (kind,)):
        raise ValueError("all inputs must be on one device")
    return b, n_t


def lm_loop_v10_plain(u0, y_re, y_im, t, lower, upper, kind, plan,
                      pmap_static, *, max_iter, lam0=1e-3, ftol=1e-10,
                      plateau_streak=3, with_trips=False):
    """Plain K8: the kernel's trips over the whole batch, voxels that are
    done frozen (same contract as :func:`lm_loop_v10`)."""
    _counters.plain_called("lm_loop_v10")
    b, _ = _check_inputs(u0, y_re, y_im, t, lower, upper, kind, plan,
                         pmap_static)
    f = plan.n_free
    dev = u0.device
    u = u0.clone()
    h = torch.zeros((b, f, f), dtype=torch.float32, device=dev)
    g = torch.zeros((b, f), dtype=torch.float32, device=dev)
    cost = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    lam = torch.full((b,), lam0, dtype=torch.float32, device=dev)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    streak = torch.zeros_like(n_acc)
    trips = torch.zeros_like(n_acc)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for it in range(max_iter + 1):
        if bool(done.all()):
            break
        delta = solve_damped_bff(h, g, lam)
        solve_ok = torch.isfinite(delta).all(-1)
        delta = torch.where(solve_ok[:, None], delta, torch.zeros_like(delta))
        pred = torch.zeros_like(cost)
        for i in range(f):
            pred = pred + g[:, i] * delta[:, i]
        pred_rel = pred / torch.clamp(cost, min=1e-30)
        done = done | ((pred_rel >= 0.0) & (pred_rel <= _EPS64) & (lam < lam0)
                       & solve_ok)
        live = ~done
        u_t = u + delta
        x, dxdu = internal_to_external_torch(u_t, lower, upper, kind)
        grids = expand_params_batched(x, pmap_static).contiguous()
        cost_t, g_t, h_t = lm_cuda.normal_equations_plain_impl(
            grids, y_re, y_im, t, dxdu.contiguous(), plan)
        h_t = h_t.view(f, f, b).permute(2, 0, 1)
        trips = trips + live.to(torch.int32)
        ok = torch.isfinite(cost_t) & (cost_t < cost) & live
        rel_drop = (cost - cost_t) / torch.clamp(cost, min=1e-30)
        u = torch.where(ok[:, None], u_t, u)
        cost = torch.where(ok, cost_t, cost)
        g = torch.where(ok[:, None], g_t, g)
        h = torch.where(ok[:, None, None], h_t, h)
        if it == 0:
            lam_new = torch.full_like(lam, lam0)
        else:
            lam_new = torch.clamp(torch.where(ok, lam * 0.33, lam * 2.5),
                                  1e-12, 1e12)
        if it > 0:
            n_acc = n_acc + ok.to(torch.int32)
        plateau = ~ok & (rel_drop.abs() <= _EPS64)
        streak = torch.where(live, torch.where(plateau, streak + 1, 0), streak)
        done = done | (live & ((ok & (rel_drop < ftol) & (lam_new < lam0))
                               | (streak >= plateau_streak)))
        lam = torch.where(live, lam_new, lam)
    out = (u, cost, n_acc, done, h.contiguous())
    return out + (trips,) if with_trips else out


@functools.lru_cache(maxsize=32)
def _pmap_tensors(pmap_static, device: str):
    idx, scale, offset, _ = pmap_static
    return (
        torch.as_tensor(np.asarray(idx, np.int32), device=device),
        torch.as_tensor(np.asarray(scale, np.float32), device=device),
        torch.as_tensor(np.asarray(offset, np.float32), device=device),
    )


def lm_loop_v10(u0, y_re, y_im, t, lower, upper, kind, plan, pmap_static, *,
                max_iter, lam0=1e-3, ftol=1e-10, plateau_streak=3,
                with_trips=False):
    """K8: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if y_re.device.type == "cpu":
        return lm_loop_v10_plain(
            u0, y_re, y_im, t, lower, upper, kind, plan, pmap_static,
            max_iter=max_iter, lam0=lam0, ftol=ftol,
            plateau_streak=plateau_streak, with_trips=with_trips)
    if y_re.device.type != "cuda":
        raise ValueError(f"lm_loop_v10: unsupported device {y_re.device}")
    b, n_t = _check_inputs(u0, y_re, y_im, t, lower, upper, kind, plan,
                           pmap_static)
    if not all(x.is_contiguous() for x in (u0, y_re, y_im, t)):
        raise ValueError("lm_loop_v10: inputs must be contiguous")
    lm_cuda.check_plan(plan, n_t)
    dev = y_re.device
    lo = torch.where(torch.isfinite(lower), lower, 0.0).contiguous()
    hi = torch.where(torch.isfinite(upper), upper, 0.0).contiguous()
    kd = kind.to(torch.int32).contiguous()
    ints, scales = lm_cuda._plan_tensors(plan, str(dev))
    p_idx, p_scale, p_off = _pmap_tensors(pmap_static, str(dev))
    f = plan.n_free
    u = torch.empty((b, f), dtype=torch.float32, device=dev)
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    n_acc = torch.empty((b,), dtype=torch.int32, device=dev)
    done = torch.empty((b,), dtype=torch.bool, device=dev)
    h = torch.empty((b, f, f), dtype=torch.float32, device=dev)
    trips = torch.empty((b,), dtype=torch.int32, device=dev) if with_trips else None
    err = _build.library().xmt_lm_loop_v10(
        u0.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), kd.data_ptr(), p_idx.data_ptr(),
        p_scale.data_ptr(), p_off.data_ptr(), ints.data_ptr(), scales.data_ptr(),
        u.data_ptr(), cost.data_ptr(), n_acc.data_ptr(), done.data_ptr(),
        h.data_ptr(), trips.data_ptr() if with_trips else None,
        b, n_t, plan.n_peaks, f, len(plan.active), plan.q_n,
        int(plan.factored), plan.w_cs_unit, float(lam0), float(ftol),
        int(max_iter), int(plateau_streak), _build.stream_ptr(dev),
    )
    _build.check("xmt_lm_loop_v10", err)
    _counters.launched("lm_loop_v10")
    out = (u, cost, n_acc, done, h)
    return out + (trips,) if with_trips else out
