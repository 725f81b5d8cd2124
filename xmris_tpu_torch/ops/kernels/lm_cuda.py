"""K2: Eq.6 cost, free-space gradient and Gauss-Newton Hessian per voxel.

Replaces ``xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v9``
(with ``fold_slots``/``fold_scales``/``dxdu`` and ``slab_h=True``).  The CUDA
source is ``csrc/lm_v9.cu``; its header comment gives the bound on the
H100 and the design.  :func:`eq6_normal_equations_plain` is the same
function in plain PyTorch.

Basis form: with ``plan.factored`` (uniform t, n_t % 128 == 0) both
versions build the basis block-factored over 128-sample blocks, exactly as
the reference's ``factored_t`` form that the bench path takes; otherwise
the direct ``exp``/``sin``/``cos`` per sample.

Layouts: ``params`` (B, K*5) physical grid, ``y_re``/``y_im`` (B, n_t),
``t`` (n_t,), ``dxdu`` (B, F); outputs ``cost`` (B,), ``g`` (B, F) and H as
the voxel-minor slab (F*F, B) — entry (f, h) of voxel v at ``[f*F + h, v]``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

MAX_PEAKS = 8
MAX_FREE = 32
MAX_ROWS = 5 * MAX_PEAKS
MAX_QN = 2
_BLOCK_T = 128
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_DEG = math.pi / 180.0


def _row_degrees(ptype: int, g_zero: bool) -> tuple[int, ...]:
    """t-power degrees of a Jacobian row's coefficient polynomial (the
    reference's ``_v9_row_degrees``)."""
    if ptype in (0, 3):
        return (0,)
    if ptype == 1:
        return (1,)
    if ptype == 2:
        return (1,) if g_zero else (1, 2)
    return (1, 2)


@dataclasses.dataclass(frozen=True)
class NormalEqPlan:
    """Static prior structure of K2 (the reference kernel's static args)."""

    n_peaks: int
    n_free: int
    mhz: float
    active: tuple[int, ...]  # flat physical indices with a free slot
    g_zero: tuple[bool, ...]  # per peak: g fixed at exactly 0
    fold_slots: tuple[int, ...]  # per active row: its free slot
    fold_scales: tuple[float, ...]  # per active row: scatter scale
    factored: bool  # block-factored basis (uniform t, n_t % 128 == 0)

    @property
    def rows(self) -> list[tuple[int, int]]:
        return [(j // 5, j % 5) for j in self.active]

    @property
    def q_n(self) -> int:
        return max(
            (max(_row_degrees(p, self.g_zero[k])) for k, p in self.rows),
            default=0,
        )

    @property
    def w_cs_unit(self) -> float:
        return 2.0 * math.pi * self.mhz

    def int_table(self) -> np.ndarray:
        """row_peak, row_ptype, row_slot, slot CSR (ptr, rows), g_zero."""
        rows = self.rows
        slot_rows = [
            [r for r, s in enumerate(self.fold_slots) if s == f]
            for f in range(self.n_free)
        ]
        ptr = np.cumsum([0] + [len(r) for r in slot_rows])
        return np.concatenate([
            [k for k, _ in rows],
            [p for _, p in rows],
            list(self.fold_slots),
            ptr,
            [r for rs in slot_rows for r in rs],
            [int(z) for z in self.g_zero],
        ]).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _plan_tensors(plan: NormalEqPlan, device: str):
    ints = torch.as_tensor(plan.int_table(), device=device)
    scales = torch.as_tensor(
        np.asarray(plan.fold_scales, np.float32), device=device
    )
    return ints, scales


def _check_inputs(params, y_re, y_im, t, dxdu, plan, voxel_mask):
    b, n_t = y_re.shape
    if y_im.shape != (b, n_t) or t.shape != (n_t,):
        raise ValueError("y_re/y_im must be (B, n_t) and t (n_t,)")
    if params.shape != (b, plan.n_peaks * 5):
        raise ValueError(
            f"params must be (B, {plan.n_peaks * 5}), got {tuple(params.shape)}"
        )
    if dxdu.shape != (b, plan.n_free):
        raise ValueError(f"dxdu must be (B, {plan.n_free})")
    tensors = (params, y_re, y_im, t, dxdu)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("normal equations take float32 tensors")
    if any(x.device != y_re.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if voxel_mask is not None and (
        voxel_mask.shape != (b,) or voxel_mask.dtype != torch.bool
        or voxel_mask.device != y_re.device
    ):
        raise ValueError("voxel_mask must be a (B,) bool tensor on the device")
    if plan.factored and n_t % _BLOCK_T:
        raise ValueError(f"the factored basis needs n_t % {_BLOCK_T} == 0")
    return b, n_t


def _peak_basis(p, k, t, plan):
    """(B, n_t) planes of peak k's basis, in the reference's op order."""
    amp, cs, lw, ph, gv = (p[:, k, c:c + 1] for c in range(5))
    w = plan.w_cs_unit * cs
    d = math.pi * lw
    if plan.factored:
        n_t = t.shape[0]
        t_r = t[:_BLOCK_T]
        t_q = t[::_BLOCK_T] - t[0]  # (n_q,)
        ang_r = w * t_r + ph * _DEG  # (B, 128)
        ang_q = w * t_q  # (B, n_q)
        if plan.g_zero[k]:
            er = torch.exp(-d * t_r)
            gr_re, gr_im = er * torch.cos(ang_r), er * torch.sin(ang_r)
            fq = amp * torch.exp(-d * t_q)
            fq_re, fq_im = fq * torch.cos(ang_q), fq * torch.sin(ang_q)
            b_re = fq_re[:, :, None] * gr_re[:, None, :] - (
                fq_im[:, :, None] * gr_im[:, None, :])
            b_im = fq_re[:, :, None] * gr_im[:, None, :] + (
                fq_im[:, :, None] * gr_re[:, None, :])
            return b_re.reshape(-1, n_t), b_im.reshape(-1, n_t)
        env = amp * torch.exp(-d * (1.0 - gv + gv * t) * t)
        cr, sr = torch.cos(ang_r), torch.sin(ang_r)
        cq, sq = torch.cos(ang_q), torch.sin(ang_q)
        c = cq[:, :, None] * cr[:, None, :] - sq[:, :, None] * sr[:, None, :]
        s = cq[:, :, None] * sr[:, None, :] + sq[:, :, None] * cr[:, None, :]
        return env * c.reshape(-1, n_t), env * s.reshape(-1, n_t)
    if plan.g_zero[k]:
        env = amp * torch.exp((-math.pi) * lw * t)
    else:
        env = amp * torch.exp((-math.pi) * lw * (1.0 - gv + gv * t) * t)
    ang = w * t + ph * _DEG
    return env * torch.cos(ang), env * torch.sin(ang)


def eq6_normal_equations_plain(params, y_re, y_im, t, dxdu, plan,
                               voxel_mask=None):
    """Plain-PyTorch K2; same contract as :func:`eq6_normal_equations`.

    ``voxel_mask`` is accepted for interface parity and ignored: every
    voxel is evaluated (the kernel leaves masked voxels unspecified).
    """
    _counters.PLAIN_CALLS["eq6_normal_eq_v9"] += 1
    b, n_t = _check_inputs(params, y_re, y_im, t, dxdu, plan, voxel_mask)
    n_peaks, n_free = plan.n_peaks, plan.n_free
    p = params.view(b, n_peaks, 5)

    bre, bim = [], []
    m_re = torch.zeros_like(y_re)
    m_im = torch.zeros_like(y_im)
    for k in range(n_peaks):
        b_re, b_im = _peak_basis(p, k, t, plan)
        bre.append(b_re)
        bim.append(b_im)
        m_re = m_re + b_re
        m_im = m_im + b_im
    r_re = y_re - m_re
    r_im = y_im - m_im
    cost = (r_re * r_re + r_im * r_im).sum(1)
    bre = torch.stack(bre, 1)  # (B, K, n_t)
    bim = torch.stack(bim, 1)

    q_n = plan.q_n
    q_m = 2 * q_n
    tp = [torch.ones_like(t), t]
    for _ in range(2, q_m + 1):
        tp.append(tp[-1] * t)
    tp = torch.stack(tp[: q_m + 1])  # (q_m+1, n_t)

    # Residual moments N_q[k] and pair moments M_q[k, k'] (k <= k').
    pr = bre * r_re[:, None] + bim * r_im[:, None]
    pi = bre * r_im[:, None] - bim * r_re[:, None]
    n_r = torch.einsum("bkt,qt->bkq", pr, tp[: q_n + 1])
    n_i = torch.einsum("bkt,qt->bkq", pi, tp[: q_n + 1])
    pairs = [(k, kp) for k in range(n_peaks) for kp in range(k, n_peaks)]
    pk = torch.as_tensor([k for k, _ in pairs], device=t.device)
    pkp = torch.as_tensor([kp for _, kp in pairs], device=t.device)
    cr = bre[:, pk] * bre[:, pkp] + bim[:, pk] * bim[:, pkp]
    ci = bim[:, pk] * bre[:, pkp] - bre[:, pk] * bim[:, pkp]
    m_r = torch.einsum("bpt,qt->bpq", cr, tp)
    m_i = torch.einsum("bpt,qt->bpq", ci, tp)
    pair_of = {kk: i for i, kk in enumerate(pairs)}

    # Per-row coefficient terms (alpha, beta, degree), folded by m_r.
    rows = plan.rows
    zero = torch.zeros((b,), dtype=torch.float32, device=t.device)
    one = torch.ones_like(zero)
    terms = []
    for r, (k, ptype) in enumerate(rows):
        m = dxdu[:, plan.fold_slots[r]] * plan.fold_scales[r]
        if ptype == 0:
            a_ = p[:, k, 0]
            tl = [(one / torch.where(a_ == 0, one, a_), zero, 0)]
        elif ptype == 1:
            tl = [(zero, plan.w_cs_unit * one, 1)]
        elif ptype == 2:
            if plan.g_zero[k]:
                tl = [(-math.pi * one, zero, 1)]
            else:
                gv = p[:, k, 4]
                tl = [(-math.pi * (1.0 - gv), zero, 1), (-math.pi * gv, zero, 2)]
        elif ptype == 3:
            tl = [(zero, _DEG * one, 0)]
        else:
            d_ = math.pi * p[:, k, 2]
            tl = [(d_, zero, 1), (-d_, zero, 2)]
        terms.append([(al * m, be * m, d) for al, be, d in tl])

    g = torch.zeros((b, n_free), dtype=torch.float32, device=t.device)
    for r, (k, _) in enumerate(rows):
        f = plan.fold_slots[r]
        acc = g[:, f]
        for al, be, d in terms[r]:
            acc = acc + al * n_r[:, k, d] + be * n_i[:, k, d]
        g[:, f] = acc

    # H upper triangle by slot pairs, rows in order, then mirrored.
    slot_rows = [
        [r for r, s in enumerate(plan.fold_slots) if s == f]
        for f in range(n_free)
    ]
    h = torch.zeros((n_free, n_free, b), dtype=torch.float32, device=t.device)
    for f in range(n_free):
        for hh in range(f, n_free):
            acc = zero
            for r in slot_rows[f]:
                kr = rows[r][0]
                for s in slot_rows[hh]:
                    ks = rows[s][0]
                    pidx = pair_of[(min(kr, ks), max(kr, ks))]
                    sign = 1.0 if kr <= ks else -1.0
                    for ar, br, dd in terms[r]:
                        for as_, bs, e in terms[s]:
                            mr = m_r[:, pidx, dd + e]
                            mi = sign * m_i[:, pidx, dd + e]
                            acc = acc + ((ar * as_ + br * bs) * mr
                                         - (br * as_ - ar * bs) * mi)
            h[f, hh] = acc
            h[hh, f] = acc
    return cost, g, h.reshape(n_free * n_free, b)


def eq6_normal_equations(params, y_re, y_im, t, dxdu, plan, voxel_mask=None):
    """K2: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Returns ``(cost (B,), g (B, F), h (F*F, B))``.  Voxels whose
    ``voxel_mask`` entry is False are skipped by the kernel and their
    outputs are unspecified.
    """
    if y_re.device.type == "cpu":
        return eq6_normal_equations_plain(
            params, y_re, y_im, t, dxdu, plan, voxel_mask
        )
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    b, n_t = _check_inputs(params, y_re, y_im, t, dxdu, plan, voxel_mask)
    tensors = (params, y_re, y_im, t, dxdu)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("normal equations: inputs must be contiguous")
    n_rows = len(plan.active)
    if (plan.n_peaks > MAX_PEAKS or plan.n_free > MAX_FREE
            or n_rows > MAX_ROWS or plan.q_n > MAX_QN):
        raise ValueError(
            f"prior too large for the kernel: peaks {plan.n_peaks} (max "
            f"{MAX_PEAKS}), free {plan.n_free} (max {MAX_FREE}), rows "
            f"{n_rows} (max {MAX_ROWS})"
        )
    n_pairs = plan.n_peaks * (plan.n_peaks + 1) // 2
    smem = 4 * (n_t * (3 + 2 * plan.n_peaks)
                + plan.n_peaks * (2 * _BLOCK_T + 2 * (n_t // _BLOCK_T))
                + plan.n_peaks * (plan.q_n + 1) * 2
                + n_pairs * (2 * plan.q_n + 1) * 2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n_t={n_t} needs {smem} B of shared memory")
    ints, scales = _plan_tensors(plan, str(y_re.device))
    mask = voxel_mask.contiguous() if voxel_mask is not None else None
    cost = torch.empty((b,), dtype=torch.float32, device=y_re.device)
    g = torch.empty((b, plan.n_free), dtype=torch.float32, device=y_re.device)
    h = torch.empty((plan.n_free * plan.n_free, b), dtype=torch.float32,
                    device=y_re.device)
    err = _build.library().xmt_eq6_normal_eq_v9(
        params.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        dxdu.data_ptr(), mask.data_ptr() if mask is not None else None,
        ints.data_ptr(), scales.data_ptr(),
        cost.data_ptr(), g.data_ptr(), h.data_ptr(),
        b, n_t, plan.n_peaks, plan.n_free, n_rows, plan.q_n,
        int(plan.factored), plan.w_cs_unit, _build.stream_ptr(y_re.device),
    )
    _build.check("xmt_eq6_normal_eq_v9", err)
    _counters.LAUNCHES["eq6_normal_eq_v9"] += 1
    return cost, g, h
