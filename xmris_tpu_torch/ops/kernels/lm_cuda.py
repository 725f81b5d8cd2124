"""K2 and K9: Eq.6 cost, gradient and Gauss-Newton Hessian per voxel from
complex moments.

K2 replaces ``xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v9``
(with ``fold_slots``/``fold_scales``/``dxdu``, ``slab_h=True`` and the
optional ``cost_prev`` accept gate): the free-space system.  The CUDA
source is ``csrc/lm_v9.cu`` on the warp evaluation of
``csrc/lm_v9_warp.cuh``, whose header comment gives the bound on the H100
and the design (one warp per voxel, the moments in registers); a prior
past the narrow caps (``MAX_PEAKS``, ``MAX_FREE``, ``MAX_ROWS``) takes the
same evaluation's wide build, ``csrc/lm_v9_wide.cu``, up to ``WIDE_MAX_*``
(:func:`is_wide`).  :func:`eq6_normal_equations_plain` is the same
function in plain PyTorch.

K9 replaces ``eq6_normal_equations_pallas_v8``: the physical active rows of
a purely Lorentzian prior (every g fixed at 0) from three moments, which is
K2's evaluation with an identity fold and the direct basis
(``csrc/lm_v8.cu``; :func:`eq6_normal_equations_v8_plain` the same in plain
PyTorch, through K2's plain evaluation with that fold).  K9 and the
whole-loop K8 keep the narrow caps.

Basis form: with ``plan.factored`` (uniform t, n_t % 128 == 0) both
versions build the basis block-factored over 128-sample blocks, exactly as
the reference's ``factored_t`` form that the bench path takes; otherwise
the direct ``exp``/``sin``/``cos`` per sample.

Layouts: ``params`` (B, K*5) physical grid, ``y_re``/``y_im`` (B, n_t),
``t`` (n_t,), ``dxdu`` (B, F); outputs ``cost`` (B,), ``g`` (B, F) and H as
the voxel-minor slab (F*F, B) — entry (f, h) of voxel v at ``[f*F + h, v]``.

The warp evaluation's layout is mirrored here (:func:`moment_items`,
:func:`moment_passes`, :func:`warp_stride`, :func:`warp_smem_bytes`), so
that the wrappers refuse what it cannot take and the CPU tests can check
its index algebra where there is no card.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

# The narrow caps: csrc/lm_v9_eval.cuh's kMaxPeaks/kMaxFree/kMaxRows, which
# bound K8, K9 and K2's narrow build (csrc/lm_v9.cu).
MAX_PEAKS = 8
MAX_FREE = 32
MAX_ROWS = 5 * MAX_PEAKS
# K2's wide build (csrc/lm_v9_wide.cu): kWidePeaks, kWideRows, kWideFree
# (the SPD kernels' MAX_F, which the LM's step needs too).
WIDE_MAX_PEAKS = 12
WIDE_MAX_ROWS = 5 * WIDE_MAX_PEAKS
WIDE_MAX_FREE = 48
MAX_QN = 2
_BLOCK_T = 128
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_DEG = math.pi / 180.0
# csrc/lm_v9_warp.cuh: voxels (warps) a block; accumulator floats a moment
# pass of K2 (csrc/lm_v9.cu) and of K9 (csrc/lm_v8.cu).
WARP_VOXELS = 8
K2_PASS_BUDGET = 64
K9_PASS_BUDGET = 112
K2_WIDE_PASS_BUDGET = 112  # csrc/lm_v9_wide.cu


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
    if dxdu is not None and dxdu.shape != (b, plan.n_free):
        raise ValueError(f"dxdu must be (B, {plan.n_free})")
    tensors = tuple(x for x in (params, y_re, y_im, t, dxdu) if x is not None)
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
                               voxel_mask=None, cost_prev=None):
    """Plain-PyTorch K2; same contract as :func:`eq6_normal_equations`.

    ``voxel_mask`` and ``cost_prev`` are accepted for interface parity and
    ignored: every voxel is evaluated in full (the kernel leaves masked and
    gated voxels' outputs unspecified).
    """
    _counters.plain_called("eq6_normal_eq_v9")
    return normal_equations_plain_impl(params, y_re, y_im, t, dxdu, plan,
                                       voxel_mask)


def normal_equations_plain_impl(params, y_re, y_im, t, dxdu, plan,
                                voxel_mask=None):
    """The body of :func:`eq6_normal_equations_plain` without its call
    counter (the whole-loop twin evaluates through it)."""
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


def moment_items(n_peaks: int, q_n: int) -> list[tuple[int, int, int]]:
    """The warp evaluation's moment items in its order, as ``(k, k', powers)``:
    the residual moments N_k (``k' == -1``, q_n + 1 powers), then the pair
    moments M_kk' (k <= k', row-major; 2 q_n + 1 powers)."""
    pairs = [(k, kp, 2 * q_n + 1) for k in range(n_peaks)
             for kp in range(k, n_peaks)]
    return [(k, -1, q_n + 1) for k in range(n_peaks)] + pairs


def moment_passes(n_peaks: int, q_n: int,
                  budget: int) -> list[tuple[int, int]]:
    """Item ranges ``[i0, i1)`` of the sweeps over the samples: greedy, at
    most ``budget`` accumulator floats (2 per power) a pass, or one item
    where an item alone is wider (``pass_start`` in csrc/lm_v9_warp.cuh;
    ``K2_PASS_BUDGET``, ``K9_PASS_BUDGET``)."""
    passes, start, used = [], 0, 0
    for i, (_, _, n_pow) in enumerate(moment_items(n_peaks, q_n)):
        if used and used + 2 * n_pow > budget:
            passes.append((start, i))
            start, used = i, 0
        used += 2 * n_pow
    passes.append((start, len(moment_items(n_peaks, q_n))))
    return passes


def warp_stride(n_t: int, n_peaks: int, q_n: int, n_free: int, n_rows: int,
                factored: bool) -> int:
    """Floats of one voxel's shared area (``warp_stride`` in
    csrc/lm_v9_warp.cuh): parameters, dx/du, N and M moments, row terms,
    8 cost partials a lane, then the basis tables or the staged H; rounded
    up to 4 mod 32."""
    k = n_peaks
    head = (5 * k + n_free + 2 * k * (q_n + 1) + k * (k + 1) * (2 * q_n + 1)
            + 7 * n_rows + 8 * 32)
    tables = 2 * k * _BLOCK_T + 2 * k * (n_t // _BLOCK_T) if factored else 0
    total = head + max(tables, n_free * n_free)
    return total + (4 - total % 32) % 32


def warp_smem_bytes(n_t: int, n_peaks: int, q_n: int, n_free: int,
                    n_rows: int, factored: bool) -> int:
    """Dynamic shared memory a K2/K9 block asks for: the time axis (padded
    to 4 floats), then WARP_VOXELS voxel areas."""
    return 4 * ((n_t + 3) // 4 * 4 + WARP_VOXELS * warp_stride(
        n_t, n_peaks, q_n, n_free, n_rows, factored))


NARROW_CAPS = (MAX_PEAKS, MAX_FREE, MAX_ROWS)
WIDE_CAPS = (WIDE_MAX_PEAKS, WIDE_MAX_FREE, WIDE_MAX_ROWS)


def is_wide(plan: NormalEqPlan) -> bool:
    """Whether K2 takes the plan to its wide build (``csrc/lm_v9_wide.cu``):
    past a narrow cap, which only a prior of more than 8 peaks, or of 7-8
    with a g freed (q_n = 2), reaches."""
    return (plan.n_peaks > MAX_PEAKS or plan.n_free > MAX_FREE
            or len(plan.active) > MAX_ROWS)


def _check_bounds(plan: NormalEqPlan, caps=WIDE_CAPS) -> None:
    """Refuse a prior past ``caps`` (peaks, free, rows): K2's by default,
    ``NARROW_CAPS`` for K8 and K9."""
    max_peaks, max_free, max_rows = caps
    n_rows = len(plan.active)
    if (plan.n_peaks > max_peaks or plan.n_free > max_free
            or n_rows > max_rows or plan.q_n > MAX_QN):
        raise ValueError(
            f"prior too large for the kernel: peaks {plan.n_peaks} (max "
            f"{max_peaks}), free {plan.n_free} (max {max_free}), rows "
            f"{n_rows} (max {max_rows})"
        )


def check_warp_plan(plan: NormalEqPlan, n_t: int, q_n: int | None = None,
                    caps=WIDE_CAPS) -> None:
    """Refuse a prior or a time axis that the warp evaluation (K2, K9)
    cannot take: its static bounds (K2's ``WIDE_CAPS``; K9 passes
    ``NARROW_CAPS``) and its shared memory (K9 passes its fixed ``q_n`` of
    1)."""
    _check_bounds(plan, caps)
    smem = warp_smem_bytes(n_t, plan.n_peaks,
                           plan.q_n if q_n is None else q_n, plan.n_free,
                           len(plan.active), plan.factored)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n_t={n_t} needs {smem} B of shared memory "
                         f"(max {_SMEM_LIMIT})")


def check_plan(plan: NormalEqPlan, n_t: int) -> None:
    """Refuse a prior or a time axis that the block evaluation of the
    whole-loop kernel (K8, ``v9_eval``) cannot take: its static bounds (the
    narrow caps, which size its shared arrays) and its shared memory."""
    _check_bounds(plan, NARROW_CAPS)
    n_pairs = plan.n_peaks * (plan.n_peaks + 1) // 2
    smem = 4 * (n_t * (3 + 2 * plan.n_peaks)
                + plan.n_peaks * (2 * _BLOCK_T + 2 * (n_t // _BLOCK_T))
                + plan.n_peaks * (plan.q_n + 1) * 2
                + n_pairs * (2 * plan.q_n + 1) * 2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n_t={n_t} needs {smem} B of shared memory")


def eq6_normal_equations(params, y_re, y_im, t, dxdu, plan, voxel_mask=None,
                         cost_prev=None):
    """K2: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Returns ``(cost (B,), g (B, F), h (F*F, B))``.  Voxels whose
    ``voxel_mask`` entry is False are skipped by the kernel and their
    outputs are unspecified.  With ``cost_prev`` (B,) (the accept gate) a
    voxel whose cost is not below its ``cost_prev`` gets its cost and
    unspecified g and H.
    """
    if y_re.device.type == "cpu":
        return eq6_normal_equations_plain(
            params, y_re, y_im, t, dxdu, plan, voxel_mask, cost_prev
        )
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    b, n_t = _check_inputs(params, y_re, y_im, t, dxdu, plan, voxel_mask)
    tensors = (params, y_re, y_im, t, dxdu)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("normal equations: inputs must be contiguous")
    if cost_prev is not None and (
        cost_prev.shape != (b,) or cost_prev.dtype != torch.float32
        or cost_prev.device != y_re.device or not cost_prev.is_contiguous()
    ):
        raise ValueError("cost_prev must be a contiguous (B,) float32 tensor "
                         "on the device")
    check_warp_plan(plan, n_t)
    n_rows = len(plan.active)
    ints, scales = _plan_tensors(plan, str(y_re.device))
    mask = voxel_mask.contiguous() if voxel_mask is not None else None
    cost = torch.empty((b,), dtype=torch.float32, device=y_re.device)
    g = torch.empty((b, plan.n_free), dtype=torch.float32, device=y_re.device)
    h = torch.empty((plan.n_free * plan.n_free, b), dtype=torch.float32,
                    device=y_re.device)
    name = ("xmt_eq6_normal_eq_v9_wide" if is_wide(plan)
            else "xmt_eq6_normal_eq_v9")
    err = getattr(_build.library(), name)(
        params.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        dxdu.data_ptr(), mask.data_ptr() if mask is not None else None,
        cost_prev.data_ptr() if cost_prev is not None else None,
        ints.data_ptr(), scales.data_ptr(),
        cost.data_ptr(), g.data_ptr(), h.data_ptr(),
        b, n_t, plan.n_peaks, plan.n_free, n_rows, plan.q_n,
        int(plan.factored), plan.w_cs_unit, _build.stream_ptr(y_re.device),
    )
    _build.check(name, err)
    _counters.launched("eq6_normal_eq_v9")
    return cost, g, h


# ---------------------------------------------------------------------------
# K9: the three-moment form (v8) on a purely Lorentzian prior
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _v8_plan(n_peaks: int, mhz: float, active: tuple[int, ...]):
    """K2's plan with an identity fold over the active rows: one free slot
    per row, scale 1, every g fixed at 0, the direct basis."""
    return NormalEqPlan(
        n_peaks=n_peaks, n_free=len(active), mhz=float(mhz), active=active,
        g_zero=(True,) * n_peaks, fold_slots=tuple(range(len(active))),
        fold_scales=(1.0,) * len(active), factored=False,
    )


def _check_v8(params, active, validate):
    """The reference v8 wrapper's refusals: a free g row always; with
    ``validate``, a g fixed at a nonzero value in ``params`` (a host read;
    the LM driver selects v8 only for priors that fix every g at 0)."""
    if any(j % 5 == 4 for j in active):
        raise ValueError(
            "v8 requires every g fixed (purely Lorentzian prior); "
            "use kernel_version=6"
        )
    if validate:
        g_cols = params[..., 4::5]
        if g_cols.numel() and float(g_cols.abs().max()) != 0.0:
            raise ValueError(
                "v8 requires every g fixed AT 0 (purely Lorentzian "
                "prior); this prior fixes g at a nonzero value — use "
                "kernel_version=6 or 9"
            )


def eq6_normal_equations_v8_plain(params, y_re, y_im, t, n_peaks, mhz, active,
                                  voxel_mask=None, validate=True):
    """Plain K9: the three-moment form, through K2's plain evaluation with
    the identity fold (its coefficients times exactly 1.0); every voxel is
    evaluated.  Returns ``(cost (B,), g (B, A), h (B, A, A))``."""
    _counters.plain_called("eq6_normal_eq_v8")
    active = tuple(active)
    _check_v8(params, active, validate)
    plan = _v8_plan(int(n_peaks), float(mhz), active)
    a = len(active)
    ones = torch.ones((y_re.shape[0], a), dtype=torch.float32,
                      device=y_re.device)
    cost, g, h = normal_equations_plain_impl(params, y_re, y_im, t, ones, plan,
                                             voxel_mask)
    return cost, g, h.view(a, a, -1).permute(2, 0, 1).contiguous()


def eq6_normal_equations_v8(params, y_re, y_im, t, n_peaks, mhz, active,
                            voxel_mask=None, validate=True):
    """K9: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Returns ``(cost (B,), g (B, A), h (B, A, A))`` over the ``active``
    physical rows, as K12 does.  Voxels whose ``voxel_mask`` entry is False
    are skipped by the kernel and their outputs are unspecified.  Raises
    the reference's ``ValueError`` for a free g row and, with ``validate``,
    for a g fixed at a nonzero value.
    """
    if y_re.device.type == "cpu":
        return eq6_normal_equations_v8_plain(params, y_re, y_im, t, n_peaks,
                                             mhz, active, voxel_mask, validate)
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    active = tuple(active)
    _check_v8(params, active, validate)
    plan = _v8_plan(int(n_peaks), float(mhz), active)
    a = len(active)
    b, n_t = _check_inputs(params, y_re, y_im, t, None, plan, voxel_mask)
    if not all(x.is_contiguous() for x in (params, y_re, y_im, t)):
        raise ValueError("normal equations: inputs must be contiguous")
    check_warp_plan(plan, n_t, q_n=1, caps=NARROW_CAPS)
    ints, scales = _plan_tensors(plan, str(y_re.device))
    mask = voxel_mask.contiguous() if voxel_mask is not None else None
    cost = torch.empty((b,), dtype=torch.float32, device=y_re.device)
    g = torch.empty((b, a), dtype=torch.float32, device=y_re.device)
    h = torch.empty((b, a, a), dtype=torch.float32, device=y_re.device)
    err = _build.library().xmt_eq6_normal_eq_v8(
        params.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        mask.data_ptr() if mask is not None else None, ints.data_ptr(),
        scales.data_ptr(), cost.data_ptr(), g.data_ptr(), h.data_ptr(),
        b, n_t, plan.n_peaks, a, plan.w_cs_unit, _build.stream_ptr(y_re.device),
    )
    _build.check("xmt_eq6_normal_eq_v8", err)
    _counters.launched("eq6_normal_eq_v8")
    return cost, g, h
