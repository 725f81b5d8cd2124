"""K7/K12: Eq.6 normal equations from the explicit Jacobian (v3 / v5).

K7 replaces ``xmris_tpu/ops/kernels/lm_pallas.py::eq6_normal_equations_pallas_v3``
and K12 ``eq6_normal_equations_pallas_v5``: the same function on two row
sets, so one CUDA source, ``csrc/lm_jac.cu`` (its header comment gives the
bound on the H100 and the design), serves both, each wrapper with its own
launch counter.  The plain versions build the Jacobian explicitly and form
``J J^T`` with full-precision float32 products.

Layouts: ``params`` (B, K*5) physical grid, ``y_re``/``y_im`` (B, n_t),
``t`` (n_t,); outputs in physical-parameter space, ``cost`` (B,), ``g``
(B, R) and dense ``h`` (B, R, R), R = 5K for v3 and ``len(active)`` rows
(the flat indices ``k*5 + p`` in order) for v5.
"""

from __future__ import annotations

import functools
import math

import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

MAX_PEAKS = 8
MAX_ROWS = 5 * MAX_PEAKS
_CHUNK = 128
_PITCH = _CHUNK + 1
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_DEG = math.pi / 180.0


def _check_inputs(params, y_re, y_im, t, n_peaks, rows):
    b, n_t = y_re.shape
    if y_im.shape != (b, n_t) or t.shape != (n_t,):
        raise ValueError("y_re/y_im must be (B, n_t) and t (n_t,)")
    if params.shape != (b, n_peaks * 5):
        raise ValueError(
            f"params must be (B, {n_peaks * 5}), got {tuple(params.shape)}")
    if not rows or any(not 0 <= j < n_peaks * 5 for j in rows):
        raise ValueError(f"rows must index the {n_peaks * 5} physical parameters")
    tensors = (params, y_re, y_im, t)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("normal equations take float32 tensors")
    if any(x.device != y_re.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    return b, n_t


def _jacobian(params, y_re, y_im, t, n_peaks, mhz, rows):
    """Residual planes, cost and the (B, R, n_t) Jacobian planes of
    ``rows``, with the reference kernel's formulas and op order."""
    b = params.shape[0]
    p = params.view(b, n_peaks, 5)
    w_cs_unit = 2.0 * math.pi * mhz
    bases = []
    m_re = torch.zeros_like(y_re)
    m_im = torch.zeros_like(y_im)
    for k in range(n_peaks):
        amp, cs, lw, ph, gg = (p[:, k, c:c + 1] for c in range(5))
        d = math.pi * lw
        dp = (1.0 - gg + gg * t) * t
        env = amp * torch.exp(-d * dp)
        ang = w_cs_unit * cs * t + ph * _DEG
        b_re, b_im = env * torch.cos(ang), env * torch.sin(ang)
        m_re = m_re + b_re
        m_im = m_im + b_im
        bases.append((b_re, b_im, amp, lw, gg))
    r_re = y_re - m_re
    r_im = y_im - m_im
    cost = (r_re * r_re + r_im * r_im).sum(1)
    j_re, j_im = [], []
    for j in rows:
        b_re, b_im, amp, lw, gg = bases[j // 5]
        col = j % 5
        if col == 0:
            safe = torch.where(amp == 0, torch.ones_like(amp), amp)
            jr, ji = b_re / safe, b_im / safe
        elif col == 1:
            w = w_cs_unit * t
            jr, ji = -w * b_im, w * b_re
        elif col == 2:
            w = -math.pi * ((1.0 - gg + gg * t) * t)
            jr, ji = w * b_re, w * b_im
        elif col == 3:
            jr, ji = -_DEG * b_im, _DEG * b_re
        else:
            w = -(math.pi * lw) * (t * t - t)
            jr, ji = w * b_re, w * b_im
        j_re.append(jr)
        j_im.append(ji)
    return torch.stack(j_re, 1), torch.stack(j_im, 1), r_re, r_im, cost


def _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz, rows):
    _check_inputs(params, y_re, y_im, t, n_peaks, rows)
    j_re, j_im, r_re, r_im, cost = _jacobian(params, y_re, y_im, t, n_peaks,
                                             mhz, rows)
    h = j_re @ j_re.transpose(1, 2) + j_im @ j_im.transpose(1, 2)
    g = (j_re * r_re[:, None]).sum(-1) + (j_im * r_im[:, None]).sum(-1)
    return cost, g, h


def eq6_normal_equations_v3_plain(params, y_re, y_im, t, n_peaks, mhz):
    """Plain K7: every physical row (P = 5K)."""
    _counters.PLAIN_CALLS["eq6_normal_eq_v3"] += 1
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                tuple(range(5 * n_peaks)))


def eq6_normal_equations_v5_plain(params, y_re, y_im, t, n_peaks, mhz, active):
    """Plain K12: the ``active`` physical rows only."""
    _counters.PLAIN_CALLS["eq6_normal_eq_v5"] += 1
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                tuple(active))


@functools.lru_cache(maxsize=32)
def _rows_tensor(rows: tuple[int, ...], device: str):
    return torch.as_tensor(rows, dtype=torch.int32, device=device)


def _launch(params, y_re, y_im, t, n_peaks, mhz, rows, counter):
    b, n_t = _check_inputs(params, y_re, y_im, t, n_peaks, rows)
    if not all(x.is_contiguous() for x in (params, y_re, y_im, t)):
        raise ValueError("normal equations: inputs must be contiguous")
    n_rows = len(rows)
    if n_peaks > MAX_PEAKS or n_rows > MAX_ROWS:
        raise ValueError(f"prior too large for the kernel: peaks {n_peaks} "
                         f"(max {MAX_PEAKS}), rows {n_rows} (max {MAX_ROWS})")
    smem = 4 * (2 * n_rows * _PITCH + 2 * n_peaks * _CHUNK + 2 * _CHUNK)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{n_rows} rows need {smem} B of shared memory")
    dev = y_re.device
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    g = torch.empty((b, n_rows), dtype=torch.float32, device=dev)
    h = torch.empty((b, n_rows, n_rows), dtype=torch.float32, device=dev)
    err = _build.library().xmt_eq6_normal_eq_jac(
        params.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        _rows_tensor(tuple(rows), str(dev)).data_ptr(), cost.data_ptr(),
        g.data_ptr(), h.data_ptr(), b, n_t, n_peaks, n_rows,
        2.0 * math.pi * mhz, _build.stream_ptr(dev),
    )
    _build.check("xmt_eq6_normal_eq_jac", err)
    _counters.LAUNCHES[counter] += 1
    return cost, g, h


def eq6_normal_equations_v3(params, y_re, y_im, t, n_peaks, mhz):
    """K7: the plain version for CPU tensors, the CUDA kernel for CUDA ones.
    Returns ``(cost (B,), g (B, P), h (B, P, P))``, P = 5 * n_peaks."""
    if y_re.device.type == "cpu":
        return eq6_normal_equations_v3_plain(params, y_re, y_im, t, n_peaks,
                                             mhz)
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    return _launch(params, y_re, y_im, t, n_peaks, mhz,
                   tuple(range(5 * n_peaks)), "eq6_normal_eq_v3")


def eq6_normal_equations_v5(params, y_re, y_im, t, n_peaks, mhz, active):
    """K12: the plain version for CPU tensors, the CUDA kernel for CUDA ones.
    Returns ``(cost (B,), g (B, A), h (B, A, A))`` over the ``active`` rows."""
    if y_re.device.type == "cpu":
        return eq6_normal_equations_v5_plain(params, y_re, y_im, t, n_peaks,
                                             mhz, active)
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    return _launch(params, y_re, y_im, t, n_peaks, mhz, tuple(active),
                   "eq6_normal_eq_v5")
