"""K7, K10-K14: Eq.6 normal equations from the explicit Jacobian (v1-v3, v5-v7).

One function on two row sets, one CUDA source, ``csrc/lm_jac.cu`` (its
header comment gives the bound on the H100 and the design); each wrapper has
its own launch counter.  The reference kernels they replace
(``xmris_tpu/ops/kernels/lm_pallas.py``):

* K7 ``eq6_normal_equations_pallas_v3``, K13 ``…_v2`` and K14
  ``eq6_normal_equations_pallas`` (v1): every physical row.  v1 and v2
  compute v3's function with v3's per-sample formulas (their TPU reduction
  layouts differ), so all three run the same kernel;
* K12 ``…_v5``: the prior's active rows;
* K11 ``…_v6``: v5 plus ``voxel_mask`` (masked voxels are skipped, their
  outputs unspecified);
* K10 ``…_v7``: v6 with the block-factored basis (uniform ``t``,
  ``n_t % 128 == 0``; a peak whose g is fixed at 0, ``env_fast``, factors
  whole, the others keep their envelope per sample).

The plain versions build the Jacobian explicitly and form ``J J^T`` with
full-precision float32 products; they evaluate every voxel (a mask is
accepted and ignored).

Layouts: ``params`` (B, K*5) physical grid, ``y_re``/``y_im`` (B, n_t),
``t`` (n_t,); outputs in physical-parameter space, ``cost`` (B,), ``g``
(B, R) and dense ``h`` (B, R, R), R = 5K rows or ``len(active)`` (the flat
indices ``k*5 + p`` in order).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

MAX_PEAKS = 8
MAX_ROWS = 5 * MAX_PEAKS
_BLOCK_T = 128  # the factored basis's block length
_CHUNK = 32     # the kernel's samples per chunk, one per lane
_TILE = 4       # a lane's tile of Gram entries is _TILE x _TILE
_VOXELS = 4     # voxels (warps) per block
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_DEG = math.pi / 180.0


def row_groups(n_rows: int) -> int:
    """Groups of ``_TILE`` rows that hold the R Jacobian rows and the
    residual (row R) in the kernel's chunk table."""
    return (n_rows + _TILE) // _TILE


def sample_pitch(n_rows: int) -> int:
    """Words between two samples of the chunk table: the re row groups,
    the im row groups and 4 words, so that the 8 lanes of a 16-byte store
    phase start in 8 distinct 16-byte bank groups."""
    return 2 * _TILE * row_groups(n_rows) + 4


def voxel_floats(n_rows: int, n_peaks: int, n_t: int, factored: bool) -> int:
    """Floats of one voxel's shared area (``voxel_floats`` in lm_jac.cu)."""
    tables = n_peaks * (2 * _BLOCK_T + 2 * (n_t // _BLOCK_T)) if factored else 0
    n = _CHUNK * sample_pitch(n_rows) + 2 * n_peaks * _CHUNK + tables
    return (n + 3) & ~3


def tile_map(n_rows: int) -> list[tuple[int, int, int, int]]:
    """The kernel's tiles as ``(lane, round, row group, column group)``:
    tile e of the row-group upper triangle (row-major) goes to lane e % 32
    in round e // 32.  Tile (a, b) holds the Gram entries of rows
    ``4a..4a+3`` against ``4b..4b+3``; row R is the residual (g's column),
    rows past it are zero padding."""
    nb = row_groups(n_rows)
    pairs = [(a, b) for a in range(nb) for b in range(a, nb)]
    return [(e % 32, e // 32, a, b) for e, (a, b) in enumerate(pairs)]


def t_is_uniform(t) -> bool:
    """True when ``t`` is uniformly sampled to within 16 ulp of its dtype at
    the largest |t| (the reference's ``_t_is_uniform``, same tolerance)."""
    t_np = torch.as_tensor(t).detach().cpu().numpy()
    eps = float(np.finfo(t_np.dtype).eps)
    t_np = t_np.astype(np.float64)
    if t_np.size < 3:
        return True
    dt = np.diff(t_np)
    tol = 16.0 * eps * max(float(np.max(np.abs(t_np))), 1e-30)
    return float(np.max(np.abs(dt - dt[0]))) <= tol


def _check_inputs(params, y_re, y_im, t, n_peaks, rows, voxel_mask=None):
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
    if voxel_mask is not None and (
        voxel_mask.shape != (b,) or voxel_mask.dtype != torch.bool
        or voxel_mask.device != y_re.device
    ):
        raise ValueError("voxel_mask must be a (B,) bool tensor on the device")
    return b, n_t


def _check_v7(t, n_t, validate):
    """The reference v7 wrapper's refusals: n_t % 128 != 0 always, a
    non-uniform axis when ``validate`` (the LM driver checks its axis once
    at its entry and passes ``validate=False``)."""
    if n_t % _BLOCK_T:
        raise ValueError("v7 requires n_t % 128 == 0; use kernel_version=6")
    if validate and not t_is_uniform(t):
        raise ValueError(
            "kernel_version=7 requires a uniformly sampled time axis "
            "(the block factorization t[q*128+r] = t[r] + t_q fails "
            "otherwise); use kernel_version=6"
        )


def _factored_basis(amp, cs, lw, ph, gg, t, w_cs_unit, fast):
    """(B, n_t) planes of one peak's block-factored basis and its damp
    profile, in the reference v7 kernel's op order (lm_pallas.py:988-1026)."""
    n_t = t.shape[0]
    t_r = t[:_BLOCK_T]
    t_q = t[::_BLOCK_T] - t[0]  # (n_q,)
    d = math.pi * lw
    w = w_cs_unit * cs  # (B, 1)
    ang_r = w * t_r + ph * _DEG  # (B, 128)
    ang_q = w * t_q  # (B, n_q)
    if fast:
        er = torch.exp(-d * t_r)
        gr_re, gr_im = er * torch.cos(ang_r), er * torch.sin(ang_r)
        fq = amp * torch.exp(-d * t_q)
        fq_re, fq_im = fq * torch.cos(ang_q), fq * torch.sin(ang_q)
        b_re = (fq_re[:, :, None] * gr_re[:, None, :]
                - fq_im[:, :, None] * gr_im[:, None, :])
        b_im = (fq_re[:, :, None] * gr_im[:, None, :]
                + fq_im[:, :, None] * gr_re[:, None, :])
        return b_re.reshape(-1, n_t), b_im.reshape(-1, n_t), t
    dp = (1.0 - gg + gg * t) * t
    env = amp * torch.exp(-d * dp)
    cr, sr = torch.cos(ang_r), torch.sin(ang_r)
    cq, sq = torch.cos(ang_q), torch.sin(ang_q)
    c = cq[:, :, None] * cr[:, None, :] - sq[:, :, None] * sr[:, None, :]
    s = cq[:, :, None] * sr[:, None, :] + sq[:, :, None] * cr[:, None, :]
    return env * c.reshape(-1, n_t), env * s.reshape(-1, n_t), dp


def _jacobian(params, y_re, y_im, t, n_peaks, mhz, rows, env_fast=None):
    """Residual planes, cost and the (B, R, n_t) Jacobian planes of
    ``rows``, with the reference kernel's formulas and op order; with
    ``env_fast`` (per-peak flags) the bases are block-factored (v7)."""
    b = params.shape[0]
    p = params.view(b, n_peaks, 5)
    w_cs_unit = 2.0 * math.pi * mhz
    bases = []
    m_re = torch.zeros_like(y_re)
    m_im = torch.zeros_like(y_im)
    for k in range(n_peaks):
        amp, cs, lw, ph, gg = (p[:, k, c:c + 1] for c in range(5))
        if env_fast is not None:
            b_re, b_im, dp = _factored_basis(amp, cs, lw, ph, gg, t, w_cs_unit,
                                             env_fast[k])
        else:
            d = math.pi * lw
            dp = (1.0 - gg + gg * t) * t
            env = amp * torch.exp(-d * dp)
            ang = w_cs_unit * cs * t + ph * _DEG
            b_re, b_im = env * torch.cos(ang), env * torch.sin(ang)
        m_re = m_re + b_re
        m_im = m_im + b_im
        bases.append((b_re, b_im, amp, lw, dp))
    r_re = y_re - m_re
    r_im = y_im - m_im
    cost = (r_re * r_re + r_im * r_im).sum(1)
    j_re, j_im = [], []
    for j in rows:
        b_re, b_im, amp, lw, dp = bases[j // 5]
        col = j % 5
        if col == 0:
            safe = torch.where(amp == 0, torch.ones_like(amp), amp)
            jr, ji = b_re / safe, b_im / safe
        elif col == 1:
            w = w_cs_unit * t
            jr, ji = -w * b_im, w * b_re
        elif col == 2:
            w = -math.pi * dp
            jr, ji = w * b_re, w * b_im
        elif col == 3:
            jr, ji = -_DEG * b_im, _DEG * b_re
        else:
            w = -(math.pi * lw) * (t * t - t)
            jr, ji = w * b_re, w * b_im
        j_re.append(jr)
        j_im.append(ji)
    return torch.stack(j_re, 1), torch.stack(j_im, 1), r_re, r_im, cost


def _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz, rows,
                         env_fast=None, voxel_mask=None):
    _check_inputs(params, y_re, y_im, t, n_peaks, rows, voxel_mask)
    j_re, j_im, r_re, r_im, cost = _jacobian(params, y_re, y_im, t, n_peaks,
                                             mhz, rows, env_fast)
    h = j_re @ j_re.transpose(1, 2) + j_im @ j_im.transpose(1, 2)
    g = (j_re * r_re[:, None]).sum(-1) + (j_im * r_im[:, None]).sum(-1)
    return cost, g, h


def _all_rows(n_peaks):
    return tuple(range(5 * n_peaks))


def eq6_normal_equations_v3_plain(params, y_re, y_im, t, n_peaks, mhz):
    """Plain K7: every physical row (P = 5K)."""
    _counters.plain_called("eq6_normal_eq_v3")
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                _all_rows(n_peaks))


def eq6_normal_equations_v2_plain(params, y_re, y_im, t, n_peaks, mhz):
    """Plain K13: K7's function (every physical row)."""
    _counters.plain_called("eq6_normal_eq_v2")
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                _all_rows(n_peaks))


def eq6_normal_equations_v1_plain(params, y_re, y_im, t, n_peaks, mhz):
    """Plain K14: K7's function (every physical row)."""
    _counters.plain_called("eq6_normal_eq_v1")
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                _all_rows(n_peaks))


def eq6_normal_equations_v5_plain(params, y_re, y_im, t, n_peaks, mhz, active):
    """Plain K12: the ``active`` physical rows only."""
    _counters.plain_called("eq6_normal_eq_v5")
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                tuple(active))


def eq6_normal_equations_v6_plain(params, y_re, y_im, t, n_peaks, mhz, active,
                                  voxel_mask=None):
    """Plain K11: K12's function; every voxel is evaluated."""
    _counters.plain_called("eq6_normal_eq_v6")
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                tuple(active), voxel_mask=voxel_mask)


def eq6_normal_equations_v7_plain(params, y_re, y_im, t, n_peaks, mhz, active,
                                  env_fast, voxel_mask=None, validate=True):
    """Plain K10: K11's rows on the block-factored basis; every voxel is
    evaluated."""
    _counters.plain_called("eq6_normal_eq_v7")
    _check_v7(t, y_re.shape[-1], validate)
    return _normal_eq_jac_plain(params, y_re, y_im, t, n_peaks, mhz,
                                tuple(active), tuple(env_fast), voxel_mask)


@functools.lru_cache(maxsize=32)
def _ints_tensor(values: tuple[int, ...], device: str):
    return torch.as_tensor(values, dtype=torch.int32, device=device)


def _launch(params, y_re, y_im, t, n_peaks, mhz, rows, counter,
            voxel_mask=None, env_fast=None):
    b, n_t = _check_inputs(params, y_re, y_im, t, n_peaks, rows, voxel_mask)
    if not all(x.is_contiguous() for x in (params, y_re, y_im, t)):
        raise ValueError("normal equations: inputs must be contiguous")
    n_rows = len(rows)
    if n_peaks > MAX_PEAKS or n_rows > MAX_ROWS:
        raise ValueError(f"prior too large for the kernel: peaks {n_peaks} "
                         f"(max {MAX_PEAKS}), rows {n_rows} (max {MAX_ROWS})")
    factored = env_fast is not None
    smem = 4 * _VOXELS * voxel_floats(n_rows, n_peaks, n_t, factored)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{n_rows} rows need {smem} B of shared memory")
    dev = y_re.device
    mask = voxel_mask.contiguous() if voxel_mask is not None else None
    g_zero = (_ints_tensor(tuple(int(f) for f in env_fast), str(dev))
              if factored else None)
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    g = torch.empty((b, n_rows), dtype=torch.float32, device=dev)
    h = torch.empty((b, n_rows, n_rows), dtype=torch.float32, device=dev)
    err = _build.library().xmt_eq6_normal_eq_jac(
        params.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), t.data_ptr(),
        _ints_tensor(tuple(rows), str(dev)).data_ptr(),
        mask.data_ptr() if mask is not None else None,
        g_zero.data_ptr() if g_zero is not None else None,
        cost.data_ptr(), g.data_ptr(), h.data_ptr(), b, n_t, n_peaks, n_rows,
        int(factored), 2.0 * math.pi * mhz, _build.stream_ptr(dev),
    )
    _build.check("xmt_eq6_normal_eq_jac", err)
    _counters.launched(counter)
    return cost, g, h


def _on_cpu(y_re):
    if y_re.device.type == "cpu":
        return True
    if y_re.device.type != "cuda":
        raise ValueError(f"normal equations: unsupported device {y_re.device}")
    return False


def eq6_normal_equations_v3(params, y_re, y_im, t, n_peaks, mhz):
    """K7: the plain version for CPU tensors, the CUDA kernel for CUDA ones.
    Returns ``(cost (B,), g (B, P), h (B, P, P))``, P = 5 * n_peaks."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v3_plain(params, y_re, y_im, t, n_peaks,
                                             mhz)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, _all_rows(n_peaks),
                   "eq6_normal_eq_v3")


def eq6_normal_equations_v2(params, y_re, y_im, t, n_peaks, mhz):
    """K13 (v2): K7's kernel under its own counter; K7's contract."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v2_plain(params, y_re, y_im, t, n_peaks,
                                             mhz)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, _all_rows(n_peaks),
                   "eq6_normal_eq_v2")


def eq6_normal_equations_v1(params, y_re, y_im, t, n_peaks, mhz):
    """K14 (v1): K7's kernel under its own counter; K7's contract."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v1_plain(params, y_re, y_im, t, n_peaks,
                                             mhz)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, _all_rows(n_peaks),
                   "eq6_normal_eq_v1")


def eq6_normal_equations_v5(params, y_re, y_im, t, n_peaks, mhz, active):
    """K12: the plain version for CPU tensors, the CUDA kernel for CUDA ones.
    Returns ``(cost (B,), g (B, A), h (B, A, A))`` over the ``active`` rows."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v5_plain(params, y_re, y_im, t, n_peaks,
                                             mhz, active)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, tuple(active),
                   "eq6_normal_eq_v5")


def eq6_normal_equations_v6(params, y_re, y_im, t, n_peaks, mhz, active,
                            voxel_mask=None):
    """K11: K12's contract; voxels whose ``voxel_mask`` entry is False are
    skipped by the kernel and their outputs are unspecified."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v6_plain(params, y_re, y_im, t, n_peaks,
                                             mhz, active, voxel_mask)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, tuple(active),
                   "eq6_normal_eq_v6", voxel_mask=voxel_mask)


def eq6_normal_equations_v7(params, y_re, y_im, t, n_peaks, mhz, active,
                            env_fast, voxel_mask=None, validate=True):
    """K10: K11 on the block-factored basis; ``env_fast[k]`` marks the
    peaks whose g is fixed at 0.  Raises the reference's ``ValueError`` for
    ``n_t % 128 != 0`` and, with ``validate``, for a non-uniform ``t`` (a
    host read of ``t``)."""
    if _on_cpu(y_re):
        return eq6_normal_equations_v7_plain(params, y_re, y_im, t, n_peaks,
                                             mhz, active, env_fast, voxel_mask,
                                             validate)
    _check_v7(t, y_re.shape[-1], validate)
    return _launch(params, y_re, y_im, t, n_peaks, mhz, tuple(active),
                   "eq6_normal_eq_v7", voxel_mask=voxel_mask,
                   env_fast=tuple(env_fast))
