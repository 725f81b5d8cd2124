"""K3/K4: per-voxel damped SPD solve and inverse diagonal on the H slab.

K3 replaces ``xmris_tpu/ops/kernels/spd.py::spd_solve_damped_pallas_slab``
and K4 replaces ``spd_inverse_diag_pallas_slab``.  The CUDA source is
``csrc/spd.cu``; its header comment gives the bound on the H100 and the
design.  The plain versions beside them run the same arithmetic in the same
order with plain PyTorch ops (every product and sum rounded on its own,
1/sqrt from a correctly rounded sqrt and division), so the two agree to the
last bits on the card.

Layout: H is the voxel-minor slab (F*F, B) of
:func:`xmris_tpu_torch.ops.kernels.lm_cuda.eq6_normal_equations`; ``g`` is
(B, F), ``lam`` (B,), outputs (B, F).  A non-positive pivot gives a NaN
row.
"""

from __future__ import annotations

import math

import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

MAX_F = 32


def _check_slab(h, b_expected=None):
    if h.dim() != 2:
        raise ValueError(f"h must be an (F*F, B) slab, got {tuple(h.shape)}")
    f = math.isqrt(h.shape[0])
    if f * f != h.shape[0]:
        raise ValueError(f"slab row count {h.shape[0]} is not a square")
    if b_expected is not None and h.shape[1] != b_expected:
        raise ValueError(f"slab has {h.shape[1]} voxels, expected {b_expected}")
    if h.dtype != torch.float32:
        raise TypeError("the SPD kernels take float32")
    return f


def _cholesky_cols(a):
    """Cholesky-Crout (outer-product form) of (B, F, F) symmetric ``a``.

    Returns L as (B, F, F) lower triangular; a non-positive pivot gives
    NaN, which spreads through the rest of the factor."""
    b, f, _ = a.shape
    idx = torch.arange(f, device=a.device)
    cols = []
    for k in range(f):
        row_k = a[:, k, :]  # == column k by symmetry
        dk = row_k[:, k]
        safe = torch.where(dk > 0, dk, torch.full_like(dk, math.nan))
        inv = 1.0 / torch.sqrt(safe)
        l_k = torch.where(idx >= k, row_k * inv[:, None], torch.zeros_like(row_k))
        a = a - l_k[:, :, None] * l_k[:, None, :]
        cols.append(l_k)
    return torch.stack(cols, dim=2)


def _as_bff(h, f):
    return h.view(f, f, -1).permute(2, 0, 1)


def spd_solve_damped_plain(h, g, lam):
    """Plain K3: solve (A + lam*diag(max(A_kk, 1e-12)) + 1e-12 I) x = g."""
    _counters.PLAIN_CALLS["spd_solve_damped"] += 1
    f = _check_slab(h, g.shape[0])
    a = _as_bff(h, f)
    diag = torch.diagonal(a, dim1=1, dim2=2)
    damped = diag + lam[:, None] * torch.clamp(diag, min=1e-12) + 1e-12
    a = a.clone()
    torch.diagonal(a, dim1=1, dim2=2).copy_(damped)
    l = _cholesky_cols(a)
    ys = []
    for i in range(f):
        acc = g[:, i]
        for j in range(i):
            acc = acc - l[:, i, j] * ys[j]
        ys.append(acc / l[:, i, i])
    xs = [None] * f
    for i in reversed(range(f)):
        acc = ys[i]
        for j in range(i + 1, f):
            acc = acc - l[:, j, i] * xs[j]
        xs[i] = acc / l[:, i, i]
    return torch.stack(xs, dim=1)


def spd_inverse_diag_plain(h, tikhonov: float = 0.0):
    """Plain K4: diag(A^-1) with ``tikhonov`` added to A's diagonal."""
    _counters.PLAIN_CALLS["spd_inverse_diag"] += 1
    f = _check_slab(h)
    a = _as_bff(h, f).clone()
    torch.diagonal(a, dim1=1, dim2=2).add_(tikhonov)
    l = _cholesky_cols(a)
    b = a.shape[0]
    eye = torch.eye(f, dtype=a.dtype, device=a.device)
    acc_sq = torch.zeros((b, f), dtype=a.dtype, device=a.device)
    rows = []
    for i in range(f):
        acc = eye[i].expand(b, f)
        for j in range(i):
            acc = acc - l[:, i, j, None] * rows[j]
        w_i = acc / l[:, i, i, None]
        rows.append(w_i)
        acc_sq = acc_sq + w_i * w_i
    return acc_sq


def _launch_checks(h, f, *others):
    if f > MAX_F:
        raise ValueError(f"F={f} exceeds the kernel maximum {MAX_F}")
    for x in (h,) + others:
        if x.device != h.device or x.dtype != torch.float32:
            raise ValueError("SPD inputs must be float32 on one device")
        if not x.is_contiguous():
            raise ValueError("SPD inputs must be contiguous")


def spd_solve_damped(h, g, lam):
    """K3: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if h.device.type == "cpu":
        return spd_solve_damped_plain(h, g, lam)
    if h.device.type != "cuda":
        raise ValueError(f"spd_solve_damped: unsupported device {h.device}")
    b = g.shape[0]
    f = _check_slab(h, b)
    if g.shape != (b, f) or lam.shape != (b,):
        raise ValueError("g must be (B, F) and lam (B,)")
    _launch_checks(h, f, g, lam)
    out = torch.empty((b, f), dtype=torch.float32, device=h.device)
    err = _build.library().xmt_spd_solve_damped(
        h.data_ptr(), g.data_ptr(), lam.data_ptr(), out.data_ptr(), b, f,
        _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_solve_damped", err)
    _counters.LAUNCHES["spd_solve_damped"] += 1
    return out


def spd_inverse_diag(h, tikhonov: float = 0.0):
    """K4: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if h.device.type == "cpu":
        return spd_inverse_diag_plain(h, tikhonov)
    if h.device.type != "cuda":
        raise ValueError(f"spd_inverse_diag: unsupported device {h.device}")
    f = _check_slab(h)
    _launch_checks(h, f)
    b = h.shape[1]
    out = torch.empty((b, f), dtype=torch.float32, device=h.device)
    err = _build.library().xmt_spd_inverse_diag(
        h.data_ptr(), out.data_ptr(), b, f, float(tikhonov),
        _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_inverse_diag", err)
    _counters.LAUNCHES["spd_inverse_diag"] += 1
    return out
