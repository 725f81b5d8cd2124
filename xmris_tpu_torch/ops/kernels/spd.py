"""K3/K4/K6a/K6b: per-voxel damped SPD solve and inverse diagonal.

K3 replaces ``xmris_tpu/ops/kernels/spd.py::spd_solve_damped_pallas_slab``,
K4 replaces ``spd_inverse_diag_pallas_slab``, K6a replaces
``spd_solve_damped_pallas`` and K6b replaces ``spd_inverse_diag_pallas``.
The CUDA source is ``csrc/spd.cu``; its header comment gives the bound on
the H100 and the design.  The plain versions beside them run the same
arithmetic in the same order with plain PyTorch ops (every product and sum
rounded on its own, 1/sqrt from a correctly rounded sqrt and division), so
the two agree to the last bits on the card.

Layouts: K3/K4 take H as the voxel-minor slab (F*F, B) of
:func:`xmris_tpu_torch.ops.kernels.lm_cuda.eq6_normal_equations`, with ``g``
(B, F), ``lam`` (B,) and outputs (B, F); K6a/K6b take dense row-major
(B, F, F) matrices.  All four run one warp a voxel (a row of the factor
a lane up to F = 32, two rows a lane up to ``MAX_F``) and launch nothing
for an empty output.  A non-positive pivot gives a NaN row.

:func:`spd_solve_small` and :func:`spd_inverse_diag_small` are the
reference's XLA forms (``spd_solve_small``, ``spd_inverse_diag``: no Pallas
kernel), which the LM and the CRLB take with ``spd_pallas=False``.
"""

from __future__ import annotations

import math

import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

MAX_F = 48  # csrc/spd.cu's kMaxF: two rows a lane past 32


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


def _cholesky_cols(a, rsqrt=False):
    """Cholesky-Crout (outer-product form) of (B, F, F) symmetric ``a``.

    Returns L as (B, F, F) lower triangular; a non-positive pivot gives
    NaN, which spreads through the rest of the factor.  The pivot's
    reciprocal square root is two correctly rounded steps, the kernels'
    arithmetic, or with ``rsqrt`` one ``torch.rsqrt``, the reference's XLA
    form.  The square root is taken in float64 and rounded once: PyTorch's
    vectorised float32 sqrt on the CPU misrounds ~0.6 % of its inputs,
    where the kernels' ``__fsqrt_rn`` (and ``torch.sqrt`` on the card) is
    correctly rounded."""
    b, f, _ = a.shape
    idx = torch.arange(f, device=a.device)
    cols = []
    for k in range(f):
        row_k = a[:, k, :]  # == column k by symmetry
        dk = row_k[:, k]
        safe = torch.where(dk > 0, dk, torch.full_like(dk, math.nan))
        inv = (torch.rsqrt(safe) if rsqrt
               else 1.0 / torch.sqrt(safe.double()).to(safe.dtype))
        l_k = torch.where(idx >= k, row_k * inv[:, None], torch.zeros_like(row_k))
        a = a - l_k[:, :, None] * l_k[:, None, :]
        cols.append(l_k)
    return torch.stack(cols, dim=2)


def _as_bff(h, f):
    return h.view(f, f, -1).permute(2, 0, 1)


def spd_solve_damped_plain(h, g, lam):
    """Plain K3: solve (A + lam*diag(max(A_kk, 1e-12)) + 1e-12 I) x = g."""
    _counters.plain_called("spd_solve_damped")
    f = _check_slab(h, g.shape[0])
    return solve_damped_bff(_as_bff(h, f), g, lam)


def solve_damped_bff(a, g, lam):
    """The damped solve of K3/K6a on (B, F, F) ``a``, op for op."""
    diag = torch.diagonal(a, dim1=1, dim2=2)
    damped = diag + lam[:, None] * torch.clamp(diag, min=1e-12) + 1e-12
    a = a.clone()
    torch.diagonal(a, dim1=1, dim2=2).copy_(damped)
    return _solve_with_factor(_cholesky_cols(a), g)


def _solve_with_factor(l, g):
    """Forward substitution L y = g, then back substitution L^T x = y."""
    f = l.shape[-1]
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
    _counters.plain_called("spd_inverse_diag")
    f = _check_slab(h)
    a = _as_bff(h, f).clone()
    torch.diagonal(a, dim1=1, dim2=2).add_(tikhonov)
    return _inverse_diag_bff(a)


def _check_dense(h):
    if h.dim() != 3 or h.shape[1] != h.shape[2]:
        raise ValueError(f"h must be (B, F, F), got {tuple(h.shape)}")
    if h.dtype != torch.float32:
        raise TypeError("the SPD kernels take float32")
    return h.shape[2]


def spd_solve_damped_dense_plain(h, g, lam):
    """Plain K6a: K3's damped solve on dense (B, F, F) ``h``."""
    _counters.plain_called("spd_solve_damped_dense")
    f = _check_dense(h)
    if g.shape != (h.shape[0], f) or lam.shape != (h.shape[0],):
        raise ValueError("g must be (B, F) and lam (B,)")
    return solve_damped_bff(h, g, lam)


def spd_inverse_diag_dense_plain(h):
    """Plain K6b: diag(A^-1) of dense (B, F, F) ``h`` (no ridge: the CRLB
    caller adds its own)."""
    _counters.plain_called("spd_inverse_diag_dense")
    _check_dense(h)
    return _inverse_diag_bff(h)


def _inverse_diag_bff(a, rsqrt=False):
    """diag(A^-1) of (B, F, F) ``a`` through the Cholesky factor: column c
    of L^-1 by forward substitution, then the sum of its squares."""
    f = a.shape[-1]
    l = _cholesky_cols(a, rsqrt)
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
    if out.numel() == 0:
        return out
    err = _build.library().xmt_spd_solve_damped(
        h.data_ptr(), g.data_ptr(), lam.data_ptr(), out.data_ptr(), b, f,
        _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_solve_damped", err)
    _counters.launched("spd_solve_damped")
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
    if out.numel() == 0:
        return out
    err = _build.library().xmt_spd_inverse_diag(
        h.data_ptr(), out.data_ptr(), b, f, float(tikhonov),
        _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_inverse_diag", err)
    _counters.launched("spd_inverse_diag")
    return out


def spd_solve_damped_dense(h, g, lam):
    """K6a: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if h.device.type == "cpu":
        return spd_solve_damped_dense_plain(h, g, lam)
    if h.device.type != "cuda":
        raise ValueError(f"spd_solve_damped_dense: unsupported device {h.device}")
    f = _check_dense(h)
    b = h.shape[0]
    if g.shape != (b, f) or lam.shape != (b,):
        raise ValueError("g must be (B, F) and lam (B,)")
    _launch_checks(h, f, g, lam)
    out = torch.empty((b, f), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    err = _build.library().xmt_spd_solve_damped_dense(
        h.data_ptr(), g.data_ptr(), lam.data_ptr(), out.data_ptr(), b, f,
        _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_solve_damped_dense", err)
    _counters.launched("spd_solve_damped_dense")
    return out


def spd_inverse_diag_dense(h):
    """K6b: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if h.device.type == "cpu":
        return spd_inverse_diag_dense_plain(h)
    if h.device.type != "cuda":
        raise ValueError(f"spd_inverse_diag_dense: unsupported device {h.device}")
    f = _check_dense(h)
    _launch_checks(h, f)
    b = h.shape[0]
    out = torch.empty((b, f), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    err = _build.library().xmt_spd_inverse_diag_dense(
        h.data_ptr(), out.data_ptr(), b, f, _build.stream_ptr(h.device),
    )
    _build.check("xmt_spd_inverse_diag_dense", err)
    _counters.launched("spd_inverse_diag_dense")
    return out


# ---------------------------------------------------------------------------
# The reference's XLA forms (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------


def spd_solve_small(h, g):
    """Solve ``h x = g`` for (B, F, F) SPD ``h`` (reference
    ``spd_solve_small``); a non-SPD system gives NaN."""
    return _solve_with_factor(_cholesky_cols(h, rsqrt=True), g)


def spd_inverse_diag_small(h):
    """diag(h^-1) of (B, F, F) SPD ``h`` (reference ``spd_inverse_diag``)."""
    return _inverse_diag_bff(h, rsqrt=True)
