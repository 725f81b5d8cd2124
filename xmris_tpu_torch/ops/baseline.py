"""Asymmetric least squares (AsLS) baseline correction (PyTorch port).

Port of :mod:`xmris_tpu.ops.baseline`.  Each spectrum's baseline ``z``
solves ``(W + lam D^T D) z = W y`` with ``D`` the second-difference
operator and ``W = diag(w)``, re-weighted ``w = p (y > z) + (1 - p) (y <
z)`` for ``n_iter`` iterations.  ``D^T D`` is pentadiagonal with closed-form
bands (:func:`_dtd_bands`), so each solve is direct and O(n):

* ``"scan"``: the banded LDL^T recurrence (:func:`_penta_ldlt_solve`), a
  loop over the points, each step vectorised over the voxels;
* ``"cr"``: block cyclic reduction (:func:`penta_solve_cr`): rows paired
  into 2x2 blocks make the system block-tridiagonal, solved in
  log2(n / 2) levels of independent 2x2 block algebra over every block and
  voxel at once.

Both compute in float64 whatever the input's dtype (the system's condition
number, ~lam * 16 / min(w) ~ 1e9, is beyond float32) and return the input's
dtype.  No TPU kernel lies on this path: it is plain PyTorch on the card
and on the CPU.

Host-call contract: these functions are called from the host, eagerly.
The scan solver is a Python loop over the points and the CR solver a
Python recursion over the levels, each launching PyTorch operations; do not
call them inside ``torch.compile`` or ``torch.func`` transforms (``vmap``,
``grad``): batch the voxels along the leading axis instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.core.config import ATTRS, DIMS
from xmris_tpu_torch.core.utils import _check_dims, card_device


def _dtd_bands(n: int, dtype, device=None):
    """Closed-form bands of D^T D for the (n-2) x n second-difference D:
    the main diagonal (n,), the first (n-1,) and second (n-2,)
    off-diagonals."""
    main = torch.full((n,), 6.0, dtype=dtype, device=device)
    main[0] = main[-1] = 1.0
    main[1] = main[-2] = 5.0
    off1 = torch.full((n - 1,), -4.0, dtype=dtype, device=device)
    off1[0] = off1[-1] = -2.0
    off2 = torch.ones((n - 2,), dtype=dtype, device=device)
    return main, off1, off2


def _penta_ldlt_solve(a0, a1, a2, b):
    """Solve the symmetric pentadiagonal system A x = b by banded LDL^T.

    ``a0`` is the main diagonal (..., n), ``a1`` the first off-diagonal
    (..., n-1), ``a2`` the second (..., n-2), ``b`` (..., n); the bands
    broadcast against ``b``'s leading dims.  Three sequential passes over
    the points (factor, forward, backward), each step on all leading
    indices at once.
    """
    lead = b.shape[:-1]
    n = b.shape[-1]
    a0 = a0.expand(*lead, n).unbind(-1)
    zero = torch.zeros(lead, dtype=b.dtype, device=b.device)
    a1 = (zero,) + a1.expand(*lead, n - 1).unbind(-1)  # a1[i] = A[i, i-1]
    a2 = (zero, zero) + a2.expand(*lead, n - 2).unbind(-1)  # A[i, i-2]
    bs = b.unbind(-1)

    # Factor: D_i, and L's sub-diagonals e_i = L[i, i-1], g_i = L[i, i-2].
    d, e, g = [], [], []
    d_im1 = d_im2 = e_im1 = zero
    for i in range(n):
        g_i = torch.where(d_im2 != 0, a2[i] / d_im2, zero)
        e_i = torch.where(d_im1 != 0, (a1[i] - g_i * e_im1 * d_im2) / d_im1,
                          zero)
        d_i = a0[i] - e_i * e_i * d_im1 - g_i * g_i * d_im2
        d.append(d_i)
        e.append(e_i)
        g.append(g_i)
        d_im2, d_im1, e_im1 = d_im1, d_i, e_i

    # Forward: L z = b.
    z = []
    z_im1 = z_im2 = zero
    for i in range(n):
        z_i = bs[i] - e[i] * z_im1 - g[i] * z_im2
        z.append(z_i)
        z_im2, z_im1 = z_im1, z_i

    # Backward: L^T x = z / D.
    x = [zero] * n
    x_ip1 = x_ip2 = zero
    for i in range(n - 1, -1, -1):
        e_ip1 = e[i + 1] if i + 1 < n else zero
        g_ip2 = g[i + 2] if i + 2 < n else zero
        x_i = z[i] / d[i] - e_ip1 * x_ip1 - g_ip2 * x_ip2
        x[i] = x_i
        x_ip2, x_ip1 = x_ip1, x_i
    return torch.stack(x, dim=-1)


# ---------------------------------------------------------------------------
# Block cyclic reduction
# ---------------------------------------------------------------------------
#
# 2x2 blocks travel as four (..., m) component planes (m00, m01, m10, m11),
# the block index on the last axis: every step is elementwise over blocks
# and voxels.


def _inv2(m):
    """2x2 inverse on component planes."""
    m00, m01, m10, m11 = m
    det = m00 * m11 - m01 * m10
    return (m11 / det, -m01 / det, -m10 / det, m00 / det)


def _mul2(x, y):
    """2x2 matmul on component planes."""
    x00, x01, x10, x11 = x
    y00, y01, y10, y11 = y
    return (
        x00 * y00 + x01 * y10,
        x00 * y01 + x01 * y11,
        x10 * y00 + x11 * y10,
        x10 * y01 + x11 * y11,
    )


def _mv2(m, v):
    """2x2 matrix-vector on component planes; ``v`` = (v0, v1)."""
    m00, m01, m10, m11 = m
    v0, v1 = v
    return (m00 * v0 + m01 * v1, m10 * v0 + m11 * v1)


def _sub2(x, y):
    return tuple(a - b for a, b in zip(x, y))


def _neg2(x):
    return tuple(-a for a in x)


def _shift(x, k: int):
    """Shift along the last axis with zero fill: ``k = 1`` takes the value
    from index i-1, ``k = -1`` from index i+1."""
    if k > 0:
        return F.pad(x[..., :-k], (k, 0))
    return F.pad(x[..., -k:], (0, -k))


def _down(x):
    return tuple(_shift(a, 1) for a in x)


def _up(x):
    return tuple(_shift(a, -1) for a in x)


def _cr_solve_blocks(bm, am, cm, rhs):
    """Solve the block-tridiagonal system by cyclic reduction.

    Component-plane tuples over (..., m): ``bm`` the diagonal blocks,
    ``am`` the coupling to block i-1 (zero at 0), ``cm`` to block i+1
    (zero at m-1), ``rhs`` the 2-vector planes; ``m`` a power of two.  The
    odd blocks are eliminated, the even half solved recursively, then the
    odd blocks back-substituted.
    """
    m = bm[0].shape[-1]
    if m == 1:
        return _mv2(_inv2(bm), rhs)

    def ev(x):
        return tuple(a[..., 0::2] for a in x)

    def od(x):
        return tuple(a[..., 1::2] for a in x)

    binv_o = _inv2(od(bm))
    a_o = od(am)
    c_o = od(cm)
    b_o = od(rhs)

    gl = _mul2(ev(am), _down(binv_o))
    gr = _mul2(ev(cm), binv_o)
    b_new = _sub2(_sub2(ev(bm), _mul2(gl, _down(c_o))), _mul2(gr, a_o))
    a_new = _neg2(_mul2(gl, _down(a_o)))
    c_new = _neg2(_mul2(gr, c_o))
    r_new = _sub2(_sub2(ev(rhs), _mv2(gl, _down(b_o))), _mv2(gr, b_o))

    x_even = _cr_solve_blocks(b_new, a_new, c_new, r_new)

    # x_{2j+1} = B^-1 (b - A x_{2j} - C x_{2j+2})
    x_odd = _mv2(
        binv_o, _sub2(_sub2(b_o, _mv2(a_o, x_even)), _mv2(c_o, _up(x_even)))
    )

    def interleave(e, o):
        return torch.stack([e, o], dim=-1).reshape(*e.shape[:-1], m)

    return (interleave(x_even[0], x_odd[0]), interleave(x_even[1], x_odd[1]))


def _penta_to_blocks(a0, a1, a2):
    """Pentadiagonal bands -> block-tridiagonal (B, A, C) component planes.

    ``a0`` (..., n), ``a1`` (..., n-1), ``a2`` (..., n-2), ``n`` even:
    scalar rows (2i, 2i+1) pair into block row i.
    """
    a1p = F.pad(a1, (0, 1))  # a1p[i] = A[i, i+1], zero at n-1
    a2p = F.pad(a2, (0, 2))  # a2p[i] = A[i, i+2], zero at n-2, n-1
    e0, e1 = a0[..., 0::2], a0[..., 1::2]
    s0, s1 = a1p[..., 0::2], a1p[..., 1::2]
    d0, d1 = a2p[..., 0::2], a2p[..., 1::2]
    bm = (e0, s0, s0, e1)
    cm = (d0, torch.zeros_like(d0), s1, d1)
    # A_i = C_{i-1}^T (symmetric system): transposed components, shifted down
    am = tuple(_shift(a, 1) for a in (cm[0], cm[2], cm[1], cm[3]))
    return bm, am, cm


def penta_solve_cr(a0, a1, a2, b):
    """Pentadiagonal solve by block cyclic reduction: the system of
    :func:`_penta_ldlt_solve` (bands broadcasting against ``b``'s leading
    dims), in log depth.  ``n`` is padded to the next power of two with
    identity rows that the zero off-diagonals keep apart from the live
    system."""
    n = b.shape[-1]
    lead = b.shape[:-1]
    a0 = a0.expand(*lead, n)
    a1 = a1.expand(*lead, n - 1)
    a2 = a2.expand(*lead, n - 2)
    n_pad = 1 << max(1, (n - 1).bit_length())
    if n_pad != n:
        a0 = F.pad(a0, (0, n_pad - n), value=1.0)
        a1 = F.pad(a1, (0, n_pad - n))
        a2 = F.pad(a2, (0, n_pad - n))
        b = F.pad(b, (0, n_pad - n))
    bm, am, cm = _penta_to_blocks(a0, a1, a2)
    x0, x1 = _cr_solve_blocks(bm, am, cm, (b[..., 0::2], b[..., 1::2]))
    x = torch.stack([x0, x1], dim=-1).reshape(*lead, n_pad)
    return x[..., :n]


def _penta_matvec(a0, a1, a2, x):
    """Symmetric pentadiagonal matvec from the three bands (batched)."""
    def sh(v, k):
        if k > 0:
            return F.pad(v[..., k:], (0, k))
        return F.pad(v[..., :k], (-k, 0))

    a1p = F.pad(a1, (0, 1))
    a2p = F.pad(a2, (0, 2))
    return (
        a0 * x
        + a1p * sh(x, 1) + sh(a1p * x, -1)
        + a2p * sh(x, 2) + sh(a2p * x, -2)
    )


def _weights(y, z, p: float):
    """``p (y > z) + (1 - p) (y < z)`` in ``y``'s dtype."""
    return (y > z).to(y.dtype) * p + (y < z).to(y.dtype) * (1.0 - p)


def als_baseline_raw(y, lam: float, p: float, n_iter: int):
    """AsLS baselines of real spectra ``y`` (..., n) in ``y``'s dtype with
    the scan solver (:func:`_penta_ldlt_solve`); zeros for ``n_iter = 0``."""
    n = y.shape[-1]
    m0, m1, m2 = _dtd_bands(n, y.dtype, y.device)
    w = torch.ones_like(y)
    z = torch.zeros_like(y)
    for _ in range(n_iter):
        z = _penta_ldlt_solve(w + lam * m0, lam * m1, lam * m2, w * y)
        w = _weights(y, z, p)
    return z


def _als_cr(rows, lam: float, p: float, n_iter: int, refine: int):
    """The AsLS iteration with the CR solve and a per-voxel monotone-residual
    safeguard: each solve (and each of ``refine`` correction re-solves) is
    kept for a voxel only if it does not raise the residual norm of
    ``(W + lam D^T D) z = W y``, else the previous iteration's baseline
    stays (in float64 the solves always win)."""
    n = rows.shape[-1]
    m0, m1, m2 = _dtd_bands(n, rows.dtype, rows.device)
    a1, a2 = lam * m1, lam * m2

    def dtd_apply(z):
        # D^T (D z) operator-wise: second differences of the smooth
        # baseline, free of the banded matvec's cancellation.
        d = z[..., 2:] - 2.0 * z[..., 1:-1] + z[..., :-2]
        return F.pad(d, (0, 2)) - 2.0 * F.pad(d, (1, 1)) + F.pad(d, (2, 0))

    def resid(w, z):
        return w * (rows - z) - lam * dtd_apply(z)

    def rnorm(r):
        return (r * r).sum(-1, keepdim=True)

    w = torch.ones_like(rows)
    z = torch.zeros_like(rows)
    for _ in range(n_iter):
        a0 = w + lam * m0
        z_new = penta_solve_cr(a0, a1, a2, w * rows)
        z_new = torch.where(rnorm(resid(w, z_new)) <= rnorm(resid(w, z)),
                            z_new, z)
        for _ in range(refine):
            r = resid(w, z_new)
            z_try = z_new + penta_solve_cr(a0, a1, a2, r)
            z_new = torch.where(rnorm(resid(w, z_try)) <= rnorm(r), z_try,
                                z_new)
        z = z_new
        w = _weights(rows, z, p)
    return z


def als_baseline_batched(rows, lam: float, p: float, n_iter: int,
                         solver: str = "auto", refine: int = 0, device=None):
    """AsLS baselines of a (n_voxels, n_points) batch of real spectra.

    ``rows`` is a tensor or an array; the work runs on ``device``, by
    default on ``rows``' device where it is a tensor, else on the card (a
    call with no card raises unless the caller passes ``device="cpu"``).
    Both solvers compute in float64 and return a tensor of the input's
    dtype on that device:

    * ``"cr"``: block cyclic reduction (:func:`penta_solve_cr`), log-depth,
      with the monotone-residual safeguard and ``refine`` extra safeguarded
      correction solves (default 0; float64 needs none);
    * ``"scan"``: the banded LDL^T, a Python loop over the points; exact,
      and fine on the CPU at test sizes, but on the card its ~3n dependent
      steps per solve make it slow: it runs there only when asked for;
    * ``"auto"`` (default): ``"cr"`` on a CUDA device, ``"scan"`` on the
      CPU.

    Host-call contract: see the module docstring; not for
    ``torch.compile`` or ``torch.func`` transforms.
    """
    if solver not in ("auto", "scan", "cr"):
        raise ValueError(
            f"solver must be 'scan', 'cr', or 'auto', got {solver!r}.")
    if device is None:
        device = rows.device if isinstance(rows, torch.Tensor) else "cuda"
    card_device(device, "AsLS")
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows))
    rows = rows.to(device)
    in_dtype = rows.dtype
    rows64 = rows.to(torch.float64)
    if solver == "auto":
        solver = "cr" if rows64.is_cuda else "scan"
    with torch.no_grad():
        if solver == "scan":
            z = als_baseline_raw(rows64, lam, p, n_iter)
        else:
            z = _als_cr(rows64, lam, p, n_iter, refine)
    return z.to(in_dtype)


def baseline_als(
    da: XmrArray,
    dim: str = DIMS.frequency,
    lam: float = 1e5,
    p: float = 0.001,
    n_iter: int = 10,
    solver: str = "auto",
    device="cuda",
) -> XmrArray:
    """Estimate and subtract a smooth AsLS baseline along ``dim``.

    Works on the real (absorption) part only: the imaginary part is
    dropped, as in the reference, so the result cannot be transformed back
    to a FID.  N-D inputs are flattened over the other dims and solved in
    one batch (:func:`als_baseline_batched`) on ``device`` (the card unless
    the caller passes ``"cpu"``).  The payload comes back as numpy for a
    numpy input and as a tensor on ``device`` for a tensor input; the attrs
    gain ``baseline_method="als"``, ``baseline_lam``, ``baseline_p`` and
    ``baseline_iter``.
    """
    _check_dims(da, dim, "baseline_als")
    is_complex = (da.data.is_complex() if isinstance(da.data, torch.Tensor)
                  else np.iscomplexobj(da.data))
    working = da.real if is_complex else da

    order = [d for d in da.dims if d != dim] + [dim]
    wt = working.transpose(*order)
    n_points = da.sizes[dim]
    data = wt.data
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.ascontiguousarray(data))
    rows = data.reshape(-1, n_points)
    z = als_baseline_batched(rows, float(lam), float(p), int(n_iter),
                             solver=solver, device=device)
    corrected = (rows.to(z.device) - z).reshape(tuple(wt.shape))
    if not isinstance(wt.data, torch.Tensor):
        corrected = corrected.cpu().numpy()

    out = wt.copy(data=corrected).transpose(*da.dims)
    out.attrs = da.attrs.copy()
    out.attrs[ATTRS.baseline_method] = "als"
    out.attrs[ATTRS.baseline_lam] = lam
    out.attrs[ATTRS.baseline_p] = p
    out.attrs[ATTRS.baseline_iter] = n_iter
    return out
