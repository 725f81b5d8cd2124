"""K5: the fused backtracking-GD ACME phase polish; K5s: the one-row search.

Replaces ``xmris_tpu/ops/kernels/acme_pallas.py::acme_polish_pallas``: the
whole gradient-descent polish of every voxel's (p0, p1) on the ACME
objective, with the closed-form gradient, in one launch.  The CUDA source
is ``csrc/acme.cu``; its header comment gives the bound on the H100 and the
design.

:func:`acme_polish_plain` is the same loop in plain PyTorch with the same
analytic gradient (not autograd); its sums accumulate in float64 and are
rounded to the working dtype once.  It is what the CPU runs and what the
card checks the kernel against, by the tolerances of the reference's
tests: one evaluation's score and gradient within rtol 1e-5, and after the
40-step polish, where a backtracking accept test turns an ulp into another
trajectory, scores within x1.02 of each other and phases by share.  The
kernel rounds each per-point term as the twin does and sums in float64
(its divisions take a reciprocal and one correction, still correctly
rounded), because with float32 sums half the bench voxels' phases left
that share; ``csrc/acme.cu`` says more.  The wrapper :func:`acme_polish`
runs the twin for CPU tensors and the kernel for CUDA tensors.

K5s (:func:`acme_search`, ``xmt_acme_search`` in the same source) is the
single-pivot grid search of ``ops/phasing.py::_grid_phase_search`` on one
row, scan and gd polish, in one launch of one block that reads the pivot
row and the pivot from the spectra at the device-side peak indices.  Its
twin :func:`acme_search_plain` is the kernel's arithmetic: the scan scores
every candidate with :func:`_value_grad`'s score (float64 sums) and keeps
the winner by the torch scan's rule at chunks of 16, then the polish is
:func:`_polish`, K5's.
"""

from __future__ import annotations

import math

import torch

from xmris_tpu_torch.ops.kernels import _build, _counters

D2R = math.pi / 180.0
SPAN = (360.0, 8000.0)
HALF_CELL = 0.5 / 36.0
MAX_POINTS = 4096  # kPer * kMaxThreads of the kernel
# The single-pivot search (ops/phasing.py's constants): the candidate meshes
# as (first, step, count), each candidate first + step * i exact in float32
# (the p0 mesh on [-180, 180), the p1 mesh on [-4000, 4000], the p0
# refinement a cell and a half either side), the candidates scored at a
# time (the scan's cand_chunk on the card) and the polish's steps.
SEARCH_MESHES = ((-180.0, 10.0, 36), (-4000.0, 200.0, 41), (-15.0, 5.0, 7))
SEARCH_CHUNK = 16
SEARCH_ITERS = 40


def _sum(x):
    """Row sums accumulated in float64, rounded to ``x``'s dtype once."""
    return x.sum(-1, dtype=torch.float64).to(x.dtype)


def _finite(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _div(a, b):
    """``a / b`` as one correctly rounded division: on the card PyTorch
    divides by a Python scalar (and divides a Python scalar by a tensor)
    through a reciprocal, two roundings where the kernel has one."""
    def as_tensor(x, like):
        if isinstance(x, torch.Tensor):
            return x
        return torch.full((), x, dtype=like.dtype, device=like.device)
    like = a if isinstance(a, torch.Tensor) else b
    return torch.div(as_tensor(a, like), as_tensor(b, like))


def _value_grad(re, im, u, p0, p1, p0_only: bool):
    """ACME score (B,) and its gradient (B,), (B,) in degrees at (p0, p1);
    ``re``/``im``/``u`` are (B, n) rows.  The reference's
    ``_acme_value_grad``, term by term."""
    n = re.shape[-1]
    zero = torch.zeros((), dtype=re.dtype, device=re.device)
    phi = (p0[:, None] + p1[:, None] * u) * D2R
    s, c = torch.sin(phi), torch.cos(phi)
    d = re * c - im * s
    q = -(re * s + im * c)

    # First-difference magnitude distribution (guarded entropy).
    delta = torch.cat([d[:, 1:] - d[:, :-1], torch.zeros_like(d[:, :1])], 1)
    ds1 = delta.abs() * 0.5
    mind = torch.where(d >= 0, zero, d)  # min(d, 0), NaN kept
    s1 = _sum(ds1)
    neg = _sum(2.0 * mind) < 0
    pen = torch.where(neg, _sum(mind * mind), zero)
    m = torch.amax(d, dim=1)
    pos = ds1 > 0
    logp = torch.where(
        pos, torch.log(torch.where(pos, ds1, torch.ones_like(ds1)))
        - torch.log(s1)[:, None], zero,
    )
    h = -_sum(torch.where(pos, (ds1 / s1[:, None]) * logp, zero))
    is_max = (d == m[:, None]).to(d.dtype)
    ties = _sum(is_max)
    num = h + 1000.0 * pen
    denom = n * m
    score = torch.where(m > 0, num / denom, torch.full_like(m, math.inf))

    # d(score)/d(d_i): entropy through the first difference, the penalty's
    # taken branch, and the tie-averaged max normalization.
    dh = (torch.where(pos, -(logp + 1.0), zero) + (1.0 - h)[:, None]) / s1[:, None]
    ck = (dh * torch.sign(delta)) * 0.5
    ck[:, -1] = 0.0
    gh = torch.cat([torch.zeros_like(ck[:, :1]), ck[:, :-1]], 1) - ck
    gp = torch.where(neg[:, None], 2.0 * mind, zero)
    gm = is_max / ties[:, None]
    gd = (gh + 1000.0 * gp) / denom[:, None] - (num / (denom * m))[:, None] * gm
    t0 = gd * q
    live = m > 0
    g0 = torch.where(live, _sum(t0) * D2R, zero)
    g1 = zero.expand_as(g0) if p0_only else torch.where(
        live, _sum(t0 * u) * D2R, zero)
    return score, g0, g1


def acme_polish_plain(rows_re, rows_im, coords, pivots, p_init, x_range, *,
                      n_iter: int = 40, p0_only: bool = False,
                      half_cell: float = HALF_CELL, span=SPAN,
                      with_grad: bool = False):
    """Plain K5: ``(p (B, 2), score (B,))`` after ``n_iter`` polish steps
    from ``p_init`` (B, 2) degrees; with ``with_grad`` also the gradient at
    ``p_init`` (B, 2).  ``pivots`` are per-voxel pivot coordinate values."""
    _counters.plain_called("acme_polish")
    _check(rows_re, rows_im, coords, pivots, p_init)
    u = _div(coords[None, :] - pivots[:, None], float(x_range))
    return _polish(rows_re, rows_im, u, p_init, n_iter=n_iter,
                   p0_only=p0_only, half_cell=half_cell, span=span,
                   with_grad=with_grad)


def _polish(rows_re, rows_im, u, p_init, *, n_iter: int, p0_only: bool,
            half_cell: float = HALF_CELL, span=SPAN, with_grad: bool = False):
    """K5's loop on (B, n) rows with their unit coordinates ``u`` (B, n):
    :func:`acme_polish_plain` past its checks."""
    span0, span1 = float(span[0]), float(span[1])
    p0 = p_init[:, 0].clone()
    p1 = p_init[:, 1].clone()

    def vg(a0, a1):
        return _value_grad(rows_re, rows_im, u, a0,
                           torch.zeros_like(a1) if p0_only else a1, p0_only)

    f, gc0, gc1 = vg(p0, p1)
    grad0 = torch.stack([gc0, gc1], 1)
    gmax = torch.maximum((_finite(gc0) * span0).abs(),
                         (_finite(gc1) * span1).abs())
    tiny = torch.finfo(rows_re.dtype).tiny
    lr = torch.where(gmax > 0, _div(half_cell, torch.clamp(gmax, min=tiny)),
                     torch.full_like(gmax, 1e-2))
    for _ in range(n_iter):
        q0 = p0 - (lr * (_finite(gc0) * span0)) * span0
        q1 = p1 - (lr * (_finite(gc1) * span1)) * span1
        q0 = q0 - 360.0 * torch.floor(_div(q0 + 180.0, 360.0))
        if not p0_only:
            q1 = torch.clamp(q1, -4000.0, 4000.0)
        fn, gn0, gn1 = vg(q0, q1)
        better = fn < f
        p0 = torch.where(better, q0, p0)
        p1 = torch.where(better, q1, p1)
        f = torch.where(better, fn, f)
        gc0 = torch.where(better, gn0, gc0)
        gc1 = torch.where(better, gn1, gc1)
        lr = torch.where(better, lr * 1.2, lr * 0.5)
    p = torch.stack([p0, p1], 1)
    return (p, f, grad0) if with_grad else (p, f)


def search_plan(n: int, p0_only: bool, n_iter: int = SEARCH_ITERS):
    """``(dec, n_coarse, n_fine)`` of the search on an ``n``-point row, as
    ``_grid_phase_search`` runs it: the scan's stride ``n // 512`` (at
    least 1), and the ``n_iter`` polish steps split between the decimated
    row (p0 only, where the stride is past 1: all but max(n_iter // 3, 8))
    and the whole row."""
    dec = max(1, n // 512)
    fine = (min(n_iter, max(n_iter // 3, 8)) if p0_only and dec > 1
            else n_iter)
    return dec, n_iter - fine, fine


def _scan_scores(re, im, u, p0, p1):
    """The scores (C,) of the candidate phases ``p0``, ``p1`` (C,) on one
    (1, n) row: :func:`_value_grad`'s score."""
    c = p0.shape[0]
    return _value_grad(re.expand(c, -1), im.expand(c, -1), u.expand(c, -1),
                       p0, p1, False)[0]


def _scan_plain(re, im, u, p0_only: bool):
    """The scan's winner (1, 2) degrees on (1, n) decimated rows and their
    unit coordinates: p0 on the first mesh; for p0 + p1 then p1 given p0
    and the p0 refinement.  A stage scores its candidates with
    :func:`_scan_scores`; chunk by chunk of :data:`SEARCH_CHUNK`, the
    chunk's ``argmin`` (a NaN wins it) replaces the running best only if
    strictly lower, so ties go to the first candidate and a stage with no
    finite winner gives 0 (``_grid_phase_search``'s ``scan_axis``)."""
    zero = torch.zeros((), dtype=re.dtype, device=re.device)

    def stage(mesh, b0, b1, axis):
        first, step, count = mesh
        c = first + step * torch.arange(count, dtype=re.dtype, device=re.device)
        p0 = b0 + c if axis == 0 else b0.expand(count)
        p1 = b1 + c if axis == 1 else b1.expand(count)
        e = _scan_scores(re, im, u, p0, p1)
        won = p0 if axis == 0 else p1
        best_e = torch.full((), math.inf, dtype=re.dtype, device=re.device)
        best_v = zero
        for start in range(0, count, SEARCH_CHUNK):
            i = start + torch.argmin(e[start:start + SEARCH_CHUNK])
            better = e[i] < best_e
            best_e = torch.where(better, e[i], best_e)
            best_v = torch.where(better, won[i], best_v)
        return best_v

    p0 = stage(SEARCH_MESHES[0], zero, zero, 0)
    p1 = zero
    if not p0_only:
        p1 = stage(SEARCH_MESHES[1], p0, zero, 1)
        p0 = stage(SEARCH_MESHES[2], p0, p1, 0)
    return torch.stack([p0, p1])[None]


def acme_search_plain(spec_re, spec_im, freqs, voxel_idx, freq_idx, *,
                      p0_only: bool = False, n_iter: int = SEARCH_ITERS):
    """Plain K5s: ACME (p0, p1) (1, 2) degrees of the row ``voxel_idx`` of
    the spectra (B, ...) (a voxel's trailing dims flatten to its
    ``n_f``-point row), pivoted at ``freqs[freq_idx]``: the scan on the row
    decimated by :func:`search_plan`'s stride (:func:`_scan_plain`), then
    K5's polish, ``n_iter`` steps on the whole row, or for p0 only the
    first ``n_coarse`` of them on the decimated row (``n_iter=0``: the
    scan's winner)."""
    _counters.plain_called("acme_search")
    n = freqs.shape[0]
    re, im = (x.reshape(x.shape[0], n).index_select(0, voxel_idx.reshape(1))
              for x in (spec_re, spec_im))
    piv = freqs.index_select(0, freq_idx.reshape(1))
    u = _div(freqs[None, :] - piv[:, None], freqs[-1] - freqs[0])
    dec, n_coarse, n_fine = search_plan(n, p0_only, n_iter)
    p = _scan_plain(re[:, ::dec], im[:, ::dec], u[:, ::dec], p0_only)
    if n_coarse:
        p = _polish(re[:, ::dec], im[:, ::dec], u[:, ::dec], p,
                    n_iter=n_coarse, p0_only=True)[0]
    return _polish(re, im, u, p, n_iter=n_fine, p0_only=p0_only)[0]


def _check(rows_re, rows_im, coords, pivots, p_init):
    if rows_re.dim() != 2 or rows_im.shape != rows_re.shape:
        raise ValueError(
            f"rows must be matching (B, n_f) planes, got {tuple(rows_re.shape)} "
            f"and {tuple(rows_im.shape)}"
        )
    b, n = rows_re.shape
    if coords.shape != (n,) or pivots.shape != (b,) or p_init.shape != (b, 2):
        raise ValueError("coords must be (n_f,), pivots (B,) and p_init (B, 2)")
    for x in (rows_im, coords, pivots, p_init):
        if x.device != rows_re.device or x.dtype != rows_re.dtype:
            raise ValueError("acme_polish inputs must share one device and dtype")


def acme_polish(rows_re, rows_im, coords, pivots, p_init, x_range, *,
                n_iter: int = 40, p0_only: bool = False,
                half_cell: float = HALF_CELL, span=SPAN,
                with_grad: bool = False):
    """K5: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Same contract as :func:`acme_polish_plain`; the kernel takes float32
    contiguous rows of 2 <= n_f <= 4096 points.
    """
    if rows_re.device.type == "cpu":
        return acme_polish_plain(
            rows_re, rows_im, coords, pivots, p_init, x_range, n_iter=n_iter,
            p0_only=p0_only, half_cell=half_cell, span=span,
            with_grad=with_grad,
        )
    if rows_re.device.type != "cuda":
        raise ValueError(f"acme_polish: unsupported device {rows_re.device}")
    _check(rows_re, rows_im, coords, pivots, p_init)
    if rows_re.dtype != torch.float32:
        raise TypeError("the ACME polish kernel takes float32")
    b, n = rows_re.shape
    if not 2 <= n <= MAX_POINTS:
        raise ValueError(f"n_f={n} outside the kernel's 2..{MAX_POINTS}")
    args = (rows_re, rows_im, coords, pivots, p_init)
    if not all(a.is_contiguous() for a in args):
        raise ValueError("acme_polish inputs must be contiguous")
    p_out = torch.empty((b, 2), dtype=torch.float32, device=rows_re.device)
    f_out = torch.empty((b,), dtype=torch.float32, device=rows_re.device)
    g_out = torch.empty_like(p_out) if with_grad else None
    err = _build.library().xmt_acme_polish(
        *(a.data_ptr() for a in args), p_out.data_ptr(), f_out.data_ptr(),
        g_out.data_ptr() if with_grad else None, b, n, float(x_range),
        int(n_iter), int(bool(p0_only)), float(half_cell), float(span[0]),
        float(span[1]), _build.stream_ptr(rows_re.device),
    )
    _build.check("xmt_acme_polish", err)
    _counters.launched("acme_polish")
    return (p_out, f_out, g_out) if with_grad else (p_out, f_out)


def _search_rows(x, n: int):
    """(B, n) rows of spectra (B, ...): a view where the layout allows."""
    rows = x.reshape(x.shape[0], -1)
    if rows.shape[1] != n or rows.stride(1) != 1:
        raise ValueError(
            f"acme_search: each voxel must flatten to {n} contiguous points, "
            f"got shape {tuple(x.shape)} and strides {tuple(x.stride())}"
        )
    return rows


def acme_search(spec_re, spec_im, freqs, voxel_idx, freq_idx, *,
                p0_only: bool = False, n_iter: int = SEARCH_ITERS):
    """K5s: the plain version for CPU tensors, the CUDA kernel for CUDA ones.

    Same contract as :func:`acme_search_plain`; the kernel takes float32
    spectra whose voxels each flatten to ``n_f`` contiguous points at any
    voxel stride, 2 <= n_f <= 4096, contiguous float32 ``freqs`` and int64
    indices on the same card, and reads them where they lie.
    """
    if spec_re.device.type == "cpu":
        return acme_search_plain(spec_re, spec_im, freqs, voxel_idx,
                                 freq_idx, p0_only=p0_only, n_iter=n_iter)
    if spec_re.device.type != "cuda":
        raise ValueError(f"acme_search: unsupported device {spec_re.device}")
    n = freqs.shape[0]
    for x in (spec_im, freqs, voxel_idx, freq_idx):
        if x.device != spec_re.device:
            raise ValueError("acme_search inputs must share one device")
    if not (spec_re.dtype == spec_im.dtype == freqs.dtype == torch.float32):
        raise TypeError("the ACME search kernel takes float32")
    if not 2 <= n <= MAX_POINTS:
        raise ValueError(f"n_f={n} outside the kernel's 2..{MAX_POINTS}")
    if (voxel_idx.dtype != torch.int64 or freq_idx.dtype != torch.int64
            or voxel_idx.numel() != 1 or freq_idx.numel() != 1):
        raise ValueError("acme_search: voxel_idx and freq_idx must be one "
                         "int64 index each")
    if freqs.dim() != 1 or not freqs.is_contiguous():
        raise ValueError("acme_search: freqs must be a contiguous (n_f,) axis")
    re, im = _search_rows(spec_re, n), _search_rows(spec_im, n)
    dec, n_coarse, n_fine = search_plan(n, p0_only, n_iter)
    p_out = torch.empty((1, 2), dtype=torch.float32, device=spec_re.device)
    err = _build.library().xmt_acme_search(
        re.data_ptr(), im.data_ptr(), re.stride(0), im.stride(0),
        freqs.data_ptr(), voxel_idx.data_ptr(), freq_idx.data_ptr(),
        p_out.data_ptr(), n, dec, int(bool(p0_only)), n_coarse, n_fine,
        HALF_CELL, float(SPAN[0]), float(SPAN[1]),
        _build.stream_ptr(spec_re.device),
    )
    _build.check("xmt_acme_search", err)
    _counters.launched("acme_search")
    return p_out
