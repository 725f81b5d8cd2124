"""ACME phase search on a spectrum row (PyTorch port).

Port of the single-row path of :mod:`xmris_tpu.ops.phasing`: the ACME
objective (:func:`acme_score_raw`), the planar phased real part
(:func:`_phased_real_planar`) and :func:`_grid_phase_search` — the
deterministic candidate scan plus backtracking gradient-descent polish that
``ap_optimizer="grid"`` runs on the pivot row.  The gradients come from
autograd, as the reference takes them from ``jax.value_and_grad``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _phased_real_planar(re, im, coords, p0, p1, pivot, x_range):
    """Real part of the phased spectrum from split planes.

    ``re``/``im`` are (..., n) rows; ``p0``/``p1`` (degrees) broadcast
    against the leading dims.
    """
    phi = torch.deg2rad(p0)[..., None] + torch.deg2rad(p1)[..., None] * (
        (coords - pivot) / x_range
    )
    return re * torch.cos(phi) - im * torch.sin(phi)


def acme_score_raw(real_data):
    """ACME objective over the last axis: entropy of |first derivative|
    plus the negative-area penalty, normalized by length and the maximum of
    the real part; ``+inf`` where that maximum is not positive."""
    ds1 = torch.abs((real_data[..., 1:] - real_data[..., :-1]) / 2.0)
    p1_prob = ds1 / ds1.sum(-1, keepdim=True)
    p1_prob = torch.where(p1_prob == 0, torch.ones_like(p1_prob), p1_prob)
    h1s = (-p1_prob * torch.log(p1_prob)).sum(-1)

    as_ = real_data - torch.abs(real_data)
    sumas = as_.sum(-1)
    pfun = torch.where(
        sumas < 0, ((as_ / 2.0) ** 2).sum(-1), torch.zeros_like(sumas)
    )
    denom = real_data.max(-1).values
    score = (h1s + 1000.0 * pfun) / real_data.shape[-1] / denom
    return torch.where(denom > 0, score, torch.full_like(score, math.inf))


# The reference's single-row settings: candidate meshes and polish length.
N_P0 = 36
N_P1 = 41
POLISH_ITERS = 40


@functools.lru_cache(maxsize=16)
def _search_constants(dtype, device: str):
    """Candidate meshes and the unit-space span as tensors on ``device``
    (made once, outside any CUDA-graph capture)."""
    step = 360.0 / N_P0
    meshes = (
        np.linspace(-180.0, 180.0, N_P0, endpoint=False),
        np.linspace(-4000.0, 4000.0, N_P1),
        np.linspace(-1.5 * step, 1.5 * step, 7),
        np.asarray([360.0, 8000.0]),
    )
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in meshes)


def _grid_phase_search(rows_re, rows_im, coords, x_range, pivots,
                       p0_only: bool):
    """Phase search on (V, n_f) rows: candidate scan + gradient polish.

    The reference's ``_grid_phase_search`` for the ACME objective with the
    ``"gd"`` polish and its single-row settings (:data:`N_P0`, :data:`N_P1`,
    :data:`POLISH_ITERS`).  The scan scores candidates on the rows decimated to
    ~512 points (stride ``n_f // 512``): p0 on a 36-point mesh; for p0 + p1
    a coordinate descent (marginal p0, then p1 given p0 on a 41-point mesh,
    then a 7-point p0 refinement).  Ties go to the first candidate and a
    voxel whose every candidate scores ``inf`` keeps 0, as the reference's
    chunked scan does.  The polish is the reference's backtracking gradient
    descent in unit space (span 360 / 8000), with p0 wrapped into
    [-180, 180) and p1 clipped to [-4000, 4000]; for p0 only, the first
    iterations run on the decimated rows.  Returns (V, 2) degrees.
    """
    dtype = rows_re.dtype
    dev = rows_re.device
    v, n_f = rows_re.shape
    dec = max(1, n_f // 512)
    rows_re_d = rows_re[:, ::dec]
    rows_im_d = rows_im[:, ::dec]
    coords_d = coords[::dec]
    piv = pivots[:, None]  # (V, 1) broadcasts against candidates
    p0_c, p1_c, dp0, span = _search_constants(dtype, str(dev))

    def scan_axis(c, p0_base, p1_base, axis):
        """Score ``base + c`` for every candidate ``c`` along one axis,
        holding the other at its per-voxel base; per-voxel winner."""
        p0v = p0_base[:, None] + (c if axis == 0 else torch.zeros_like(c))
        p1v = p1_base[:, None] + (c if axis == 1 else torch.zeros_like(c))
        d = _phased_real_planar(
            rows_re_d[:, None, :], rows_im_d[:, None, :], coords_d, p0v, p1v,
            piv[:, :, None], x_range,
        )
        e = acme_score_raw(d)  # (V, C)
        e = torch.where(torch.isnan(e), torch.full_like(e, math.inf), e)
        i = torch.argmin(e, dim=1)
        e_min = e.gather(1, i[:, None])[:, 0]
        base = p0_base if axis == 0 else p1_base
        return torch.where(e_min < math.inf, base + c[i],
                           torch.zeros_like(base))

    zero_v = torch.zeros((v,), dtype=dtype, device=dev)
    if p0_only:
        best_p = torch.stack([scan_axis(p0_c, zero_v, zero_v, 0), zero_v], 1)
    else:
        p0_a = scan_axis(p0_c, zero_v, zero_v, 0)
        p1_b = scan_axis(p1_c, p0_a, zero_v, 1)
        p0_r = scan_axis(dp0, p0_a, p1_b, 0)
        best_p = torch.stack([p0_r, p1_b], dim=1)

    def wrap_params(p):
        p0 = torch.remainder(p[:, 0] + 180.0, 360.0) - 180.0
        p1 = torch.clamp(p[:, 1], -4000.0, 4000.0)
        return torch.stack([p0, p1], dim=1)

    def finite(g):
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    def polish(best_p, re_, im_, crd, iters):
        def value_and_grad(p):
            with torch.enable_grad():
                pv = p.detach().requires_grad_(True)
                p1 = torch.zeros_like(pv[:, 1]) if p0_only else pv[:, 1]
                f = acme_score_raw(
                    _phased_real_planar(re_, im_, crd, pv[:, 0], p1, piv,
                                        x_range)
                )
                (grad,) = torch.autograd.grad(f.sum(), pv)
            return f.detach(), grad

        f, g_raw = value_and_grad(best_p)
        # First trial step spans about half a mesh cell.
        g0 = finite(g_raw) * span
        half_cell = 0.5 / N_P0
        gmax = g0.abs().max(dim=1).values
        lr = half_cell / torch.clamp(gmax, min=torch.finfo(dtype).tiny)
        lr = torch.where(gmax > 0, lr, torch.full_like(lr, 1e-2))
        p = best_p
        for _ in range(iters):
            g = finite(g_raw) * span
            p_new = wrap_params(p - (lr[:, None] * g) * span)
            f_new, g_new = value_and_grad(p_new)
            better = f_new < f
            p = torch.where(better[:, None], p_new, p)
            f = torch.where(better, f_new, f)
            g_raw = torch.where(better[:, None], g_new, g_raw)
            lr = torch.where(better, lr * 1.2, lr * 0.5)
        return p

    # The two-phase polish (decimated first) is quality-neutral only for
    # the 1-D p0 search; p0 + p1 polishes on the exact objective.
    if p0_only and dec > 1:
        fine_iters = max(POLISH_ITERS // 3, 8)
        best_p = polish(best_p, rows_re_d, rows_im_d, coords_d,
                        POLISH_ITERS - fine_iters)
    else:
        fine_iters = POLISH_ITERS
    return polish(best_p, rows_re, rows_im, coords, fine_iters)


# (device, shape, dtype, p0_only) -> (graph, static inputs, static output)
_GRAPHS: dict = {}


def grid_phase_search_graphed(rows_re, rows_im, coords, x_range, pivots,
                              p0_only: bool):
    """:func:`_grid_phase_search` on CUDA tensors, replayed from a CUDA graph.

    The eager search on one row issues thousands of small kernels (the scan,
    then 40 forward + backward polish steps), which the host launches far
    slower than the device runs them.  The search has no host synchronisation, so
    it is captured once per (device, shape, dtype, ``p0_only``) — after two
    eager warm-up runs on a side stream — and each later call copies its
    inputs into the captured buffers and replays the same kernels: the
    results equal the eager search's on the same device.
    """
    args = (rows_re, rows_im, coords, x_range, pivots)
    key = (rows_re.device, tuple(rows_re.shape), tuple(coords.shape),
           rows_re.dtype, bool(p0_only))
    if key not in _GRAPHS:
        static = [a.clone() for a in args]
        side = torch.cuda.Stream(rows_re.device)
        side.wait_stream(torch.cuda.current_stream(rows_re.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                _grid_phase_search(*static, p0_only)
        torch.cuda.current_stream(rows_re.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _grid_phase_search(*static, p0_only)
        _GRAPHS[key] = (graph, static, out)
    graph, static, out = _GRAPHS[key]
    for dst, src in zip(static, args):
        dst.copy_(src)
    graph.replay()
    return out.clone()
