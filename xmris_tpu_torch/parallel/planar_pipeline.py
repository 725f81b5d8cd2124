"""Planar (split real/imag) fused MRSI spectral stage (PyTorch port).

Port of :func:`xmris_tpu.parallel.planar_pipeline.spectral_pipeline_planar_raw`
on its kernel variant: window + zero-fill + ortho DFT + fftshift and the
per-voxel peak search in ONE kernel launch (K1), then the ACME autophase:
on the grid's loudest row, applied to every voxel (``autophase="single"``),
or on every voxel with its own pivot (``autophase="all"``).  The search is
differential evolution (``ap_optimizer="de"``, the default) or the
candidate grid, whose per-voxel polish is kernel K5 on the card
(``ap_polish="auto"``/``"fused"``) or the torch gd, Newton or BFGS polish.
"""

from __future__ import annotations

import torch

from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.ops.phasing import (
    _de_phase_search,
    _grid_phase_search,
    grid_phase_search_graphed,
    resolve_polish,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig


def _apply_phase_planar(re, im, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    return re * c - im * s, re * s + im * c


def _solve_phase_on_row(row_re, row_im, freqs, pivot, cfg: PipelineConfig,
                        kernels: KernelSet = DISPATCH):
    """ACME (p0, p1) on one pivot spectrum row: differential evolution
    (``cfg.ap_optimizer == "de"``, seeded from ``cfg.de_seed``) or the
    deterministic grid search.  On the card the gd grid search is replayed
    from a CUDA graph; ``"auto"`` resolves to gd for one row, as in the
    reference; ``"newton"``/``"bfgs"`` run eagerly."""
    x_range = freqs[-1] - freqs[0]
    args = (row_re[None, :], row_im[None, :], freqs, x_range, pivot[None])
    if cfg.ap_optimizer == "de":
        xs = _de_phase_search(*args, cfg.p0_only, seed=cfg.de_seed,
                              popsize=cfg.de_popsize, maxiter=cfg.de_maxiter)
    elif row_re.is_cuda and resolve_polish(cfg.ap_polish, args[0]) == "gd":
        xs = grid_phase_search_graphed(*args, cfg.p0_only)
    else:
        xs = _grid_phase_search(*args, cfg.p0_only,
                                polish_optimizer=cfg.ap_polish, cand_chunk=16,
                                kernels=kernels)
    p0 = xs[0, 0]
    p1 = torch.zeros_like(p0) if cfg.p0_only else xs[0, 1]
    return p0, p1


def _autophase_single_planar(re, im, freqs, cfg: PipelineConfig, peak,
                             kernels: KernelSet = DISPATCH):
    """Phase every voxel with the ACME solution of the grid's loudest row.

    Takes flat (B, n_freq) or stacked (B, n2, n1) spectra (a voxel's
    stacked block is its flat spectrum in memory) and ``peak = (voxel_idx,
    freq_idx)`` from the in-kernel peak search.
    """
    stacked = re.dim() == 3
    n_freq = freqs.shape[0]
    voxel_idx, freq_idx = peak
    pivot = freqs[freq_idx]
    x_range = freqs[-1] - freqs[0]
    row_re = re[voxel_idx].reshape(n_freq)
    row_im = im[voxel_idx].reshape(n_freq)

    p0, p1 = _solve_phase_on_row(row_re, row_im, freqs, pivot, cfg, kernels)

    phi = (torch.deg2rad(p0)
           + torch.deg2rad(p1) * ((freqs - pivot) / x_range)).to(re.dtype)
    phi = phi.reshape(re.shape[-2:])[None] if stacked else phi[None, :]
    re, im = _apply_phase_planar(re, im, phi)
    return re, im, p0, p1, pivot


def _autophase_all_planar(re, im, freqs, cfg: PipelineConfig, t_idx,
                          kernels: KernelSet = DISPATCH):
    """Per-voxel ACME autophase of flat (B, n_freq) spectra: each voxel's
    pivot is its own peak ``freqs[t_idx]`` (the in-kernel peak search, the
    first maximum of |S|^2 as the reference's ``argmax``), then one
    differential evolution per voxel (:func:`_de_phase_search`, in voxel
    chunks) or the batched grid search (:func:`_grid_phase_search`), and a
    per-voxel rotation."""
    x_range = freqs[-1] - freqs[0]
    pivots = freqs[t_idx]
    if cfg.ap_optimizer == "de":
        xs = _de_phase_search(re, im, freqs, x_range, pivots, cfg.p0_only,
                              seed=cfg.de_seed, popsize=cfg.de_popsize,
                              maxiter=cfg.de_maxiter)
    else:
        xs = _grid_phase_search(re, im, freqs, x_range, pivots, cfg.p0_only,
                                t_idx=t_idx, polish_optimizer=cfg.ap_polish,
                                kernels=kernels)
    p0s = xs[:, 0]
    p1s = torch.zeros_like(p0s) if cfg.p0_only else xs[:, 1]
    phi = (
        torch.deg2rad(p0s)[:, None]
        + torch.deg2rad(p1s)[:, None] * ((freqs[None, :] - pivots[:, None]) / x_range)
    ).to(re.dtype)
    re, im = _apply_phase_planar(re, im, phi)
    return re, im, p0s, p1s, pivots


def spectral_pipeline_planar_raw(fids_re, fids_im, weight, freqs,
                                 cfg: PipelineConfig,
                                 kernels: KernelSet = DISPATCH):
    """Fused spectral stage on planar (B, n_time) float32 batches.

    ``weight`` is the (zero_fill_to,) apodization window on the zero-
    filled axis (its first n_time entries are applied), ``freqs`` the
    (zero_fill_to,) centred frequency axis.  Returns ``(spec_re, spec_im,
    (p0, p1, pivot))`` — spectra (B, n_out), or (B, n2, n1) with
    ``spec_layout="stacked"`` (flat k = k1 + n1*k2) — with 0-dim phase
    tensors (zeros for ``autophase="none"``), or (B,) per-voxel phases and
    pivots for ``autophase="all"``.  Every zero-fill runs (K1's FFT or split
    kernel, or the dense route; ``dft_cuda.route``); the stacked layout
    needs a Cooley-Tukey split and ``zero_fill_to < n_time`` raises
    ``ValueError``, as in the reference.
    """
    b, n_time = fids_re.shape
    want_peak = cfg.autophase in ("single", "all")
    out = kernels.spectrum(
        fids_re, fids_im, cfg.zero_fill_to,
        window=weight[:n_time].to(fids_re.dtype).contiguous(),
        with_maxmag=want_peak,
        stacked_out=cfg.spec_layout == "stacked",
    )
    if not want_peak:
        zero = torch.zeros((), dtype=fids_re.dtype, device=fids_re.device)
        return out[0], out[1], (zero, zero, zero)
    spec_re, spec_im, mv, mi = out
    if cfg.autophase == "all":
        spec_re, spec_im, p0, p1, pivot = _autophase_all_planar(
            spec_re, spec_im, freqs, cfg, mi.long(), kernels
        )
        return spec_re, spec_im, (p0, p1, pivot)
    voxel_idx = torch.argmax(mv)  # first occurrence, like jnp.argmax
    peak = (voxel_idx, mi[voxel_idx].long())
    spec_re, spec_im, p0, p1, pivot = _autophase_single_planar(
        spec_re, spec_im, freqs, cfg, peak, kernels
    )
    return spec_re, spec_im, (p0, p1, pivot)
