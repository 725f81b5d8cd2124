"""Planar (split real/imag) fused MRSI spectral stage (PyTorch port).

Port of :func:`xmris_tpu.parallel.planar_pipeline.spectral_pipeline_planar_raw`
on its kernel variant: window + zero-fill + ortho DFT + fftshift and the
per-voxel peak search in ONE kernel launch (K1), then the single-pivot
ACME autophase on the loudest row, applied to every voxel.
"""

from __future__ import annotations

import torch

from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.ops.kernels.dft_cuda import pallas_split_ok
from xmris_tpu_torch.ops.phasing import (
    _grid_phase_search,
    grid_phase_search_graphed,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig


def _apply_phase_planar(re, im, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    return re * c - im * s, re * s + im * c


def _solve_phase_on_row(row_re, row_im, freqs, pivot, cfg: PipelineConfig):
    """ACME (p0, p1) on one pivot spectrum row with the deterministic grid
    search (``cfg.ap_optimizer == "grid"``)."""
    if cfg.ap_optimizer != "grid":
        raise NotImplementedError(
            "ap_optimizer='de' (differential evolution) is not ported; use "
            "'grid' (see ROADMAP.md queue 1, item 7)"
        )
    # "auto" resolves to "gd" for one row in the reference too.
    if cfg.ap_polish not in ("auto", "gd"):
        raise NotImplementedError(
            f"ap_polish={cfg.ap_polish!r} is not ported (only 'gd'); see "
            "ROADMAP.md queue 1, item 7"
        )
    x_range = freqs[-1] - freqs[0]
    search = (grid_phase_search_graphed if row_re.is_cuda
              else _grid_phase_search)
    xs = search(
        row_re[None, :], row_im[None, :], freqs, x_range, pivot[None],
        cfg.p0_only,
    )
    p0 = xs[0, 0]
    p1 = torch.zeros_like(p0) if cfg.p0_only else xs[0, 1]
    return p0, p1


def _autophase_single_planar(re, im, freqs, cfg: PipelineConfig, peak):
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

    p0, p1 = _solve_phase_on_row(row_re, row_im, freqs, pivot, cfg)

    phi = (torch.deg2rad(p0)
           + torch.deg2rad(p1) * ((freqs - pivot) / x_range)).to(re.dtype)
    phi = phi.reshape(re.shape[-2:])[None] if stacked else phi[None, :]
    re, im = _apply_phase_planar(re, im, phi)
    return re, im, p0, p1, pivot


def spectral_pipeline_planar_raw(fids_re, fids_im, weight, freqs,
                                 cfg: PipelineConfig,
                                 kernels: KernelSet = DISPATCH):
    """Fused spectral stage on planar (B, n_time) float32 batches.

    ``weight`` is the (zero_fill_to,) apodization window on the zero-
    filled axis (its first n_time entries are applied), ``freqs`` the
    (zero_fill_to,) centred frequency axis.  Returns ``(spec_re, spec_im,
    (p0, p1, pivot))`` — spectra (B, n_out), or (B, n2, n1) with
    ``spec_layout="stacked"`` (flat k = k1 + n1*k2) — and 0-dim phase
    tensors (zeros for ``autophase="none"``).
    """
    if cfg.autophase == "all":
        raise NotImplementedError(
            "per-voxel autophase (autophase='all') is not ported; see "
            "ROADMAP.md queue 1, item 7"
        )
    b, n_time = fids_re.shape
    if not pallas_split_ok(n_time, cfg.zero_fill_to):
        raise ValueError(
            f"n_time={n_time} -> zero_fill_to={cfg.zero_fill_to} has no "
            "Cooley-Tukey split for the spectrum kernel"
        )
    want_peak = cfg.autophase == "single"
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
    voxel_idx = torch.argmax(mv)  # first occurrence, like jnp.argmax
    peak = (voxel_idx, mi[voxel_idx].long())
    spec_re, spec_im, p0, p1, pivot = _autophase_single_planar(
        spec_re, spec_im, freqs, cfg, peak
    )
    return spec_re, spec_im, (p0, p1, pivot)
