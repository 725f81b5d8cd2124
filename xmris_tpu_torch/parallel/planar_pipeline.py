"""Planar (split real/imag) fused MRSI spectral stage (PyTorch port).

Port of :func:`xmris_tpu.parallel.planar_pipeline.spectral_pipeline_planar_raw`:
window + zero-fill + ortho DFT + fftshift, then the ACME autophase: on the
grid's loudest row, applied to every voxel (``autophase="single"``), or on
every voxel with its own pivot (``autophase="all"``).  The transform is
``cfg.dft_variant``'s: kernel K1 for None and ``"pallas"`` (the spectra and
each voxel's peak in ONE launch), or a matmul DFT of
:mod:`xmris_tpu_torch.ops.kernels.dft` where the payload lies (the peak
then read from its spectra).  The search is differential evolution
(``ap_optimizer="de"``, the default) or the candidate grid, whose per-voxel
polish is kernel K5 on the card (``ap_polish="auto"``/``"fused"``) or the
torch gd, Newton or BFGS polish.
"""

from __future__ import annotations

import torch

from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.ops.kernels.dft import (
    DEFAULT_VARIANT,
    _check_precision,
    dft_planar,
    dft_rect_shifted_planar,
)
from xmris_tpu_torch.ops.phasing import (
    _de_phase_search,
    _grid_phase_search,
    grid_phase_search_graphed,
    resolve_polish,
)
from xmris_tpu_torch.parallel.pipeline import PipelineConfig


def _apply_phase_planar(re, im, phi, barrier: bool = False):
    """Rotate the spectra by ``phi``.  ``barrier`` is the reference's XLA
    optimization barrier on the cos/sin vectors; eager PyTorch always
    materializes them, so both values run this same code."""
    if not isinstance(barrier, bool):
        raise TypeError(f"phase_barrier must be a bool, got {barrier!r}.")
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
    re, im = _apply_phase_planar(re, im, phi, barrier=cfg.phase_barrier)
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


def _resolve_variant(cfg: PipelineConfig) -> str:
    """The transform ``cfg`` runs: ``"pallas"`` (K1) for ``dft_variant``
    None, or ``"einsum"`` when a ``dft_precision`` is asked for (the
    reference's kernel hard-codes HIGHEST, so a precision turns its
    automatic choice of the kernel off); else ``cfg.dft_variant``."""
    _check_precision(cfg.dft_precision)
    variant = cfg.dft_variant
    if variant is None and cfg.dft_precision is None:
        variant = "pallas"
    if cfg.spec_layout == "stacked" and variant != "pallas":
        raise ValueError(
            "spec_layout='stacked' requires the pallas DFT variant "
            f"(resolved variant: {variant!r}; shapes must satisfy "
            "pallas_split_ok and the backend must select/force it)."
        )
    return variant or DEFAULT_VARIANT


def _spectrum_stage(fids_re, fids_im, weight, cfg: PipelineConfig,
                    with_peak: bool, kernels: KernelSet):
    """Window + zero-fill + ortho DFT + fftshift, with each voxel's peak
    (max |S|^2 and its first bin) when ``with_peak``: K1 (``kernels.
    spectrum``) for the ``"pallas"`` variant, else the matmul DFT, its peak
    read from the spectra (the first maximum, as K1 and ``argmax`` take
    it)."""
    variant = _resolve_variant(cfg)
    n_time, n_out = fids_re.shape[1], cfg.zero_fill_to
    window = weight[:n_time].to(fids_re.dtype)
    if variant == "pallas":
        return kernels.spectrum(
            fids_re, fids_im, n_out, window=window.contiguous(),
            with_maxmag=with_peak, stacked_out=cfg.spec_layout == "stacked",
        )
    if n_out < n_time:
        raise ValueError(
            f"zero_fill_to={n_out} < n_time={n_time}: the spectral stage "
            "only zero-fills"
        )
    xr, xi = fids_re * window, fids_im * window
    if variant == "fused":
        spec_re, spec_im = dft_rect_shifted_planar(
            xr, xi, n_out, precision=cfg.dft_precision)
    else:
        pad = (0, n_out - n_time)
        spec_re, spec_im = dft_planar(
            torch.nn.functional.pad(xr, pad), torch.nn.functional.pad(xi, pad),
            n_out, ortho=True, variant=variant, precision=cfg.dft_precision)
        spec_re = torch.roll(spec_re, n_out // 2, dims=-1)
        spec_im = torch.roll(spec_im, n_out // 2, dims=-1)
    if not with_peak:
        return spec_re, spec_im
    mv, mi = torch.max(spec_re * spec_re + spec_im * spec_im, dim=1)
    return spec_re, spec_im, mv, mi


def spectral_pipeline_planar_raw(fids_re, fids_im, weight, freqs,
                                 cfg: PipelineConfig,
                                 kernels: KernelSet = DISPATCH):
    """Fused spectral stage on planar (B, n_time) batches (float32; the
    matmul variants of ``cfg.dft_variant`` also take float64).

    ``weight`` is the (zero_fill_to,) apodization window on the zero-
    filled axis (its first n_time entries are applied), ``freqs`` the
    (zero_fill_to,) centred frequency axis.  Returns ``(spec_re, spec_im,
    (p0, p1, pivot))`` — spectra (B, n_out), or (B, n2, n1) with
    ``spec_layout="stacked"`` (flat k = k1 + n1*k2) — with 0-dim phase
    tensors (zeros for ``autophase="none"``), or (B,) per-voxel phases and
    pivots for ``autophase="all"``.  Every zero-fill runs (K1's FFT or split
    kernel, or the dense route; ``dft_cuda.route``; or the matmul DFT); the
    stacked layout needs K1 and a Cooley-Tukey split, and
    ``zero_fill_to < n_time`` raises ``ValueError``.
    """
    want_peak = cfg.autophase in ("single", "all")
    out = _spectrum_stage(fids_re, fids_im, weight, cfg, want_peak, kernels)
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


# ---------------------------------------------------------------------------
# The spectral stage over a voxel mesh
# ---------------------------------------------------------------------------


def _spectral_shard(fids_re, fids_im, weight, freqs, cfg: PipelineConfig,
                   kernels: KernelSet = DISPATCH):
    """One shard's spectral stage in a sharded program.

    With ``autophase="single"`` the phase waits for the grid-wide pivot
    election (:func:`_elect_and_phase`): the shard returns its unphased
    spectra and its candidate ``(max |S|^2, that voxel's spectrum row re,
    im, its peak bin)``, the first maximum of the shard as the unsharded
    ``argmax`` takes it.  With ``"all"`` and ``"none"`` the shard runs the
    whole stage (:func:`spectral_pipeline_planar_raw`) and returns its
    phases.
    """
    if cfg.autophase != "single":
        return spectral_pipeline_planar_raw(fids_re, fids_im, weight, freqs,
                                            cfg, kernels)
    spec_re, spec_im, mv, mi = _spectrum_stage(fids_re, fids_im, weight, cfg,
                                               True, kernels)
    v = torch.argmax(mv)
    n_freq = freqs.shape[0]
    return spec_re, spec_im, (mv[v], spec_re[v].reshape(n_freq),
                              spec_im[v].reshape(n_freq), mi[v].long())


def _elect_and_phase(shards, freqs, cfg: PipelineConfig,
                    kernels: KernelSet = DISPATCH):
    """Finish the sharded spectral stage on the calling thread.

    ``shards`` are the :func:`_spectral_shard` results in mesh order and
    ``freqs`` lies on the mesh's first device.  For ``autophase="single"``
    the candidates are copied there and the first maximum wins (the
    unsharded ``argmax`` over the grid); the phase is solved ONCE on the
    winning row with the unsharded program's search
    (:func:`_solve_phase_on_row`: the same generator seed, the same CUDA
    graph) and the same ramp turns every shard on its device.  Returns
    ``(spectra, (p0, p1, pivot))``: ``[(spec_re, spec_im), ...]`` per shard
    and the phases on the first device (0-dim, or gathered per voxel for
    ``"all"``).
    """
    dev0 = freqs.device
    if cfg.autophase != "single":
        phases = [s[2] for s in shards]
        if cfg.autophase == "all":
            p = tuple(torch.cat([ph[i].to(dev0) for ph in phases])
                      for i in range(3))
        else:
            p = tuple(x.to(dev0) for x in phases[0])
        return [(s[0], s[1]) for s in shards], p
    maxs = torch.stack([s[2][0].to(dev0) for s in shards])
    _, row_re, row_im, freq_idx = (x.to(dev0) for x in
                                   shards[int(torch.argmax(maxs))][2])
    pivot = freqs[freq_idx]
    p0, p1 = _solve_phase_on_row(row_re, row_im, freqs, pivot, cfg, kernels)
    x_range = freqs[-1] - freqs[0]
    phi = torch.deg2rad(p0) + torch.deg2rad(p1) * ((freqs - pivot) / x_range)
    out = []
    for spec_re, spec_im, _ in shards:
        ph = phi.to(spec_re.dtype).to(spec_re.device)
        ph = ph.reshape(spec_re.shape[-2:])[None] if spec_re.dim() == 3 \
            else ph[None, :]
        out.append(_apply_phase_planar(spec_re, spec_im, ph,
                                       barrier=cfg.phase_barrier))
    return out, (p0, p1, pivot)


def spectral_pipeline_sharded(fids_re, fids_im, weight, freqs,
                              cfg: PipelineConfig, mesh, axis_name: str,
                              kernels: KernelSet = DISPATCH):
    """:func:`spectral_pipeline_planar_raw` with the voxel axis split over
    ``mesh`` (the batch must divide by its axis): each shard's K1 (and per
    voxel its search) on its device, a host thread per distinct device,
    then the pivot election; the result is whole on the mesh's first
    device."""
    from xmris_tpu_torch.parallel.mesh import (
        gather,
        run_on_devices,
        shard_voxels,
    )

    devices = mesh.axis_devices(axis_name)
    res = shard_voxels(fids_re, mesh, axis_name)
    ims = shard_voxels(fids_im, mesh, axis_name)
    shards = run_on_devices(
        lambda re, im, w, f: _spectral_shard(re, im, w, f, cfg, kernels),
        devices, [(re, im, weight.to(d), freqs.to(d))
                  for re, im, d in zip(res, ims, devices)])
    spectra, phases = _elect_and_phase(shards, freqs.to(devices[0]), cfg,
                                       kernels)
    spec_re, spec_im = gather(spectra, devices[0])
    return spec_re, spec_im, phases
