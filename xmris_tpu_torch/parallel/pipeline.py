"""The fused per-grid spectral pipeline and its labeled front-end (PyTorch
port).

Port of :mod:`xmris_tpu.parallel.pipeline`: :class:`PipelineConfig`, the
host-side apodization window (:func:`_apodization_weight`),
:func:`spectral_pipeline_raw` on a complex batch, and
:func:`mrsi_pipeline`, which runs ``zero_fill -> apodize -> to_spectrum ->
autophase`` over every voxel of an :class:`XmrArray` as one call of
:func:`~xmris_tpu_torch.parallel.planar_pipeline.spectral_pipeline_planar_raw`
(kernel K1 or a matmul DFT, then the phase search) and returns the labeled
spectra with the op-by-op chain's coordinates and lineage.  Every engine
runs that one planar program, so ``dft_variant``, ``dft_precision`` and
``phase_barrier`` act on all of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from xmris_tpu_torch.core.array import XmrArray, torch_dtype
from xmris_tpu_torch.core.config import ATTRS, COORDS, DIMS
from xmris_tpu_torch.core.utils import (
    _check_dims,
    as_coord,
    card_device,
    complex_planes,
)
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.runtime.config import matching_dtypes
from xmris_tpu_torch.runtime.profiling import spanned, to_host


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the spectral stage.

    ``zero_fill_to``: points after zero-filling; ``lb``/``gb``: the
    apodization (``gb == 0``: ``exp(-pi lb t)``; else the Lorentz-to-Gauss
    window ``exp(+pi lb t) exp(-(t / T_G)^2)``, ``T_G = 2 sqrt(ln 2) / (pi
    gb)``), used by :func:`mrsi_pipeline` (the raw pipeline takes the
    window itself).  ``autophase``: ``"single"`` (one ACME phase solved on
    the grid's loudest row and applied to every voxel), ``"all"`` (one ACME
    phase per voxel, flat spectra only) or ``"none"``.  ``ap_optimizer``:
    the phase search, ``"de"`` (differential evolution with ``de_popsize``,
    ``de_maxiter`` and ``de_seed``, one search per voxel for ``"all"``) or
    ``"grid"``; ``ap_polish``: the grid search's polish, ``"gd"``,
    ``"fused"`` (``"auto"``: the fused kernel K5 for a grid of voxels on
    the card, gd for the single pivot row or on the CPU), ``"newton"`` or
    ``"bfgs"``.  ``dft_variant``: the spectral transform, None or
    ``"pallas"`` (kernel K1, where the reference's None picks the einsum
    formulation off a single TPU), ``"fused"`` (zero-fill, ortho DFT and
    fftshift as one matmul) or a :func:`~xmris_tpu_torch.ops.kernels.dft.
    dft_planar` variant (``"einsum"``, ``"flat"``, ``"block"``, ``"full"``);
    ``dft_precision``: the matmul DFT's emulated TPU precision (None,
    ``"default"``, ``"high"``, ``"highest"``; with ``dft_variant=None`` it
    selects ``"einsum"``, as the reference turns its kernel off for it).
    ``spec_layout``: ``"flat"`` (B, n_out) or ``"stacked"`` (B, n2, n1)
    spectra, the kernel's layout (``dft_variant`` None or ``"pallas"``).
    ``phase_barrier``: the reference's XLA fusion barrier on the phase
    ramp's cos/sin vectors; eager PyTorch always materializes them, so
    both values run the same code (a bool is required).
    """

    zero_fill_to: int = 2048
    lb: float = 5.0
    gb: float = 0.0  # 0 => exponential apodization; > 0 => Lorentz-to-Gauss
    autophase: str = "single"  # "single" | "all" | "none"
    p0_only: bool = False
    de_popsize: int = 15
    de_maxiter: int = 200
    de_seed: int = 42
    ap_optimizer: str = "de"  # "de" | "grid"
    ap_polish: str = "auto"
    dft_variant: str | None = None
    dft_precision: str | None = None
    spec_layout: str = "flat"  # "flat" | "stacked"
    phase_barrier: bool = False

    def __post_init__(self):
        if self.autophase not in ("single", "all", "none"):
            raise ValueError(
                f"autophase must be 'single', 'all', or 'none', got "
                f"{self.autophase!r}."
            )
        if self.ap_optimizer not in ("de", "grid"):
            raise ValueError(
                f"ap_optimizer must be 'de' or 'grid', got "
                f"{self.ap_optimizer!r}."
            )
        if self.ap_polish not in ("auto", "gd", "newton", "bfgs", "fused"):
            raise ValueError(
                f"ap_polish must be 'auto', 'gd', 'newton', 'bfgs', or "
                f"'fused', got {self.ap_polish!r}."
            )
        if self.spec_layout not in ("flat", "stacked"):
            raise ValueError(
                f"spec_layout must be 'flat' or 'stacked', got "
                f"{self.spec_layout!r}."
            )
        if self.spec_layout == "stacked" and self.autophase == "all":
            raise ValueError(
                "spec_layout='stacked' supports autophase 'single'/'none' "
                "only (per-voxel autophase needs flat spectra)."
            )


def _apodization_weight(t: np.ndarray, lb: float, gb: float) -> np.ndarray:
    """The apodization window on the time axis ``t`` (host, float64; the
    formulas of :mod:`xmris_tpu_torch.ops.fid`)."""
    if gb and gb != 0.0:
        t_g = (2.0 * np.sqrt(np.log(2.0))) / (np.pi * gb)
        return np.exp(np.pi * lb * t) * np.exp(-(t**2) / t_g**2)
    return np.exp(-np.pi * lb * t)


def spectral_constants(t: np.ndarray, cfg: PipelineConfig):
    """The host-side constants of :func:`mrsi_pipeline` for the time axis
    ``t``: ``n_out = max(cfg.zero_fill_to, len(t))``, the window on the
    zero-filled axis ``t[0] + arange(n_out) * dt`` and the fftshifted
    frequency axis, both float64 (n_out,)."""
    t = np.asarray(t, dtype=np.float64)
    dt = float(t[1] - t[0]) if len(t) > 1 else 1.0
    n_out = max(cfg.zero_fill_to, len(t))
    t_full = t[0] + np.arange(n_out) * dt
    weight = _apodization_weight(t_full, cfg.lb, cfg.gb)
    freqs = np.fft.fftshift(np.fft.fftfreq(n_out, d=dt))
    return n_out, weight, freqs


def spectral_pipeline_raw(fids, weight, freqs, cfg: PipelineConfig,
                          device="cuda", kernels: KernelSet = DISPATCH):
    """The spectral stage on a ``(n_voxels, n_time)`` complex batch
    (reference ``spectral_pipeline_raw``).

    ``weight`` is the (zero_fill_to,) apodization window on the zero-
    filled axis, ``freqs`` the centred frequency axis.  The batch splits
    into float32 planes (a tensor where it lies, numpy on ``device``, the
    card unless the caller passes ``"cpu"``), runs
    :func:`~xmris_tpu_torch.parallel.planar_pipeline.spectral_pipeline_planar_raw`
    (K1 with flat spectra, then the phase search) and recombines.  Returns
    ``(spectrum, (p0, p1, pivot))``: centred phased spectra (B,
    zero_fill_to) in the input's complex precision, with the phases as
    that function returns them (0-dim for ``"single"``, (B,) for
    ``"all"``, zeros for ``"none"``).
    """
    from xmris_tpu_torch.parallel.planar_pipeline import (
        spectral_pipeline_planar_raw,
    )

    if not isinstance(fids, torch.Tensor):
        fids = np.asarray(fids)
    _, complex_dtype = matching_dtypes(fids.dtype)
    re, im = complex_planes(fids, fids.device if isinstance(fids, torch.Tensor)
                            else card_device(device, "spectral_pipeline_raw"))
    re, im = re.to(torch.float32), im.to(torch.float32)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=re.device)

    sr, si, phases = spectral_pipeline_planar_raw(
        re, im, f32(weight), f32(freqs),
        dataclasses.replace(cfg, spec_layout="flat"), kernels=kernels)
    return torch.complex(sr, si).to(torch_dtype(complex_dtype)), phases


@spanned("front")
def mrsi_pipeline(
    da: XmrArray,
    dim: str = DIMS.time,
    cfg: PipelineConfig = PipelineConfig(),
    mesh=None,
    out_dim: str = DIMS.frequency,
    engine: str = "auto",
    device="cuda",
    kernels: KernelSet = DISPATCH,
) -> XmrArray:
    """Labeled front-end: the fused spectral pipeline over every voxel of
    ``da`` (reference ``mrsi_pipeline``).

    The op-by-op chain ``zero_fill -> apodize (cfg.lb, cfg.gb) ->
    to_spectrum -> autophase`` as one call of
    :func:`~xmris_tpu_torch.parallel.planar_pipeline.spectral_pipeline_planar_raw`
    on the flattened (n_voxels, n_time) float32 planes on ``device`` (the
    card unless the caller passes ``"cpu"``): kernel K1 for the spectra
    (its plain version on the CPU), then the phase search ``cfg`` names.
    The window and the frequency axis are computed on the host in float64
    (:func:`spectral_constants`) and handed over as float32; ``cfg`` runs
    with ``zero_fill_to = max(cfg.zero_fill_to, n_time)``.  ``engine``
    takes the reference's ``"auto"``, ``"planar"`` and ``"complex"``, all
    of which run this one program.  ``kernels`` selects the kernel
    wrappers (default) or their plain versions.

    With a 1-D ``mesh`` (:class:`~xmris_tpu_torch.parallel.mesh.Mesh`) the
    voxel rows are zero-padded to a multiple of its size and split over it
    (:func:`~xmris_tpu_torch.parallel.planar_pipeline.spectral_pipeline_sharded`:
    K1 per shard, one pivot election), and the result lies on the mesh's
    first device.  As in the reference, ``mesh=None`` with several CUDA
    devices shards over all of them (:func:`~xmris_tpu_torch.parallel.mesh.make_mesh`),
    unless ``device`` names one (``"cuda:1"``).

    The result has ``dim`` replaced by ``out_dim`` (frequency coordinates,
    the other coordinates kept, ``da``'s axis order), the input's complex
    dtype (numpy for a numpy payload, a tensor on ``device`` for a tensor
    payload) and the chain's lineage: ``zero_fill_target``/``position``
    when it pads, ``apodization_lb``, ``apodization_gb`` when ``gb`` is not
    0, and the phase attrs unless ``autophase="none"`` (floats for
    ``"single"``, voxel-shaped arrays for ``"all"``).
    """
    _check_dims(da, dim, "mrsi_pipeline")
    from xmris_tpu_torch.parallel.mesh import Mesh, make_mesh

    dev = torch.device(device)
    if mesh is None and dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    if mesh is not None and not (isinstance(mesh, Mesh)
                                 and len(mesh.axis_names) == 1):
        raise ValueError(f"mesh={mesh!r}: expected a 1-D Mesh or None.")
    if engine not in ("auto", "planar", "complex"):
        raise ValueError(
            f"engine must be 'auto', 'planar', or 'complex', got {engine!r}."
        )
    from xmris_tpu_torch.parallel.planar_pipeline import (
        spectral_pipeline_planar_raw,
    )

    order = [d for d in da.dims if d != dim] + [dim]
    da_t = da.transpose(*order)
    n_time = da.sizes[dim]
    voxel_shape = tuple(da_t.shape[:-1])
    _, complex_dtype = matching_dtypes(da.dtype)

    n_out, weight, freqs = spectral_constants(da.coords[dim].values, cfg)
    cfg = dataclasses.replace(cfg, zero_fill_to=n_out)
    re, im = complex_planes(da_t.data.reshape(-1, n_time), device)
    re, im = re.to(torch.float32), im.to(torch.float32)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=re.device)

    if mesh is None:
        sr, si, (p0, p1, pivot) = spectral_pipeline_planar_raw(
            re, im, f32(weight), f32(freqs), cfg, kernels=kernels)
    else:
        from xmris_tpu_torch.parallel.planar_pipeline import (
            spectral_pipeline_sharded,
        )

        # Zero rows are inert through the linear stage and never win the
        # pivot election; they are sliced off below.
        n_rows = re.shape[0]
        pad = (-n_rows) % mesh.size
        if pad:
            re = torch.nn.functional.pad(re, (0, 0, 0, pad))
            im = torch.nn.functional.pad(im, (0, 0, 0, pad))
        sr, si, (p0, p1, pivot) = spectral_pipeline_sharded(
            re, im, f32(weight), f32(freqs), cfg, mesh, mesh.axis_names[0],
            kernels=kernels)
        sr, si = sr[:n_rows], si[:n_rows]
        if cfg.autophase == "all":
            p0, p1, pivot = p0[:n_rows], p1[:n_rows], pivot[:n_rows]
    spec = torch.complex(sr, si)
    if isinstance(da.data, torch.Tensor):
        spec = spec.to(torch_dtype(complex_dtype))
    else:
        spec = to_host(spec).numpy().astype(complex_dtype, copy=False)
    out = XmrArray(
        spec.reshape(voxel_shape + (n_out,)),
        dims=tuple(order[:-1]) + (out_dim,),
        attrs=da.attrs,
        name=da.name,
    )
    out.coords = {k: c.copy() for k, c in da.coords.items() if c.dim != dim}
    out = out.assign_coords({out_dim: as_coord(COORDS.frequency, out_dim, freqs)})
    out = out.transpose(*[d if d != dim else out_dim for d in da.dims])

    if cfg.zero_fill_to > n_time:
        out.attrs[ATTRS.zero_fill_target] = cfg.zero_fill_to
        out.attrs[ATTRS.zero_fill_position] = "end"
    out.attrs[ATTRS.apodization_lb] = cfg.lb
    if cfg.gb:
        out.attrs[ATTRS.apodization_gb] = cfg.gb
    if cfg.autophase != "none":
        def host_attr(v):
            v = to_host(v)
            return (v.numpy().reshape(voxel_shape)
                    if isinstance(v, torch.Tensor) else float(v))

        out.attrs[ATTRS.phase_p0] = host_attr(p0)
        out.attrs[ATTRS.phase_p1] = host_attr(p1)
        out.attrs[ATTRS.phase_pivot] = host_attr(pivot)
        out.attrs[ATTRS.phase_pivot_coord] = out_dim
    return out
