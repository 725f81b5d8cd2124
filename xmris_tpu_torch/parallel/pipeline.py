"""Configuration of the fused per-grid spectral pipeline (PyTorch port).

Port of :class:`xmris_tpu.parallel.pipeline.PipelineConfig` with the fields
the per-grid program reads.  The spectrum always runs the hand-written
kernel (the reference's ``dft_variant="pallas"``), so there is no variant
or precision field; the reference's ``phase_barrier`` knob is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the spectral stage.

    ``autophase``: ``"single"`` (one ACME phase solved on the grid's
    loudest row and applied to every voxel), ``"all"`` (one ACME phase per
    voxel, flat spectra only) or ``"none"``.  ``ap_optimizer``: the phase
    search, ``"de"`` (differential evolution with ``de_popsize``,
    ``de_maxiter`` and ``de_seed``, one search per voxel for ``"all"``) or
    ``"grid"``; ``ap_polish``: the grid search's polish, ``"gd"`` or
    ``"fused"`` (``"auto"``: the fused kernel K5 for a grid of voxels on
    the card, gd for the single pivot row or on the CPU);
    ``"newton"``/``"bfgs"`` raise ``NotImplementedError`` when run.
    ``spec_layout``: ``"flat"`` (B, n_out) or ``"stacked"`` (B, n2, n1)
    spectra.
    """

    zero_fill_to: int = 2048
    autophase: str = "single"  # "single" | "all" | "none"
    p0_only: bool = False
    de_popsize: int = 15
    de_maxiter: int = 200
    de_seed: int = 42
    ap_optimizer: str = "de"  # "de" | "grid"
    ap_polish: str = "auto"
    spec_layout: str = "flat"  # "flat" | "stacked"

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
