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
    loudest row and applied to every voxel) or ``"none"``; ``"all"`` is
    accepted and raises ``NotImplementedError`` when run.  ``ap_optimizer``
    / ``ap_polish``: the phase search; only ``"grid"`` with the ``"gd"``
    polish (``"auto"`` resolves to it) is ported.  ``spec_layout``:
    ``"flat"`` (B, n_out) or ``"stacked"`` (B, n2, n1) spectra.
    """

    zero_fill_to: int = 2048
    autophase: str = "single"  # "single" | "all" | "none"
    p0_only: bool = False
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
