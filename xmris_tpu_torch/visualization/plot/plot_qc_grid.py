"""Quality-control grid: spectra + fits with CRLB failure shading.

Port of :mod:`xmris_tpu.visualization.plot.plot_qc_grid`: even
downsampling to ``max_plots``, conversion of raw/fit/residual FIDs to
spectra through the accessor where the payload lies, and shading of
subplots whose worst CRLB exceeds the threshold.  The selected spectra and
CRLBs come to the host once each
(:func:`~xmris_tpu_torch.visualization._host.qc_panels`), not once per
panel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from xmris_tpu_torch.core.array import XmrDataset
from xmris_tpu_torch.core.config import DIMS
from xmris_tpu_torch.visualization._host import qc_panels
from xmris_tpu_torch.visualization.plot._base_config import BasePlotConfig, PlotParam
from xmris_tpu_torch.visualization.plot._style import plot_context, title_case

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


@dataclass
class PlotQCGridConfig(BasePlotConfig):
    """Configuration for AMARES fit quality-control grids."""

    # --- Figure & Canvas ---
    style: str = PlotParam(
        "seaborn-v0_8-white", "Figure & Canvas", "Matplotlib style sheet."
    )
    fontfamily: str = PlotParam(
        "sans-serif", "Figure & Canvas", "Font family for all text."
    )

    # --- Grid Layout ---
    max_cols: int = PlotParam(10, "Grid Layout", "Maximum grid columns.")
    max_plots: int | None = PlotParam(
        None,
        "Grid Layout",
        "Max subplots; None plots all spectra, N samples evenly when exceeded.",
    )
    sharey: bool = PlotParam(
        False, "Grid Layout", "Share y-limits to compare absolute amplitudes."
    )

    # --- Quality Control ---
    crlb_threshold: float = PlotParam(
        20.0, "Quality Control", "CRLB %% threshold flagging a bad fit."
    )
    fail_color: str = PlotParam(
        "#ffe6e6", "Quality Control", "Background color of failed-fit panels."
    )

    # --- Aesthetics & Zooming ---
    plot_residuals: bool = PlotParam(
        True, "Aesthetics", "Draw the residual trace below the fit."
    )
    xlim: tuple[float, float] | None = PlotParam(
        None, "Aesthetics", "x-axis zoom limits, e.g. (10.0, -20.0)."
    )
    ylim: tuple[float, float] | None = PlotParam(
        None, "Aesthetics", "y-axis zoom limits, e.g. (-10, 100)."
    )


def plot_qc_grid(
    ds: XmrDataset,
    dim: str,
    config: PlotQCGridConfig | None = None,
) -> plt.Figure:
    """Grid of per-index spectra with fit overlays and CRLB flagging."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    cfg = config or PlotQCGridConfig()
    panels = qc_panels(ds, dim, cfg.max_plots, cfg.plot_residuals)
    indices, dim_coords, dim_unit = panels.indices, panels.dim_coords, panels.dim_unit
    freq_coords = panels.freq

    n_plots = len(indices)
    cols = min(n_plots, cfg.max_cols)
    rows = int(np.ceil(n_plots / cols))

    with plot_context(cfg.style, cfg.fontfamily, axes_linewidth=1.0):
        fig, axes = plt.subplots(
            rows, cols,
            figsize=(cols * 3.5, rows * 2.5),
            sharex=True, sharey=cfg.sharey, squeeze=False,
            gridspec_kw={"wspace": 0.0, "hspace": 0.0},
        )
        flat = axes.flatten()

        for i, idx_val in enumerate(indices):
            ax = flat[i]
            raw_i = panels.raw.isel({dim: i}).values
            ax.plot(freq_coords, raw_i, color="black", alpha=0.4, label="Raw")
            ax.plot(
                freq_coords, panels.fit.isel({dim: i}).values,
                color="red", linewidth=1.2, label="Fit",
            )
            if panels.res is not None:
                offset = float(np.max(raw_i)) * 0.2
                ax.plot(
                    freq_coords, panels.res.isel({dim: i}).values - offset,
                    color="green", alpha=0.6, linewidth=1.0,
                )

            crlbs = panels.crlb.isel({dim: i}).values
            worst = np.nanmax(np.nan_to_num(crlbs, nan=np.inf))

            coord_val = dim_coords[idx_val]
            if isinstance(coord_val, (int, np.integer)):
                tag = f"{coord_val}{dim_unit}"
            else:
                tag = f"{coord_val:.1f}{dim_unit}"

            if worst > cfg.crlb_threshold:
                ax.set_facecolor(cfg.fail_color)
                text_color = "darkred"
                tag += "\nCRLB: NaN" if np.isinf(worst) else f"\nCRLB: {worst:.1f}%"
            else:
                text_color = "black"

            ax.text(
                0.04, 0.94, tag,
                transform=ax.transAxes, fontsize=10, fontweight="bold",
                color=text_color, va="top", ha="left",
                bbox=dict(
                    boxstyle="round,pad=0.2", facecolor="white",
                    alpha=0.7, edgecolor="none",
                ),
            )

            if cfg.xlim is not None:
                ax.set_xlim(cfg.xlim)
            elif not ax.xaxis_inverted():
                ax.invert_xaxis()
            if cfg.ylim is not None:
                ax.set_ylim(cfg.ylim)
            ax.set_yticks([])

        for j in range(n_plots, len(flat)):
            flat[j].axis("off")

        for ax in axes[-1, :]:
            ax.xaxis.set_major_locator(MaxNLocator(nbins=4, prune="both"))

        fig.supxlabel(
            f"{title_case(DIMS.frequency)} [{panels.freq_unit}]",
            fontweight="bold", fontsize=12,
        )
        fig.tight_layout()

    return fig
