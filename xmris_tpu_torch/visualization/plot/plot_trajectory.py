"""Metabolite trajectory plot with CRLB confidence shading.

Port of :mod:`xmris_tpu.visualization.plot.plot_trajectory`: amplitude vs
a series dimension per metabolite, with the CRLB percentage converted to an
absolute error band ``amp * crlb / 100``.  Amplitude and CRLB come to the
host once each
(:func:`~xmris_tpu_torch.visualization._host.trajectory_lines`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from xmris_tpu_torch.core.array import XmrDataset
from xmris_tpu_torch.visualization._host import trajectory_lines
from xmris_tpu_torch.visualization.plot._base_config import BasePlotConfig, PlotParam
from xmris_tpu_torch.visualization.plot._style import get_or_make_axes, plot_context

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


@dataclass
class PlotTrajectoryConfig(BasePlotConfig):
    """Configuration for AMARES trajectory plots with CRLB shading."""

    # --- Figure & Canvas ---
    figsize: tuple[float, float] = PlotParam(
        (8, 5), "Figure & Canvas", "Figure dimensions (width, height)."
    )
    style: str = PlotParam(
        "seaborn-v0_8-white", "Figure & Canvas", "Matplotlib style sheet."
    )
    fontfamily: str = PlotParam(
        "sans-serif", "Figure & Canvas", "Font family for all text."
    )
    axes_linewidth: float = PlotParam(
        1.2, "Figure & Canvas", "Line thickness of the plot bounding box."
    )

    # --- Aesthetics ---
    palette: str | tuple[str, ...] = PlotParam(
        "tab10", "Aesthetics", "Colormap name or explicit color sequence."
    )
    markers: tuple[str, ...] = PlotParam(
        ("o", "s", "^", "D", "v", "p", "*", "h", "X"),
        "Aesthetics",
        "Marker styles cycled per metabolite.",
    )
    linewidth: float = PlotParam(2.0, "Aesthetics", "Trajectory line thickness.")
    markersize: float = PlotParam(6.0, "Aesthetics", "Trajectory marker size.")
    fill_alpha: float = PlotParam(
        0.2, "Aesthetics", "Transparency of the CRLB error band."
    )
    fill_linewidth: float = PlotParam(
        0.0, "Aesthetics", "Outline thickness of the CRLB band."
    )

    # --- Labels & Fonts ---
    title: str | None = PlotParam(
        "Metabolite Trajectories (Shading = CRLB Error)",
        "Labels & Fonts",
        "Plot title; None hides it.",
    )
    xlabel: str | None = PlotParam(
        None, "Labels & Fonts", "x-axis label; None derives from the dimension."
    )
    ylabel: str = PlotParam("Amplitude [a.u.]", "Labels & Fonts", "y-axis label.")
    labelsize: int = PlotParam(12, "Labels & Fonts", "Axis label font size.")
    fontweight: str = PlotParam(
        "bold", "Labels & Fonts", "Font weight for titles and labels."
    )

    # --- Grid, Ticks & Legend ---
    tick_direction: str = PlotParam(
        "in", "Grid & Ticks", "Tick direction ('in', 'out', 'inout')."
    )
    grid_on: bool = PlotParam(True, "Grid & Ticks", "Show the background grid.")
    grid_alpha: float = PlotParam(0.3, "Grid & Ticks", "Grid transparency.")
    grid_linestyle: str = PlotParam("--", "Grid & Ticks", "Grid line style.")
    legend_on: bool = PlotParam(True, "Legend", "Show the legend.")
    legend_frameon: bool = PlotParam(True, "Legend", "Frame around the legend.")


def plot_trajectory(
    ds: XmrDataset,
    dim: str,
    metabolites: list[str] | None = None,
    ax: plt.Axes | None = None,
    config: PlotTrajectoryConfig | None = None,
) -> plt.Axes:
    """Plot per-metabolite amplitude trajectories with CRLB error bands."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator

    cfg = config or PlotTrajectoryConfig()
    series, unit, lines = trajectory_lines(ds, dim, metabolites)

    with plot_context(cfg.style, cfg.fontfamily, cfg.axes_linewidth):
        fig, ax = get_or_make_axes(ax, cfg.figsize)

        if isinstance(cfg.palette, str):
            cmap = plt.get_cmap(cfg.palette)
            colors = (
                list(cmap.colors)
                if hasattr(cmap, "colors")
                else [cmap(v) for v in np.linspace(0, 1, len(lines))]
            )
        else:
            colors = list(cfg.palette)

        for i, (metab, amps, band) in enumerate(lines):
            color = colors[i % len(colors)]
            ax.plot(
                series, amps,
                color=color, linewidth=cfg.linewidth,
                marker=cfg.markers[i % len(cfg.markers)],
                markersize=cfg.markersize, label=str(metab),
            )
            ax.fill_between(
                series, amps - band, amps + band,
                color=color, alpha=cfg.fill_alpha, linewidth=cfg.fill_linewidth,
            )

        xlabel = cfg.xlabel or (f"{dim} [{unit}]" if unit else str(dim))
        ax.set_xlabel(xlabel, fontweight=cfg.fontweight, fontsize=cfg.labelsize)
        ax.set_ylabel(cfg.ylabel, fontweight=cfg.fontweight, fontsize=cfg.labelsize)
        if cfg.title:
            ax.set_title(cfg.title, fontweight=cfg.fontweight)
        if cfg.grid_on:
            ax.grid(True, alpha=cfg.grid_alpha, linestyle=cfg.grid_linestyle)
        if cfg.legend_on:
            ax.legend(frameon=cfg.legend_frameon)

        ax.xaxis.set_minor_locator(AutoMinorLocator())
        ax.yaxis.set_minor_locator(AutoMinorLocator())
        ax.tick_params(which="both", direction=cfg.tick_direction, top=True, right=True)

        if ax.get_figure() is fig:
            fig.tight_layout()

    return ax
