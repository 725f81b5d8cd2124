"""Carpet plot: stacked 1-D spectra as a 2-D intensity map.

Port of :mod:`xmris_tpu.visualization.plot.plot_carpet`: truncated
colormap, ``pcolormesh`` rendering, inverted x-axis, grid drawn over the
mesh.  The (stack, x) values come to the host once
(:func:`~xmris_tpu_torch.visualization._host.stack_view`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.visualization._host import stack_view
from xmris_tpu_torch.visualization.plot._base_config import BasePlotConfig, PlotParam
from xmris_tpu_torch.visualization.plot._style import (
    get_or_make_axes,
    plot_context,
    resolve_cmap,
    title_case,
)

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


@dataclass
class CarpetConfig(BasePlotConfig):
    """Aesthetic configuration for carpet (2-D intensity) plots."""

    # --- Figure Setup ---
    figsize: tuple[float, float] = PlotParam(
        (8, 5), "Figure Setup", "Figure dimensions in inches (width, height)."
    )
    style: str = PlotParam(
        "seaborn-v0_8-white", "Figure Setup", "Matplotlib style sheet for the canvas."
    )
    fontfamily: str = PlotParam(
        "sans-serif", "Figure Setup", "Font family for all plot text."
    )

    # --- Colormap Aesthetics ---
    cmap: str = PlotParam(
        "magma", "Colormap Aesthetics", "Colormap for the 2-D intensity."
    )
    cmap_start: float = PlotParam(
        0.1, "Colormap Aesthetics", "Lower colormap stop, avoiding extremes."
    )
    cmap_end: float = PlotParam(
        0.8, "Colormap Aesthetics", "Upper colormap stop, avoiding extremes."
    )

    # --- Axes & Labels ---
    xlabel: str | None = PlotParam(
        None, "Axes & Labels", "Explicit x-axis label; None derives from the dim name."
    )
    ylabel: str | None = PlotParam(
        None, "Axes & Labels", "Explicit y-axis label; None derives from the stack dim."
    )
    labelsize: int = PlotParam(12, "Axes & Labels", "Axis label font size (points).")
    ticklabelsize: int = PlotParam(10, "Axes & Labels", "Tick label font size (points).")

    # --- Ticks & Grid ---
    tick_color: str = PlotParam("lightgray", "Ticks & Grid", "Inward tick color.")
    tick_len_major: float = PlotParam(5.0, "Ticks & Grid", "Major tick length (points).")
    tick_wid_major: float = PlotParam(1.0, "Ticks & Grid", "Major tick width (points).")
    tick_len_minor: float = PlotParam(2.0, "Ticks & Grid", "Minor tick length (points).")
    tick_wid_minor: float = PlotParam(0.8, "Ticks & Grid", "Minor tick width (points).")
    xminor_locator: int = PlotParam(
        5, "Ticks & Grid", "Minor subdivisions between major x ticks."
    )
    yminor_locator: int = PlotParam(
        4, "Ticks & Grid", "Minor subdivisions between major y ticks."
    )
    grid_on: bool = PlotParam(True, "Ticks & Grid", "Show the overlay coordinate grid.")
    grid_color: str = PlotParam("lightgray", "Ticks & Grid", "Overlay grid color.")
    grid_alpha: float = PlotParam(0.2, "Ticks & Grid", "Overlay grid transparency.")
    grid_linewidth: float = PlotParam(0.6, "Ticks & Grid", "Overlay grid line width.")

    # --- Colorbar ---
    cbar_on: bool = PlotParam(True, "Colorbar", "Show the colorbar legend.")
    cbar_label: str | None = PlotParam(
        "Signal Intensity (a.u.)", "Colorbar", "Label beside the colorbar."
    )


def plot_carpet(
    da: XmrArray,
    x_dim: str | None = None,
    stack_dim: str | None = None,
    ax: plt.Axes | None = None,
    config: CarpetConfig | None = None,
) -> plt.Axes:
    """Render stacked 1-D spectra as a 2-D pcolormesh carpet."""
    cfg = config or CarpetConfig()

    from matplotlib.colors import ListedColormap
    from matplotlib.ticker import AutoMinorLocator

    view = stack_view(da, x_dim, stack_dim)
    x_name, stack_name = view.x_name, view.stack_name
    x_vals, stack_vals, intensity = view.x, view.stack, np.asarray(view.values)
    x_unit, stack_unit = view.x_unit, view.stack_unit

    with plot_context(cfg.style, cfg.fontfamily):
        fig, ax = get_or_make_axes(ax, cfg.figsize)

        # Truncate the colormap so extreme whites/blacks don't swallow data.
        cmap = ListedColormap(
            resolve_cmap(cfg.cmap)(np.linspace(cfg.cmap_start, cfg.cmap_end, 256))
        )

        mesh = ax.pcolormesh(x_vals, stack_vals, intensity, cmap=cmap, shading="auto")

        ax.set_xlabel(
            f"{cfg.xlabel or title_case(x_name)} [{x_unit}]",
            fontsize=cfg.labelsize, fontweight="bold",
        )
        ax.set_ylabel(
            f"{cfg.ylabel or title_case(stack_name)} [{stack_unit}]",
            fontsize=cfg.labelsize, fontweight="bold",
        )
        if not ax.xaxis_inverted():
            ax.invert_xaxis()

        # grid + ticks drawn over the mesh
        ax.set_axisbelow(False)
        if cfg.grid_on:
            ax.grid(
                True, which="major", color=cfg.grid_color,
                alpha=cfg.grid_alpha, linewidth=cfg.grid_linewidth, linestyle="-",
            )
        ax.xaxis.set_minor_locator(AutoMinorLocator(cfg.xminor_locator))
        ax.yaxis.set_minor_locator(AutoMinorLocator(cfg.yminor_locator))
        ax.tick_params(
            which="major", direction="in", color=cfg.tick_color,
            labelcolor="black", length=cfg.tick_len_major,
            width=cfg.tick_wid_major, top=True, right=True,
            labelsize=cfg.ticklabelsize,
        )
        ax.tick_params(
            which="minor", direction="in", color=cfg.tick_color,
            length=cfg.tick_len_minor, width=cfg.tick_wid_minor,
            top=True, right=True,
        )

        if cfg.cbar_on:
            cbar = fig.colorbar(mesh, ax=ax, pad=0.02)
            if cfg.cbar_label:
                cbar.set_label(
                    cfg.cbar_label, fontsize=cfg.labelsize, fontweight="bold"
                )
            cbar.ax.tick_params(
                which="major", direction="in",
                length=cfg.tick_len_major - 2, width=1.2,
                labelsize=cfg.ticklabelsize,
            )

        if ax.get_figure() is fig:
            fig.tight_layout()

    return ax
