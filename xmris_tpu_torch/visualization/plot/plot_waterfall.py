"""Waterfall (ridge) plot: stacked 1-D spectra with skewed 3-D effect.

Port of :mod:`xmris_tpu.visualization.plot.plot_waterfall`: global-max
normalization, skew-tangent ridge geometry, colormap fills, inverted x-axis,
periodic stack labels.  The (stack, x) values come to the host once
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
    sampled_colors,
    title_case,
)

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


@dataclass
class WaterfallConfig(BasePlotConfig):
    """Aesthetic configuration for waterfall (ridge) plots."""

    # --- Figure Setup ---
    figsize: tuple[float, float] = PlotParam(
        (8, 6), "Figure Setup", "Figure dimensions in inches (width, height)."
    )
    style: str = PlotParam(
        "seaborn-v0_8-white", "Figure Setup", "Matplotlib style sheet for the canvas."
    )
    fontfamily: str = PlotParam(
        "sans-serif", "Figure Setup", "Font family for all plot text."
    )

    # --- Stack Geometry ---
    stack_offset: float = PlotParam(
        0.5,
        "Stack Geometry",
        "Vertical baseline shift between spectra (normalized amplitude units).",
    )
    stack_scale: float = PlotParam(
        10.0,
        "Stack Geometry",
        "Height multiplier per spectrum controlling visual overlap.",
    )
    stack_skew: float = PlotParam(
        -20.0,
        "Stack Geometry",
        "Horizontal skew angle in degrees, strictly within (-89, 89).",
    )

    # --- Stack Aesthetics ---
    cmap: str | None = PlotParam(
        "magma", "Stack Aesthetics", "Colormap for fills; None disables filled areas."
    )
    cmap_start: float = PlotParam(
        0.8, "Stack Aesthetics", "Colormap fraction for the top spectrum."
    )
    cmap_end: float = PlotParam(
        0.1, "Stack Aesthetics", "Colormap fraction for the bottom spectrum."
    )
    alpha: float = PlotParam(
        0.75, "Stack Aesthetics", "Fill transparency under each spectrum."
    )
    linewidth: float = PlotParam(
        0.8, "Stack Aesthetics", "Outline width of regular spectra (points)."
    )
    linewidth_highlight: float = PlotParam(
        1.3, "Stack Aesthetics", "Outline width of labeled spectra (points)."
    )

    # --- Stack Labels ---
    stack_label_step: int = PlotParam(
        10, "Stack Labels", "Label every Nth spectrum on the stack axis."
    )
    stack_label_x_offset: float = PlotParam(
        -0.25, "Stack Labels", "Horizontal label adjustment (x-axis data units)."
    )
    stack_label_y_offset: float = PlotParam(
        0.0, "Stack Labels", "Vertical label adjustment (fraction of stack_offset)."
    )

    # --- Axes & Ticks ---
    xlabel: str | None = PlotParam(
        None, "Axes & Ticks", "Explicit x-axis label; None derives it from the dim name."
    )
    labelsize: int = PlotParam(12, "Axes & Ticks", "Axis label font size (points).")
    ticklabelsize: int = PlotParam(
        10, "Axes & Ticks", "Tick and stack-label font size (points)."
    )
    pad_left: float = PlotParam(
        0.0, "Axes & Ticks", "Extra padding on the high-value (left) side (data units)."
    )
    pad_right: float = PlotParam(
        0.0, "Axes & Ticks", "Extra padding on the low-value (right) side (data units)."
    )
    xminor_locator: int = PlotParam(
        5, "Axes & Ticks", "Minor tick subdivisions between major x ticks."
    )

    # --- Annotations ---
    annotation: str | None = PlotParam(
        "Absorption Mode",
        "Annotations",
        "Corner annotation text; None hides it.",
    )


def plot_waterfall(
    da: XmrArray,
    x_dim: str | None = None,
    stack_dim: str | None = None,
    ax: plt.Axes | None = None,
    config: WaterfallConfig | None = None,
) -> plt.Axes:
    """Render a stacked-ridge waterfall of 1-D spectra.

    Normalizes by the global absolute maximum, offsets each trace vertically
    and skews it horizontally by ``tan(stack_skew)`` per unit of baseline
    height, filling under each curve from the colormap.
    """
    from matplotlib.ticker import AutoMinorLocator

    cfg = config or WaterfallConfig()
    if not (-89.0 <= cfg.stack_skew <= 89.0):
        raise ValueError(
            "stack_skew must be an angle in degrees strictly between -89.0 and 89.0."
        )

    view = stack_view(da, x_dim, stack_dim)
    x_name, x_vals, stack_vals = view.x_name, view.x, view.stack
    x_unit, stack_unit = view.x_unit, view.stack_unit

    traces = np.array(view.values, copy=True)
    peak = np.max(np.abs(traces))
    if peak > 0:
        traces = traces / peak

    n_stack = len(stack_vals)
    skew_dx = np.tan(np.radians(cfg.stack_skew))

    with plot_context(cfg.style, cfg.fontfamily):
        _fig, ax = get_or_make_axes(ax, cfg.figsize)

        fills = (
            sampled_colors(cfg.cmap, cfg.cmap_start, cfg.cmap_end, n_stack)
            if cfg.cmap is not None
            else None
        )

        # Draw back-to-front so nearer (lower-index) traces occlude correctly.
        for i in reversed(range(n_stack)):
            base = i * cfg.stack_offset
            y = traces[i] * cfg.stack_scale + base
            x = x_vals + base * skew_dx
            labeled = (i % cfg.stack_label_step == 0) or (i == n_stack - 1)

            if fills is not None:
                ax.fill_between(
                    x, base, y,
                    color=fills[i], alpha=cfg.alpha, linewidth=0,
                    zorder=n_stack - i, clip_on=False,
                )
            ax.plot(
                x, y,
                color="black",
                linewidth=cfg.linewidth_highlight if labeled else cfg.linewidth,
                zorder=n_stack - i + 0.1,
                clip_on=False,
            )
            if labeled:
                ax.text(
                    x.min() + cfg.stack_label_x_offset,
                    base + cfg.stack_offset * cfg.stack_label_y_offset,
                    f"{stack_vals[i]:.0f} {stack_unit}",
                    fontsize=cfg.ticklabelsize,
                    color="black", ha="left", va="center",
                    fontweight="bold", clip_on=False,
                )

        ax.set_xlabel(
            f"{cfg.xlabel or title_case(x_name)} [{x_unit}]",
            fontsize=cfg.labelsize,
            fontweight="bold",
        )
        if not ax.xaxis_inverted():
            ax.invert_xaxis()
        ax.set_xlim(x_vals.max() + cfg.pad_left, x_vals.min() - cfg.pad_right)
        ax.xaxis.set_minor_locator(AutoMinorLocator(cfg.xminor_locator))
        ax.tick_params(
            axis="x", which="major", direction="out",
            length=6, width=1.2, labelsize=cfg.ticklabelsize,
        )
        ax.tick_params(axis="x", which="minor", direction="out", length=3, width=1)
        ax.set_yticks([])
        for side in ("left", "right", "top"):
            ax.spines[side].set_visible(False)
        ax.spines["bottom"].set_linewidth(1.2)

        if cfg.annotation:
            ax.text(
                0.0, 0.97, cfg.annotation,
                transform=ax.transAxes,
                fontsize=cfg.labelsize - 1,
                fontstyle="italic", color="gray", ha="left", va="top",
            )

    return ax
