"""Shared styling helpers for the plot layer (port of
:mod:`xmris_tpu.visualization.plot._style`).

matplotlib is imported where a figure is drawn, not when the module is
imported, so that the plot package, its configs and
:mod:`xmris_tpu_torch.visualization._host` import without the ``viz`` extra.
"""

from __future__ import annotations

import contextlib

import numpy as np


def resolve_cmap(name: str):
    """Look up a colormap across matplotlib versions."""
    import matplotlib.pyplot as plt

    try:
        return plt.colormaps[name]
    except (AttributeError, TypeError):
        from matplotlib import cm

        return cm.get_cmap(name)


def sampled_colors(cmap_name: str, start: float, end: float, n: int):
    """Sample ``n`` colors from a colormap between two fractional stops."""
    return resolve_cmap(cmap_name)(np.linspace(start, end, n))


@contextlib.contextmanager
def plot_context(style: str, fontfamily: str, axes_linewidth: float = 1.2):
    """Style-sheet + rc context shared by every plot function."""
    import matplotlib.pyplot as plt

    rc = {"font.family": fontfamily, "axes.linewidth": axes_linewidth}
    with plt.style.context(style), plt.rc_context(rc):
        yield


def get_or_make_axes(ax, figsize):
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    return fig, ax


def title_case(dim: str) -> str:
    return dim.replace("_", " ").title()
