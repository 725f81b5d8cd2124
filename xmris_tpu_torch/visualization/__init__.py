"""Visualization (port of :mod:`xmris_tpu.visualization`): publication plots
+ interactive browser widgets.  matplotlib (the ``viz`` extra) is imported
when a figure is drawn and traitlets (``widgets``) with :mod:`.widget`."""

from xmris_tpu_torch.visualization import plot
from xmris_tpu_torch.visualization.plot import (
    CarpetConfig,
    PlotQCGridConfig,
    PlotTrajectoryConfig,
    WaterfallConfig,
    plot_carpet,
    plot_qc_grid,
    plot_trajectory,
    plot_waterfall,
)


def __getattr__(name):
    if name == "widget":
        import importlib

        return importlib.import_module("xmris_tpu_torch.visualization.widget")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CarpetConfig",
    "PlotQCGridConfig",
    "PlotTrajectoryConfig",
    "WaterfallConfig",
    "plot",
    "plot_carpet",
    "plot_qc_grid",
    "plot_trajectory",
    "plot_waterfall",
    "widget",
]
