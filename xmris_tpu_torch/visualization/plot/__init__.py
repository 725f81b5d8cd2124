"""Publication-ready plotting layer (host-side matplotlib; port of
:mod:`xmris_tpu.visualization.plot`)."""

from xmris_tpu_torch.visualization.plot._base_config import BasePlotConfig, PlotParam
from xmris_tpu_torch.visualization.plot._input_parsing import parse_input_dims_timeseries
from xmris_tpu_torch.visualization.plot.plot_carpet import CarpetConfig, plot_carpet
from xmris_tpu_torch.visualization.plot.plot_qc_grid import PlotQCGridConfig, plot_qc_grid
from xmris_tpu_torch.visualization.plot.plot_trajectory import (
    PlotTrajectoryConfig,
    plot_trajectory,
)
from xmris_tpu_torch.visualization.plot.plot_waterfall import WaterfallConfig, plot_waterfall

__all__ = [
    "BasePlotConfig",
    "CarpetConfig",
    "PlotParam",
    "PlotQCGridConfig",
    "PlotTrajectoryConfig",
    "WaterfallConfig",
    "parse_input_dims_timeseries",
    "plot_carpet",
    "plot_qc_grid",
    "plot_trajectory",
    "plot_waterfall",
]
