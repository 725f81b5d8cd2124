"""Interactive spectra scroller widget (Python model side).

Port of :mod:`xmris_tpu.visualization.widget.scroller.scroller`: strict
2-D input, component selection (real/imag/abs), scroll-dimension
auto-detection (repetitions > averages > time > whatever remains), timeline
scrubbing with playback and fading history trails in the browser engine,
and an "Extract Slice" action that emits the exact ``.isel(...)`` snippet.
The series comes to the host once
(:func:`~xmris_tpu_torch.visualization._host.scroll_traits`).
"""

from __future__ import annotations

import pathlib

import traitlets

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.visualization._host import scroll_traits
from xmris_tpu_torch.visualization.widget._backend import WidgetBase

_HERE = pathlib.Path(__file__).parent


class ScrollWidget(WidgetBase):
    """Interactive browser for a 2-D series of spectra."""

    _esm = _HERE / "scroller.js"
    _css = _HERE / "scroller.css"

    width = traitlets.Int(740).tag(sync=True)
    height = traitlets.Int(400).tag(sync=True)
    x_coords = traitlets.List().tag(sync=True)
    x_label = traitlets.Unicode("Chemical Shift [ppm]").tag(sync=True)
    spectra = traitlets.List().tag(sync=True)
    scroll_dim = traitlets.Unicode("").tag(sync=True)
    current_index = traitlets.Int(0).tag(sync=True)
    show_trace = traitlets.Bool(True).tag(sync=True)
    trace_count = traitlets.Int(10).tag(sync=True)
    xlim = traitlets.List(default_value=[]).tag(sync=True)
    ylim = traitlets.List(default_value=[]).tag(sync=True)


def scroll_spectra(
    da: XmrArray,
    scroll_axis: str | None = None,
    part: str = "real",
    xlim: tuple[float, float] | None = None,
    ylim: tuple[float, float] | None = None,
    show_trace: bool = True,
    trace_count: int = 10,
    width: int = 740,
    height: int = 400,
    **kwargs,
) -> ScrollWidget:
    """Open an interactive scroller through a 2-D spectra series."""
    return ScrollWidget(
        width=width,
        height=height,
        **scroll_traits(da, scroll_axis, part),
        current_index=0,
        show_trace=show_trace,
        trace_count=int(trace_count),
        xlim=list(xlim) if xlim is not None else [],
        ylim=list(ylim) if ylim is not None else [],
        **kwargs,
    )
