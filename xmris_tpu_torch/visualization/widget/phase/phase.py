"""Interactive phase-correction widget (Python model side).

Port of :mod:`xmris_tpu.visualization.widget.phase.phase`: synced traits
for the spectrum payload and phase state, and a factory that validates 1-D
complex input, resolves the spectral dimension by name heuristics, and
pivots at the maximum-magnitude coordinate.  The spectrum comes to the host
once (:func:`~xmris_tpu_torch.visualization._host.phase_traits`).  The
browser engine (``phase.js``) reproduces the phase math of
:func:`xmris_tpu_torch.ops.phasing.phase` per point.
"""

from __future__ import annotations

import pathlib

import traitlets

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.visualization._host import phase_traits
from xmris_tpu_torch.visualization.widget._backend import WidgetBase

_HERE = pathlib.Path(__file__).parent


class PhaseWidget(WidgetBase):
    """Interactive zero/first-order phase correction viewer."""

    _esm = _HERE / "phase.js"
    _css = _HERE / "phase.css"

    width = traitlets.Int(740).tag(sync=True)
    height = traitlets.Int(400).tag(sync=True)
    show_grid = traitlets.Bool(True).tag(sync=True)
    show_pivot = traitlets.Bool(True).tag(sync=True)
    x_coords = traitlets.List().tag(sync=True)
    x_label = traitlets.Unicode("Chemical Shift [ppm]").tag(sync=True)
    reals = traitlets.List().tag(sync=True)
    imags = traitlets.List().tag(sync=True)
    mag = traitlets.List().tag(sync=True)
    p0 = traitlets.Float(0.0).tag(sync=True)
    p1 = traitlets.Float(0.0).tag(sync=True)
    pivot_val = traitlets.Float(0.0).tag(sync=True)


def phase_spectrum(
    da: XmrArray,
    width: int = 740,
    height: int = 400,
    show_grid: bool = True,
    show_pivot: bool = True,
    **kwargs,
) -> PhaseWidget:
    """Open an interactive phase viewer for a 1-D complex spectrum.

    The pivot defaults to the coordinate of the maximum magnitude; closing
    the widget emits a copyable ``.xmr.phase(p0=..., p1=..., pivot=...)``
    snippet so interactive state becomes reproducible pipeline code.
    """
    return PhaseWidget(
        width=width,
        height=height,
        show_grid=show_grid,
        show_pivot=show_pivot,
        **phase_traits(da),
        **kwargs,
    )
