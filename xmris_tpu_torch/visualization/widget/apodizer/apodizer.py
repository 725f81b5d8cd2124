"""Interactive apodization widget (Python model side).

Port of :mod:`xmris_tpu.visualization.widget.apodizer.apodizer`: the
factory zero-fills the FID to the next power of two where it lies, derives
the spectral axis through the port's own pipeline (``to_spectrum`` +
``to_ppm``/``to_hz``), and ships the time-domain data to the browser in one
host copy (:func:`~xmris_tpu_torch.visualization._host.apodize_traits`).
The browser's DSP engine (``apodizer.js``) re-implements the
ortho-normalized radix-2 FFT, fftshift, and the exp / Lorentz-to-Gauss
windows 1:1 with :mod:`xmris_tpu_torch.ops.fid` for live preview.
"""

from __future__ import annotations

import pathlib

import traitlets

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.visualization._host import apodize_traits
from xmris_tpu_torch.visualization.widget._backend import WidgetBase

_HERE = pathlib.Path(__file__).parent


class ApodizerWidget(WidgetBase):
    """Interactive line-broadening / resolution-enhancement viewer."""

    _esm = _HERE / "apodizer.js"
    _css = _HERE / "apodizer.css"

    width = traitlets.Int(740).tag(sync=True)
    height = traitlets.Int(550).tag(sync=True)

    t_coords = traitlets.List().tag(sync=True)
    x_coords = traitlets.List().tag(sync=True)
    x_label = traitlets.Unicode("Chemical Shift [ppm]").tag(sync=True)

    reals_t = traitlets.List().tag(sync=True)
    imags_t = traitlets.List().tag(sync=True)

    lb = traitlets.Float(0.0).tag(sync=True)
    gb = traitlets.Float(0.0).tag(sync=True)

    lb_min = traitlets.Float(0.0).tag(sync=True)
    lb_max = traitlets.Float(50.0).tag(sync=True)
    gb_min = traitlets.Float(0.0).tag(sync=True)
    gb_max = traitlets.Float(50.0).tag(sync=True)

    method = traitlets.Unicode("exp").tag(sync=True)
    display_mode = traitlets.Unicode("real").tag(sync=True)
    show_orig = traitlets.Bool(False).tag(sync=True)
    show_grid = traitlets.Bool(True).tag(sync=True)


def apodize_interactive(
    da: XmrArray,
    dim: str | None = None,
    unit: str = "ppm",
    width: int = 740,
    height: int = 550,
    lb_range: tuple[float, float] = (0.0, 50.0),
    gb_range: tuple[float, float] = (0.0, 50.0),
    **kwargs,
) -> ApodizerWidget:
    """Open an interactive apodization viewer for a 1-D time-domain FID."""
    return ApodizerWidget(
        width=width,
        height=height,
        **apodize_traits(da, dim, unit),
        lb_min=lb_range[0],
        lb_max=lb_range[1],
        gb_min=gb_range[0],
        gb_max=gb_range[1],
        **kwargs,
    )
