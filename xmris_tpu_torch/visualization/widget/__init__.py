"""Interactive widget layer (port of :mod:`xmris_tpu.visualization.widget`):
kernel-synced (anywidget) or standalone iframes."""

from xmris_tpu_torch.visualization.widget._backend import HAS_ANYWIDGET, WidgetBase
from xmris_tpu_torch.visualization.widget._static_exporter import (
    export_widget_static,
    widget_to_iframe_html,
)
from xmris_tpu_torch.visualization.widget.apodizer.apodizer import (
    ApodizerWidget,
    apodize_interactive,
)
from xmris_tpu_torch.visualization.widget.phase.phase import PhaseWidget, phase_spectrum
from xmris_tpu_torch.visualization.widget.scroller.scroller import (
    ScrollWidget,
    scroll_spectra,
)

__all__ = [
    "HAS_ANYWIDGET",
    "ApodizerWidget",
    "PhaseWidget",
    "ScrollWidget",
    "WidgetBase",
    "apodize_interactive",
    "export_widget_static",
    "phase_spectrum",
    "scroll_spectra",
    "widget_to_iframe_html",
]
