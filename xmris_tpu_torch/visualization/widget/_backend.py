"""Widget backend: anywidget when available, standalone iframes otherwise.

Port of :mod:`xmris_tpu.visualization.widget._backend`.  ``anywidget`` is
optional: every widget is a ``traitlets.HasTraits``
model with ``_esm``/``_css`` assets, and

* with anywidget installed, :class:`WidgetBase` is a real AnyWidget —
  bidirectional kernel sync, the upstream widgets' behavior;
* without it, ``_repr_html_`` renders the widget through the static exporter
  as a **self-contained interactive iframe**: the same JS engine runs against
  an in-browser ``StandaloneModel``, so sliders/drag still work — only
  kernel write-back is absent.
"""

from __future__ import annotations

import pathlib

import traitlets

try:
    import anywidget

    HAS_ANYWIDGET = True

    class WidgetBase(anywidget.AnyWidget):
        """Live kernel-synced widget (anywidget available)."""

except ImportError:  # pragma: no cover - env dependent
    anywidget = None
    HAS_ANYWIDGET = False

    class WidgetBase(traitlets.HasTraits):
        """Kernel-less widget: renders as a standalone interactive iframe."""

        _esm: pathlib.Path | str = ""
        _css: pathlib.Path | str = ""

        def _repr_html_(self) -> str:
            from xmris_tpu_torch.visualization.widget._static_exporter import (
                widget_to_iframe_html,
            )

            return widget_to_iframe_html(self)
