"""Static widget export: kernel-less, self-contained HTML iframes.

Port of :mod:`xmris_tpu.visualization.widget._static_exporter`: extract the
synced traits of a widget, round float arrays to 4 decimals, enforce payload
caps (100k points per trait, ~2.5 MB JSON), inline the widget's JS/CSS together with a mock
``StandaloneModel`` (get/set/on/save_changes), and emit a base64 data-URI
iframe that renders anywhere — docs sites, READMEs, or notebooks without a
kernel.  The same machinery doubles as the no-anywidget rendering backend
(:mod:`xmris_tpu_torch.visualization.widget._backend`).
"""

from __future__ import annotations

import base64
import json
import warnings
from collections.abc import Callable
from typing import Any

import numpy as np

_MODEL_SHIM = """\
class StandaloneModel {
    constructor(data) { this._data = data; this._listeners = {}; }
    get(key) { return this._data[key]; }
    set(key, val) {
        this._data[key] = val;
        (this._listeners[`change:${key}`] || []).forEach((fn) => fn());
    }
    save_changes() { return Promise.resolve(); }
    send(msg) { console.warn("No kernel attached; dropped message:", msg); }
    on(events, fn) {
        for (const evt of events.split(" ")) {
            (this._listeners[evt] ||= []).push(fn);
        }
    }
}
"""


def _asset_text(asset) -> str:
    return asset.read_text(encoding="utf-8") if hasattr(asset, "read_text") else str(asset)


def _sanitize(val: Any, name: str, max_points: int, depth: int = 0) -> Any:
    """Round float arrays to 4 dp and enforce the per-trait size cap."""
    if depth > 5:
        return val
    if isinstance(val, dict):
        return {
            k: _sanitize(v, f"{name}.{k}", max_points, depth + 1)
            for k, v in val.items()
        }
    if isinstance(val, (list, tuple, np.ndarray)):
        arr = np.asarray(val)
        if arr.size > max_points:
            raise ValueError(
                f"Widget trait '{name}' holds {arr.size} points (shape "
                f"{arr.shape}), over the static limit of {max_points}. Large "
                f"payloads silently break data-URI iframes — downsample first."
            )
        if np.issubdtype(arr.dtype, np.floating):
            arr = np.round(arr, 4)
        return arr.tolist()
    return val


def extract_synced_traits(widget, max_points: int = 100_000, debug: bool = False):
    """Collect the widget's synchronized (or public, for the kernel-less
    backend) traits as a JSON-ready payload."""
    payload = {}
    for name, trait in widget.traits().items():
        if name in ("layout", "style", "comm") or name.startswith("_"):
            continue
        # anywidget marks synced traits; the HasTraits fallback syncs all
        # public traits by construction.
        if trait.metadata.get("sync", True):
            raw = getattr(widget, name)
            if debug:
                kind = (
                    f"Array(n={np.asarray(raw).size})"
                    if isinstance(raw, (list, tuple, np.ndarray))
                    else f"{type(raw).__name__}={str(raw)[:30]}"
                )
                print(f"  [sync] {name:<16}: {kind}")
            payload[name] = _sanitize(raw, name, max_points)
    return payload


def build_standalone_html(
    widget,
    payload: dict,
    hide_close_button: bool = True,
    hide_selectors: list[str] | None = None,
) -> str:
    """Assemble the standalone HTML document around the widget's JS engine."""
    json_str = json.dumps(payload)
    if len(json_str) > 2_500_000:
        raise ValueError(
            f"Exported widget payload is {len(json_str) / 1048576:.2f} MB; "
            "browsers refuse data URIs this large (blank iframe). Slice or "
            "downsample the DataArray before exporting."
        )

    hide = [".remove-me-close-btn"] if hide_close_button else []
    hide.extend(hide_selectors or [])
    hide_css = (
        ", ".join(hide) + " { display: none !important; }" if hide else ""
    )

    return (
        "<!DOCTYPE html>\n<html lang=\"en\">\n<head>\n<meta charset=\"utf-8\">\n"
        "<meta name=\"viewport\" content=\"width=device-width, initial-scale=1\">\n"
        "<style>\nhtml, body { margin: 0; padding: 0; background: transparent; "
        "overflow: hidden; }\n"
        f"{hide_css}\n{_asset_text(widget._css)}\n</style>\n</head>\n<body>\n"
        "<div id=\"widget-root\"></div>\n<script type=\"module\">\n"
        f"{_MODEL_SHIM}\n{_asset_text(widget._esm)}\n"
        f"const data = {json_str};\n"
        "const model = new StandaloneModel(data);\n"
        "const el = document.getElementById(\"widget-root\");\n"
        "render({ model, el });\n</script>\n</body>\n</html>"
    )


def widget_to_iframe_html(
    widget,
    max_points: int = 100_000,
    height_padding: int = 80,
    width_padding: int = 3,
    hide_close_button: bool = True,
    hide_selectors: list[str] | None = None,
    debug: bool = False,
) -> str:
    """Render a widget instance to an ``<iframe>`` HTML string."""
    payload = extract_synced_traits(widget, max_points=max_points, debug=debug)
    html = build_standalone_html(
        widget, payload,
        hide_close_button=hide_close_button, hide_selectors=hide_selectors,
    )
    uri = "data:text/html;base64," + base64.b64encode(html.encode()).decode("ascii")
    w = getattr(widget, "width", 680)
    h = getattr(widget, "height", 400)
    return (
        f'<iframe src="{uri}" allow="clipboard-write" '
        f'width="{w + width_padding}" height="{h + height_padding}" '
        f'style="border: 1px solid #e0e0e0; border-radius: 8px; overflow: hidden;" '
        f'scrolling="no" loading="lazy"></iframe>'
    )


def export_widget_static(
    widget_func: Callable[..., Any],
    *args: Any,
    max_points: int = 100_000,
    height_padding: int = 80,
    width_padding: int = 3,
    debug: bool = False,
    hide_close_button: bool = True,
    hide_selectors: list[str] | None = None,
    **kwargs: Any,
):
    """Instantiate a widget from its factory and return a static iframe.

    Pass the factory plus its arguments; returns an
    ``IPython.display.HTML`` object embedding the kernel-less widget.
    """
    from IPython.display import HTML

    widget = widget_func(*args, **kwargs)
    if debug:
        print(f"--- Static Export Debug: {widget.__class__.__name__} ---")
    iframe = widget_to_iframe_html(
        widget,
        max_points=max_points,
        height_padding=height_padding,
        width_padding=width_padding,
        hide_close_button=hide_close_button,
        hide_selectors=hide_selectors,
        debug=debug,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return HTML(iframe)
