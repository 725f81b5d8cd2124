"""Self-documenting plot configuration base class (port of
:mod:`xmris_tpu.visualization.plot._base_config`).

Dataclass configs whose fields carry *group* and *description* metadata,
rendered as rich tables in Jupyter (HTML), markdown, and plain terminals.
"""

from __future__ import annotations

import dataclasses
import shutil
import textwrap
from typing import Any


def PlotParam(default: Any, group: str, description: str) -> Any:
    """A dataclass field carrying display metadata (group + description)."""
    return dataclasses.field(
        default=default, metadata={"group": group, "description": description}
    )


class BasePlotConfig:
    """Base class for plot configs with rich self-documentation.

    Subclasses are plain dataclasses whose fields use :func:`PlotParam`;
    printing an instance (or displaying it in a notebook) renders a grouped
    parameter table with current values, types, and descriptions.
    """

    _UNGROUPED = "Other / Ungrouped"

    # -- introspection ------------------------------------------------------

    def _rows(self):
        """Yield (group, name, value-repr, type-name, description) tuples in
        declaration order, grouped."""
        by_group: dict[str, list] = {}
        for f in dataclasses.fields(self):
            group = f.metadata.get("group", self._UNGROUPED)
            tname = getattr(f.type, "__name__", None) or str(f.type)
            by_group.setdefault(group, []).append(
                (
                    f.name,
                    repr(getattr(self, f.name)),
                    tname,
                    f.metadata.get("description", ""),
                )
            )
        for group, rows in by_group.items():
            for row in rows:
                yield (group, *row)

    def _headline(self) -> str:
        doc = (self.__class__.__doc__ or "").strip()
        for line in doc.splitlines():
            if line.strip():
                return line.strip()
        return f"Settings for {self.__class__.__name__}"

    # -- renderers ----------------------------------------------------------

    def _repr_html_(self) -> str:
        cells = []
        last_group = None
        for group, name, value, tname, desc in self._rows():
            if group != last_group:
                cells.append(
                    "<tr><td colspan='4' style='text-align:right;font-weight:bold;"
                    "background:rgba(128,128,128,.08);text-transform:uppercase;"
                    f"font-size:11px;letter-spacing:.5px;padding:4px 8px;'>{group}</td></tr>"
                )
                last_group = group
            cells.append(
                "<tr style='border-bottom:1px solid rgba(128,128,128,.2);'>"
                f"<td style='padding:4px 8px;'><strong>{name}</strong></td>"
                f"<td style='padding:4px 8px;text-align:center;'><code>{value}</code></td>"
                f"<td style='padding:4px 8px;text-align:center;opacity:.7;"
                f"font-style:italic;'>{tname}</td>"
                f"<td style='padding:4px 8px;'>{desc}</td></tr>"
            )
        head = "".join(
            f"<th style='padding:4px 8px;border-bottom:2px solid rgba(128,128,128,.5);"
            f"background:rgba(128,128,128,.15);text-align:center;'>{h}</th>"
            for h in ("Parameter", "Current Value", "Type", "Description")
        )
        return (
            "<div style='font-family:sans-serif;max-width:850px;line-height:1.3;'>"
            f"<h4 style='margin:0 0 4px 0;'>{self.__class__.__name__}</h4>"
            f"<p style='opacity:.8;margin:0 0 8px 0;font-size:12px;'>{self._headline()}</p>"
            "<table style='width:100%;border-collapse:collapse;text-align:left;"
            f"font-size:12px;'><tr>{head}</tr>{''.join(cells)}</table></div>"
        )

    def _repr_markdown_(self) -> str:
        out = [f"### {self.__class__.__name__}", f"\n*{self._headline()}*\n"]
        last_group = None
        for group, name, value, tname, desc in self._rows():
            if group != last_group:
                out.append(f"\n**{group.upper()}**\n")
                out.append("| Parameter | Current Value | Type | Description |")
                out.append("| :--- | :---: | :---: | :--- |")
                last_group = group
            out.append(f"| `{name}` | `{value}` | *{tname}* | {desc} |")
        return "\n".join(out)

    def __str__(self) -> str:
        width = shutil.get_terminal_size((100, 20)).columns
        rows = list(self._rows())
        w_name = max(len(r[1]) for r in rows) + 2
        w_val = max(len(r[2]) for r in rows) + 2
        w_type = max(len(r[3]) for r in rows) + 2
        w_desc = max(width - w_name - w_val - w_type - 6, 20)

        bar = "=" * width
        out = [
            f"\n{bar}",
            f"{self.__class__.__name__} - Current Settings".center(width),
            bar,
        ]
        last_group = None
        for group, name, value, tname, desc in rows:
            if group != last_group:
                out.append(f"\n[ {group.upper()} ]".rjust(width))
                last_group = group
            desc_lines = [
                w for ln in desc.splitlines() for w in (textwrap.wrap(ln, w_desc) or [""])
            ] or [""]
            out.append(
                f"  {name:<{w_name}} {value:<{w_val}} {tname:<{w_type}} | {desc_lines[0]}"
            )
            pad = " " * (w_name + w_val + w_type + 4)
            out.extend(f"{pad} | {extra}" for extra in desc_lines[1:])
        out.append(f"{bar}\n")
        return "\n".join(out)
