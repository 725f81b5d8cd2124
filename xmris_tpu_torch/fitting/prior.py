"""AMARES prior-knowledge parsing (pyAMARES CSV layout), numpy only.

A copy of :mod:`xmris_tpu.fitting.prior` for the PyTorch port: the JAX
package's module cannot be imported here because importing anything under
``xmris_tpu`` pulls in jax.  Same table layout and semantics:

* ``Initial Values`` numbers seed the fit;
* ``Bounds`` cells: ``(lo, hi)``, open-ended ``(lo,`` / ``(, hi)``, empty =
  unbounded, ``fixed`` (or lo == hi) pins the parameter;
* an Initial Values cell ``<factor>*<Metab>`` ties the parameter to the
  named metabolite's same parameter with a linear factor.

The result is a :class:`PriorKnowledge`: the free-parameter vector with
bounds plus the affine :class:`~xmris_tpu_torch.fitting.lm.ParamMap` onto the
(n_peaks, 5) physical grid [amplitude, chemicalshift (ppm), linewidth (Hz),
phase (deg), g].
"""

from __future__ import annotations

import csv
import io
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from xmris_tpu_torch.fitting.lm import ParamMap, classify_bounds

PARAM_NAMES = ("amplitude", "chemicalshift", "linewidth", "phase", "g")

_DEFAULT_INIT = {
    "amplitude": 1.0, "chemicalshift": 0.0, "linewidth": 10.0, "phase": 0.0,
    "g": 0.0,
}

_TIE_RE = re.compile(r"^\s*([-+]?[0-9.eE]+)\s*\*\s*([A-Za-z_][\w]*)\s*$")


@dataclass
class PriorKnowledge:
    metabolites: list[str]
    init_free: np.ndarray  # (F,) external initial values
    lower: np.ndarray  # (F,)
    upper: np.ndarray  # (F,)
    kind: np.ndarray  # (F,) bound classification
    pmap: ParamMap
    source: str = ""
    free_labels: list[str] = field(default_factory=list)

    @property
    def n_peaks(self) -> int:
        return len(self.metabolites)

    @property
    def n_free(self) -> int:
        return len(self.init_free)


def _parse_bound_cell(cell: str) -> tuple[float, float] | str | None:
    cell = cell.strip()
    if not cell:
        return None
    if cell.lower() == "fixed":
        return "fixed"
    inner = cell.strip("()").strip()
    parts = [p.strip() for p in inner.split(",")]
    lo = float(parts[0]) if parts and parts[0] not in ("", "-inf") else -np.inf
    hi = (
        float(parts[1])
        if len(parts) > 1 and parts[1] not in ("", "inf")
        else np.inf
    )
    return (lo, hi)


def load_prior_knowledge(path: str | Path) -> PriorKnowledge:
    """Parse a prior-knowledge CSV file into a fit-ready bundle."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f)]
    return _parse_rows(rows, str(path))


def prior_from_csv_text(text: str, source: str = "<text>") -> PriorKnowledge:
    """:func:`load_prior_knowledge` on CSV text held in memory."""
    return _parse_rows(list(csv.reader(io.StringIO(text))), source)


def _parse_rows(rows: list[list[str]], source: str) -> PriorKnowledge:
    if not rows:
        raise ValueError(f"Prior knowledge file {source} is empty.")

    header = [str(c).strip() for c in rows[0]]
    metabolites = [m for m in header[1:] if m]
    n_peaks = len(metabolites)
    if n_peaks == 0:
        raise ValueError(
            f"Prior knowledge file {source} defines no metabolite columns "
            f"(header: {header})."
        )

    inits: dict[tuple[str, str], object] = {}
    bounds: dict[tuple[str, str], object] = {}
    # Rows before any explicit marker default to the Initial Values section.
    section = "initialvalues"
    for row in rows[1:]:
        if not row or not str(row[0]).strip():
            continue
        norm = str(row[0]).strip().lower().replace(" ", "")
        if norm in ("initialvalues", "bounds", "expressions", "lessconstraints"):
            section = norm
            continue
        if norm not in PARAM_NAMES:
            continue  # unknown parameter rows are ignored
        for mi, metab in enumerate(metabolites):
            cell = str(row[1 + mi]).strip() if len(row) > 1 + mi else ""
            if section == "initialvalues":
                if cell:
                    inits[(metab, norm)] = cell
            elif section == "bounds":
                parsed = _parse_bound_cell(cell)
                if parsed is not None:
                    bounds[(metab, norm)] = parsed

    idx = np.full(n_peaks * 5, -1, dtype=np.int32)
    scale = np.zeros(n_peaks * 5, dtype=np.float64)
    offset = np.zeros(n_peaks * 5, dtype=np.float64)

    init_free: list[float] = []
    lo_free: list[float] = []
    hi_free: list[float] = []
    labels: list[str] = []
    slot_of: dict[tuple[str, str], int] = {}
    ties: list[tuple[int, float, str, str]] = []  # (flat_j, factor, metab, pname)

    for mi, metab in enumerate(metabolites):
        for pname in PARAM_NAMES:
            j = mi * 5 + PARAM_NAMES.index(pname)
            raw_init = inits.get((metab, pname), None)
            b = bounds.get((metab, pname), None)

            if isinstance(raw_init, str):
                m = _TIE_RE.match(raw_init)
                if m:
                    ties.append((j, float(m.group(1)), m.group(2), pname))
                    continue
                try:
                    init_val = float(raw_init)
                except ValueError:
                    raise ValueError(
                        f"Cannot parse initial value {raw_init!r} for "
                        f"{metab}.{pname} in {source}."
                    )
            elif raw_init is None:
                init_val = _DEFAULT_INIT[pname]
            else:
                init_val = float(raw_init)

            if b == "fixed" or (isinstance(b, tuple) and b[0] == b[1]):
                offset[j] = b[0] if isinstance(b, tuple) else init_val
                continue

            lo, hi = b if isinstance(b, tuple) else (-np.inf, np.inf)
            init_val = float(np.clip(init_val, lo, hi))
            # Nudge initial values off exact bounds: the MINPACK bound
            # transform has zero slope at the edge.
            if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
                margin = 1e-3 * (hi - lo)
                init_val = float(np.clip(init_val, lo + margin, hi - margin))
            elif np.isfinite(lo) and init_val <= lo:
                init_val = lo + max(1e-3, abs(lo) * 1e-3)
            elif np.isfinite(hi) and init_val >= hi:
                init_val = hi - max(1e-3, abs(hi) * 1e-3)
            slot = len(init_free)
            slot_of[(metab, pname)] = slot
            idx[j] = slot
            scale[j] = 1.0
            init_free.append(init_val)
            lo_free.append(lo)
            hi_free.append(hi)
            labels.append(f"{metab}.{pname}")

    for j, factor, target_metab, pname in ties:
        key = (target_metab, pname)
        if key not in slot_of:
            raise ValueError(
                f"Tie target {target_metab}.{pname} is not a free parameter "
                f"(referenced from flat slot {j} in {source})."
            )
        idx[j] = slot_of[key]
        scale[j] = factor

    lower = np.asarray(lo_free, dtype=np.float64)
    upper = np.asarray(hi_free, dtype=np.float64)
    return PriorKnowledge(
        metabolites=metabolites,
        init_free=np.asarray(init_free, dtype=np.float64),
        lower=lower,
        upper=upper,
        kind=classify_bounds(lower, upper),
        pmap=ParamMap(idx=idx, scale=scale, offset=offset, n_peaks=n_peaks),
        source=source,
        free_labels=labels,
    )


def prior_from_numpy(pk) -> PriorKnowledge:
    """The port's :class:`PriorKnowledge` from another prior's numpy fields.

    Duck-typed: ``pk`` needs ``metabolites``, ``init_free``, ``lower``,
    ``upper``, ``kind``, ``pmap`` (with ``idx``, ``scale``, ``offset``,
    ``n_peaks``) and ``free_labels`` — e.g. a prior parsed by the JAX
    package, so both packages can be handed identical state.
    """
    return PriorKnowledge(
        metabolites=list(pk.metabolites),
        init_free=np.asarray(pk.init_free, dtype=np.float64).copy(),
        lower=np.asarray(pk.lower, dtype=np.float64).copy(),
        upper=np.asarray(pk.upper, dtype=np.float64).copy(),
        kind=np.asarray(pk.kind, dtype=np.int32).copy(),
        pmap=ParamMap(
            idx=np.asarray(pk.pmap.idx, dtype=np.int32).copy(),
            scale=np.asarray(pk.pmap.scale, dtype=np.float64).copy(),
            offset=np.asarray(pk.pmap.offset, dtype=np.float64).copy(),
            n_peaks=int(pk.pmap.n_peaks),
        ),
        source=str(getattr(pk, "source", "")),
        free_labels=list(pk.free_labels),
    )
