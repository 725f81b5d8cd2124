"""Legacy ``DEFAULTS`` configuration shim (deprecated; PyTorch port of
:mod:`xmris_tpu.config`): kept for older user code; accessing ``DEFAULTS``
emits a DeprecationWarning pointing at the vocabulary singletons.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass


@dataclass
class Dimension:
    """A dimension, its optional coordinates, and standard units."""

    dim: str
    coords: tuple[str, ...] | None = None
    units: str | None = None


@dataclass
class Attribute:
    """A standard metadata attribute key and its expected units."""

    key: str
    units: str | None = None


class XmrisConfig:
    """Legacy global configuration and nomenclature."""

    def __init__(self):
        self.time = Dimension(dim="time", units="s")
        self.frequency = Dimension(dim="frequency", units="Hz")
        self.chemical_shift = Dimension(dim="chemical_shift", units="ppm")
        self.component = Dimension(dim="component", coords=("real", "imag"))

        self.b0 = Attribute(key="B0", units="T")
        self.mhz = Attribute(key="MHz", units="MHz")
        self.te = Attribute(key="TE", units="s")
        self.tr = Attribute(key="TR", units="s")


_DEFAULTS = XmrisConfig()


def __getattr__(name):
    if name == "DEFAULTS":
        warnings.warn(
            "The `DEFAULTS` configuration object is deprecated and will be removed "
            "in a future release. Please use the new singletons `ATTRS`, `DIMS`, "
            "`COORDS`, and `VARS` from `xmris_tpu_torch.core.config` instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return _DEFAULTS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return ["Dimension", "Attribute", "XmrisConfig", "DEFAULTS"]
