"""Vocabulary: the single source of truth for labeled-array metadata keys.

A copy of :mod:`xmris_tpu.core.config` (pure Python; the port keeps its own
copy so that it imports nothing of the JAX package).  Every dimension,
coordinate, attribute and data-variable name is defined once here as an
:class:`XmrTerm`, with the reference toolbox's string keys.
"""

from __future__ import annotations


class XmrTerm(str):
    """A ``str`` subclass that carries unit/description metadata.

    Because it *is* a string, it can be used directly as a dimension name,
    coordinate key, or attrs key — including as a static argument to jitted
    functions — while tooling can still introspect ``.description``,
    ``.unit`` and ``.long_name``.

    Reference parity: ``src/xmris/core/config.py:9-44`` (``XmrisTerm``).
    """

    description: str
    unit: str

    def __new__(cls, value: str, description: str = "", unit: str = "") -> "XmrTerm":
        obj = str.__new__(cls, value)
        obj.description = description
        obj.unit = unit
        return obj

    @property
    def long_name(self) -> str:
        """Display-friendly name: ``chemical_shift`` -> ``Chemical Shift``."""
        return self.replace("_", " ").title()


# Backwards-compatible alias matching the reference class name.
XmrisTerm = XmrTerm


class BaseVocabulary:
    """Base class for vocabularies: term lookup plus rich Jupyter display.

    Reference parity: ``src/xmris/core/config.py:47-125``.
    """

    def _get_terms(self) -> dict[str, XmrTerm]:
        """Collect every :class:`XmrTerm` attribute defined on the class."""
        return {
            key: val
            for key, val in vars(self.__class__).items()
            if isinstance(val, XmrTerm)
        }

    def get_description(self, target_value: str) -> str:
        """Return the description for a term's *string value*.

        Used by validation decorators to build docstring sections.
        """
        for term in self._get_terms().values():
            if term == target_value:
                return term.description or "No description provided."
        return "Unknown metadata key."

    def _repr_html_(self) -> str:
        """Render the vocabulary as an HTML table for notebooks."""
        cls_name = self.__class__.__name__
        doc = (self.__class__.__doc__ or "").strip()
        subtitle = doc.split("\n")[0] if doc else f"Vocabulary: {cls_name}"

        rows = []
        for prop_name, term in self._get_terms().items():
            unit_html = (
                f"<strong>{term.unit}</strong>"
                if term.unit
                else "<span style='color:#999;'>-</span>"
            )
            rows.append(
                "<tr style='border-bottom:1px solid #eee;'>"
                f"<td style='padding:8px;white-space:nowrap;'><code>{prop_name}</code></td>"
                f"<td style='padding:8px;white-space:nowrap;'><strong><code>\"{term}\"</code></strong></td>"
                f"<td style='padding:8px;white-space:nowrap;'>{unit_html}</td>"
                f"<td style='padding:8px;'>{term.description}</td>"
                "</tr>"
            )

        return (
            "<div style='font-family:sans-serif;max-width:900px;'>"
            f"<h3 style='margin-bottom:4px;'>{cls_name}</h3>"
            f"<p style='margin-top:0;color:#555;'><em>{subtitle}</em></p>"
            "<table style='width:100%;border-collapse:collapse;text-align:left;'>"
            "<tr style='border-bottom:2px solid #ccc;'>"
            "<th style='padding:8px;'>Property</th>"
            "<th style='padding:8px;'>String Key</th>"
            "<th style='padding:8px;'>Unit</th>"
            "<th style='padding:8px;'>Description</th>"
            "</tr>" + "".join(rows) + "</table></div>"
        )


class XmrisAttributes(BaseVocabulary):
    """Official metadata attribute keys for xmris arrays (``.attrs``).

    Reference parity: ``src/xmris/core/config.py:128-223`` — identical string
    keys so that data and lineage round-trip with the reference toolbox.
    """

    reference_frequency = XmrTerm(
        "reference_frequency",
        description=(
            "Measured Larmor frequency of the target nucleus (the actual B0 "
            "during the scan). Divides Hz offsets to produce ppm. Maps to "
            "Bruker 'PVM_FrqRef' / DICOM ImagingFrequency (0018,0084)."
        ),
        unit="MHz",
    )

    carrier_ppm = XmrTerm(
        "carrier_ppm",
        description=(
            "Absolute chemical shift at the center of the RF excitation band "
            "(the shift found at 0 Hz in the baseband signal; ~4.7 ppm for 1H "
            "water). Maps to Bruker 'PVM_FrqWorkPpm'."
        ),
        unit="ppm",
    )

    b0_field = XmrTerm(
        "b0_field", description="Static magnetic field strength B0.", unit="Tesla"
    )

    # --- Phase parameters ---
    phase_p0 = XmrTerm(
        "phase_p0",
        description="Zero-order phase angle applied uniformly across the spectrum.",
        unit="degrees",
    )
    phase_p1 = XmrTerm(
        "phase_p1",
        description=(
            "First-order phase angle: total phase twist across the full "
            "spectral range, anchored at the pivot."
        ),
        unit="degrees",
    )
    phase_pivot = XmrTerm(
        "phase_pivot",
        description="Coordinate value where the first-order phase term is exactly 0.",
        unit="dimension-dependent",
    )
    phase_pivot_coord = XmrTerm(
        "phase_pivot_coord",
        description="Name of the coordinate dimension the phase pivot was defined in.",
    )

    # --- Apodization parameters ---
    apodization_lb = XmrTerm(
        "apodization_lb", description="Exponential line broadening applied.", unit="Hz"
    )
    apodization_gb = XmrTerm(
        "apodization_gb", description="Gaussian broadening applied.", unit="Hz"
    )

    # --- Zero-fill parameters ---
    zero_fill_target = XmrTerm(
        "zero_fill_target", description="Total number of points after zero-filling."
    )
    zero_fill_position = XmrTerm(
        "zero_fill_position", description="Padding position ('end' or 'symmetric')."
    )

    # --- Baseline parameters ---
    baseline_method = XmrTerm(
        "baseline_method", description="Algorithm used for baseline estimation."
    )
    baseline_lam = XmrTerm(
        "baseline_lam",
        description="AsLS smoothness penalty lambda; larger = stiffer baseline.",
    )
    baseline_p = XmrTerm(
        "baseline_p",
        description="AsLS asymmetry parameter; controls how peaks are down-weighted.",
    )
    baseline_iter = XmrTerm(
        "baseline_iter", description="Number of AsLS reweighting iterations."
    )


class XmrisDimensions(BaseVocabulary):
    """Official dimension names for xmris arrays (``.dims``).

    Reference parity: ``src/xmris/core/config.py:226-271``.
    """

    time = XmrTerm("time", description="Time-domain dimension for FID data.")
    frequency = XmrTerm(
        "frequency",
        description=(
            "Relative frequency dimension in Hz, generated by the Fourier "
            "transform or derived from chemical shift via reference_frequency."
        ),
    )
    chemical_shift = XmrTerm(
        "chemical_shift",
        description=(
            "Absolute chemical shift dimension in ppm, derived from frequency "
            "(Hz) via reference_frequency and carrier_ppm."
        ),
    )
    metabolite = XmrTerm("metabolite", description="Quantified metabolite dimension.")
    component = XmrTerm(
        "component", description="Dimension separating real and imaginary parts."
    )

    # --- Acquisition dimensions ---
    average = XmrTerm("average", description="Repeated signal acquisitions / averages.")
    coil = XmrTerm("coil", description="Multi-coil (phased-array) receive channels.")
    echo = XmrTerm("echo", description="Multi-echo acquisitions.")

    # --- k-space ---
    kx = XmrTerm("kx", description="Spatial-frequency dimension along x.")
    ky = XmrTerm("ky", description="Spatial-frequency dimension along y.")
    kz = XmrTerm("kz", description="Spatial-frequency dimension along z.")

    # --- Image space ---
    x = XmrTerm("x", description="Image-space dimension along x.")
    y = XmrTerm("y", description="Image-space dimension along y.")
    z = XmrTerm("z", description="Image-space dimension along z (slice).")


class XmrisCoordinates(BaseVocabulary):
    """Official coordinate names for xmris arrays (``.coords``).

    Reference parity: ``src/xmris/core/config.py:274-293``.
    """

    time = XmrTerm("time", description="Time coordinates.", unit="s")
    frequency = XmrTerm("frequency", description="Frequency coordinates.", unit="Hz")
    chemical_shift = XmrTerm(
        "chemical_shift", description="Chemical shift coordinates.", unit="ppm"
    )

    kx = XmrTerm("kx", description="k-space coordinates along x.", unit="1/m")
    ky = XmrTerm("ky", description="k-space coordinates along y.", unit="1/m")
    kz = XmrTerm("kz", description="k-space coordinates along z.", unit="1/m")

    x = XmrTerm("x", description="Spatial coordinates along x.", unit="mm")
    y = XmrTerm("y", description="Spatial coordinates along y.", unit="mm")
    z = XmrTerm("z", description="Spatial coordinates along z.", unit="mm")


class XmrisDataVars(BaseVocabulary):
    """Official data-variable names for xmris datasets (``.data_vars``).

    Reference parity: ``src/xmris/core/config.py:296-325``.
    """

    original_data = XmrTerm(
        "data", description="Original experimental data (FID or spectrum)."
    )
    fit = XmrTerm("fit", description="Reconstructed model fit (time or frequency domain).")
    residuals = XmrTerm("residuals", description="Original data minus the fit.")
    baseline = XmrTerm("baseline", description="Estimated spectral baseline.")

    amplitude = XmrTerm("amplitude", description="Fitted peak amplitude.")
    chem_shift = XmrTerm("chem_shift", description="Fitted chemical shift.", unit="ppm")
    linewidth = XmrTerm(
        "linewidth", description="Fitted linewidth (damping factor).", unit="Hz"
    )
    phase = XmrTerm("phase", description="Fitted phase.", unit="degrees")
    crlb = XmrTerm(
        "crlb", description="Cramer-Rao lower bound (fit uncertainty).", unit="%"
    )
    snr = XmrTerm("snr", description="Signal-to-noise ratio.")


# =============================================================================
# Global singletons (reference: src/xmris/core/config.py:331-334)
# =============================================================================
ATTRS = XmrisAttributes()
DIMS = XmrisDimensions()
COORDS = XmrisCoordinates()
VARS = XmrisDataVars()
