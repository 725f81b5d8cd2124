"""What each figure and widget draws, as host arrays.

The plots and widgets consume results.  The ops they run (``to_spectrum``,
``zero_fill``) run where the payload lies: on the card for a CUDA tensor,
on the host for a numpy or CPU payload.  Each array a figure draws then
comes to the host in one copy and is indexed there, panel by panel, where
the reference reads ``.values`` once per panel and trace.  Nothing here
moves a payload to the device.

This module imports neither matplotlib nor traitlets (the optional ``viz``
and ``widgets`` extras), so the data a figure would draw can be built and
checked where those are not installed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from xmris_tpu_torch.core.array import XmrArray, XmrDataset
from xmris_tpu_torch.core.config import DIMS
from xmris_tpu_torch.ops.fid import zero_fill
from xmris_tpu_torch.visualization.plot._input_parsing import (
    parse_input_dims_timeseries,
)


def on_host(da: XmrArray) -> XmrArray:
    """``da`` with its payload copied to the host once; a numpy payload is
    returned as it is."""
    if isinstance(da.data, np.ndarray):
        return da
    return da.copy(data=da.values)


def _coord_or_range(da: XmrArray, dim: str) -> np.ndarray:
    return da.coords[dim].values if dim in da.coords else np.arange(da.sizes[dim])


def _unit(da: XmrArray, dim: str, default):
    return da.coords[dim].attrs.get("units", default) if dim in da.coords else default


class StackView(NamedTuple):
    """A (stack, x) series of 1-D spectra on the host."""

    x_name: str
    stack_name: str
    x: np.ndarray
    stack: np.ndarray
    values: np.ndarray  # (stack, x)
    x_unit: str
    stack_unit: str


def stack_view(
    da: XmrArray, x_dim: str | None = None, stack_dim: str | None = None
) -> StackView:
    """Resolve the dims of a stacked-spectra plot and copy the (stack, x)
    values to the host once (waterfall and carpet)."""
    x_name, stack_name = parse_input_dims_timeseries(da, x_dim, stack_dim)
    view = da.transpose(stack_name, x_name)
    return StackView(
        x_name,
        stack_name,
        _coord_or_range(view, x_name),
        _coord_or_range(view, stack_name),
        view.values,
        _unit(view, x_name, "ppm"),
        _unit(view, stack_name, "s"),
    )


class TrajectoryLines(NamedTuple):
    """Per-metabolite amplitude lines and CRLB bands on the host."""

    series: np.ndarray
    unit: str | None
    lines: list  # [(metabolite, amplitudes, band half-width)]


def trajectory_lines(
    ds: XmrDataset, dim: str, metabolites: list[str] | None = None
) -> TrajectoryLines:
    """Amplitude and absolute CRLB band (``amp * crlb / 100``, NaN CRLB as
    0) per metabolite along ``dim``; amplitude and CRLB come to the host
    once each."""
    for v in ("amplitude", "crlb"):
        if v not in ds:
            raise ValueError(f"Dataset missing required AMARES variable: {v}")
    if dim not in ds.dims:
        raise ValueError(f"Dimension '{dim}' not found in Dataset.")

    amp_var = on_host(ds["amplitude"])
    crlb_var = on_host(ds["crlb"])
    all_metabs = list(amp_var.coords["Metabolite"].values)
    metab_list = metabolites if metabolites is not None else all_metabs

    coords = ds.coords
    series = coords[dim].values if dim in coords else np.arange(amp_var.sizes[dim])
    unit = coords[dim].attrs.get("units") if dim in coords else None

    lines = []
    for metab in metab_list:
        amps = amp_var.sel({"Metabolite": metab}).values
        crlbs = np.nan_to_num(crlb_var.sel({"Metabolite": metab}).values, nan=0.0)
        lines.append((metab, amps, amps * (crlbs / 100.0)))
    return TrajectoryLines(series, unit, lines)


class QCPanels(NamedTuple):
    """The selected indices of a QC grid and their real spectra on the host."""

    indices: np.ndarray
    dim_coords: np.ndarray
    dim_unit: str
    freq: np.ndarray
    freq_unit: str
    raw: XmrArray
    fit: XmrArray
    res: XmrArray | None
    crlb: XmrArray


def qc_panels(
    ds: XmrDataset,
    dim: str,
    max_plots: int | None = None,
    plot_residuals: bool = True,
) -> QCPanels:
    """Select up to ``max_plots`` evenly spaced indices along ``dim``, turn
    their raw, fit and residual FIDs into real spectra where the payload
    lies, and copy those and the CRLBs to the host once each."""
    for v in ("fit_data", "raw_data", "crlb"):
        if v not in ds:
            raise ValueError(f"Dataset missing required AMARES variable: {v}")
    if dim not in ds.dims:
        raise ValueError(f"Dimension '{dim}' not found in Dataset.")

    n_total = ds.dims[dim]
    if max_plots is None or n_total <= max_plots:
        indices = np.arange(n_total)
    else:
        indices = np.linspace(0, n_total - 1, max_plots, dtype=int)

    coords = ds.coords
    dim_coords = coords[dim].values if dim in coords else np.arange(n_total)
    dim_unit = coords[dim].attrs.get("units", "") if dim in coords else ""

    freq_dim = DIMS.frequency
    idx_list = indices.tolist()

    def spectra(var):
        sel = ds[var].isel({dim: idx_list})
        return on_host(sel.xmr.to_spectrum(out_dim=freq_dim).real)

    raw = spectra("raw_data")
    res = spectra("residuals") if plot_residuals and "residuals" in ds else None
    return QCPanels(
        indices,
        dim_coords,
        dim_unit,
        raw.coords[freq_dim].values,
        raw.coords[freq_dim].attrs.get("units", "Hz"),
        raw,
        spectra("fit_data"),
        res,
        on_host(ds["crlb"].isel({dim: idx_list})),
    )


# ---------------------------------------------------------------------------
# Widget payloads: the synced traits each factory builds from its input
# ---------------------------------------------------------------------------


def resolve_spectral_dim(da: XmrArray) -> tuple[str, str]:
    """Pick the spectral dimension by common naming conventions."""
    for d in da.dims:
        low = str(d).lower()
        if any(k in low for k in ("ppm", "chem", "shift")):
            return str(d), "Chemical Shift [ppm]"
        if any(k in low for k in ("hz", "freq")):
            return str(d), "Frequency [Hz]"
    return str(da.dims[0]), str(da.dims[0])


def phase_traits(da: XmrArray) -> dict:
    """The phase widget's payload: the 1-D complex spectrum's parts and
    magnitude, its axis, and the pivot at the maximum magnitude."""
    if da.ndim != 1:
        raise ValueError(f"Input must be 1-D, but has shape {da.shape}.")
    values = da.values
    if not np.iscomplexobj(values):
        raise ValueError("Phasing requires complex-valued data (Real + Imaginary).")

    spec_dim, x_label = resolve_spectral_dim(da)
    x_vals = (
        da.coords[spec_dim].values.astype(float)
        if spec_dim in da.coords
        else np.arange(len(values), dtype=float)
    )
    mag_vals = np.abs(values).astype(float)
    return dict(
        x_coords=x_vals.tolist(),
        x_label=x_label,
        reals=np.real(values).astype(float).tolist(),
        imags=np.imag(values).astype(float).tolist(),
        mag=mag_vals.tolist(),
        pivot_val=float(x_vals[int(np.argmax(mag_vals))]),
    )


def scroll_traits(
    da: XmrArray, scroll_axis: str | None = None, part: str = "real"
) -> dict:
    """The scroller's payload: a 2-D series as (scroll, spectral) rows of
    one component, the axis, and the scroll dimension."""
    if da.ndim != 2:
        raise ValueError(f"Input must be exactly 2-D, but has shape {da.shape}.")

    spec_dim, x_label = resolve_spectral_dim(da)
    if spec_dim == str(da.dims[0]) and not any(
        k in spec_dim.lower() for k in ("ppm", "chem", "shift", "hz", "freq")
    ):
        # name heuristic found nothing: assume the last dim is spectral
        spec_dim = str(da.dims[-1])
        x_label = spec_dim

    if scroll_axis is not None:
        if scroll_axis not in da.dims:
            raise ValueError(
                f"Requested scroll_axis '{scroll_axis}' not found in dimensions: "
                f"{da.dims}"
            )
        if scroll_axis == spec_dim:
            # Scrolling ALONG the spectral axis would render a silently
            # transposed widget (frames labeled with spectral coords).
            raise ValueError(
                f"scroll_axis '{scroll_axis}' is the spectral dimension; "
                "scroll along the other dimension "
                f"({[str(d) for d in da.dims if str(d) != spec_dim]})."
            )
        scroll_dim = scroll_axis
    else:
        remaining = [str(d) for d in da.dims if str(d) != spec_dim]
        scroll_dim = remaining[0]
        for candidate in ("repetitions", "averages", "time"):
            if candidate in remaining:
                scroll_dim = candidate
                break

    vals = da.values
    if np.iscomplexobj(vals):
        selector = part.lower()
        if selector in ("real", "re"):
            vals = np.real(vals)
        elif selector in ("imag", "im"):
            vals = np.imag(vals)
        elif selector in ("abs", "mag", "magnitude"):
            vals = np.abs(vals)
        else:
            raise ValueError(f"Unknown part '{part}'. Use 'real', 'imag', or 'abs'.")
    vals = vals.astype(float)

    # Arrange as (scroll, spectral)
    if list(da.dims).index(scroll_dim) > list(da.dims).index(spec_dim):
        vals = vals.T

    x_vals = (
        da.coords[spec_dim].values.astype(float)
        if spec_dim in da.coords
        else np.arange(vals.shape[1], dtype=float)
    )
    return dict(
        x_coords=x_vals.tolist(),
        x_label=x_label,
        spectra=vals.tolist(),
        scroll_dim=str(scroll_dim),
    )


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _spectral_axis(da: XmrArray, time_dim: str, unit: str):
    """Run the FID through the framework's own pipeline for the exact x
    axis.

    The browser engine recomputes spectra live from the time-domain payload;
    only the axis (ppm or Hz) comes from the Python side, so it must agree
    with what ``to_spectrum``/``to_ppm`` would produce.
    """
    spec = da.xmr.to_spectrum(dim=time_dim)
    if unit.lower() == "ppm":
        spec, label = spec.xmr.to_ppm(), "Chemical Shift [ppm]"
    else:
        axis_name = str(spec.dims[0]).lower()
        if "ppm" in axis_name or "shift" in axis_name:
            spec = spec.xmr.to_hz()
        label = "Frequency [Hz]"
    return spec.coords[str(spec.dims[0])].values.astype(float), label


def apodize_traits(da: XmrArray, dim: str | None = None, unit: str = "ppm") -> dict:
    """The apodizer's payload: the 1-D FID zero-filled to a power of two
    where it lies, its time axis, and the spectral axis in ``unit``."""
    if da.ndim != 1:
        raise ValueError(f"Input must be 1-D, but has shape {da.shape}.")

    time_dim = dim or str(da.dims[0])

    # The browser DSP engine is radix-2, so round the record up to the next
    # power of two with the framework's own zero_fill (end padding + linear
    # coordinate extrapolation — the same op users would chain themselves).
    da = zero_fill(da, dim=time_dim, target_points=_next_pow2(da.sizes[time_dim]))

    x_vals, x_label = _spectral_axis(da, time_dim, unit)

    payload = np.asarray(da.values)
    if not np.iscomplexobj(payload):
        payload = payload.astype(complex)
    return dict(
        t_coords=da.coords[time_dim].values.astype(float).tolist(),
        x_coords=x_vals.tolist(),
        x_label=x_label,
        reals_t=payload.real.tolist(),
        imags_t=payload.imag.tolist(),
    )
