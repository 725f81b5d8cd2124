"""The ``.xmr`` fluent accessor namespace (PyTorch port).

Port of :mod:`xmris_tpu.core.accessor`: a flat, chainable API
(``da.xmr.zero_fill(...).xmr.apodize_exp(lb=5).xmr.to_spectrum().xmr.autophase()``)
composed from the same mixins, on :class:`~xmris_tpu_torch.core.array.XmrArray`
(``da.xmr``); with xarray installed it is also registered on
``xarray.DataArray``/``Dataset`` (:mod:`xmris_tpu_torch.interop.xarray`).

Each operation runs where its function runs: the transforms and the
window on the payload's own namespace, ``autophase``, ``baseline_als`` and
``fit_amares`` on the card unless the caller passes ``device="cpu"``.  The
plotting and widget namespaces keep the reference's method names and
signatures and raise ``NotImplementedError`` (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from xmris_tpu_torch.core.array import XmrArray, XmrDataset
from xmris_tpu_torch.core.config import ATTRS, COORDS, DIMS
from xmris_tpu_torch.core.utils import _check_dims, as_coord
from xmris_tpu_torch.core.validation import requires_attrs
from xmris_tpu_torch.ops.baseline import baseline_als
from xmris_tpu_torch.ops.fid import apodize_exp, apodize_lg, to_fid, to_spectrum, zero_fill
from xmris_tpu_torch.ops.fourier import fft, fftc, fftshift, ifft, ifftc, ifftshift
from xmris_tpu_torch.ops.phasing import autophase, phase


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md queue 1, item 13 "
        "(visualization)")


# =============================================================================
# Sub-accessors (terminal / visualization tools)
# =============================================================================


class XmrisDatasetPlotAccessor:
    """Plotting namespace for datasets (fit results)."""

    def __init__(self, obj: XmrDataset):
        self._obj = obj

    def trajectory(self, dim: str, metabolites=None, ax=None, config=None):
        """Plot kinetic trajectories with CRLB shading."""
        _not_ported("xmr.plot.trajectory")

    def qc_grid(self, dim: str, config=None):
        """Plot a grid of spectra and fits for visual quality inspection."""
        _not_ported("xmr.plot.qc_grid")


class XmrisPlotAccessor:
    """Plotting namespace for arrays (accessed via ``.xmr.plot``)."""

    def __init__(self, obj: XmrArray):
        self._obj = obj

    def waterfall(self, x_dim=None, stack_dim=None, ax=None, config=None):
        """Ridge plot (2-D waterfall) of stacked 1-D spectra."""
        _not_ported("xmr.plot.waterfall")

    def carpet(self, x_dim=None, stack_dim=None, ax=None, config=None):
        """2-D carpet (heatmap) plot of stacked 1-D spectra."""
        _not_ported("xmr.plot.carpet")


class XmrisWidgetAccessor:
    """Interactive widget namespace (accessed via ``.xmr.widget``)."""

    def __init__(self, obj: XmrArray):
        self._obj = obj

    def phase_spectrum(
        self,
        width: int = 740,
        height: int = 400,
        show_grid: bool = True,
        show_pivot: bool = True,
        **kwargs,
    ):
        """Interactive zero/first-order phase correction widget."""
        _not_ported("xmr.widget.phase_spectrum")

    def scroll_spectra(
        self,
        scroll_axis: str | None = None,
        part: str = "real",
        xlim=None,
        ylim=None,
        show_trace: bool = True,
        trace_count: int = 10,
        width: int = 740,
        height: int = 400,
        **kwargs,
    ):
        """Interactive scroller through a 2-D series of spectra."""
        _not_ported("xmr.widget.scroll_spectra")

    def apodize(
        self,
        dim: str | None = None,
        unit: str = "ppm",
        width: int = 800,
        height: int = 600,
        lb_range: tuple[float, float] = (0.0, 50.0),
        gb_range: tuple[float, float] = (0.0, 50.0),
        **kwargs,
    ):
        """Interactive apodization (line broadening / Lorentz-to-Gauss) widget."""
        _not_ported("xmr.widget.apodize")


# =============================================================================
# Mixins
# =============================================================================


class XmrisSpectrumCoordsMixin:
    """Physical coordinate-system translations (Hz <-> ppm)."""

    @requires_attrs(ATTRS.reference_frequency, ATTRS.carrier_ppm)
    def to_ppm(self, dim: str = DIMS.frequency):
        """Convert a relative frequency axis [Hz] to chemical shift [ppm]."""
        _check_dims(self._obj, dim, "to_ppm")

        mhz = self._obj.attrs[ATTRS.reference_frequency]
        carrier_ppm = self._obj.attrs[ATTRS.carrier_ppm]
        hz_coords = self._obj.coords[dim].values

        ppm_coords = carrier_ppm + (hz_coords / mhz)
        shift_coord = as_coord(COORDS.chemical_shift, dim, ppm_coords)

        obj = self._obj.assign_coords({DIMS.chemical_shift: shift_coord})
        return obj.swap_dims({dim: DIMS.chemical_shift})

    @requires_attrs(ATTRS.reference_frequency, ATTRS.carrier_ppm)
    def to_hz(self, dim: str = DIMS.chemical_shift):
        """Convert a chemical shift axis [ppm] to relative frequency [Hz]."""
        _check_dims(self._obj, dim, "to_hz")

        mhz = self._obj.attrs[ATTRS.reference_frequency]
        carrier_ppm = self._obj.attrs[ATTRS.carrier_ppm]
        ppm_coords = self._obj.coords[dim].values

        hz_coords = (ppm_coords - carrier_ppm) * mhz
        freq_coord = as_coord(COORDS.frequency, dim, hz_coords)

        obj = self._obj.assign_coords({COORDS.frequency: freq_coord})
        return obj.swap_dims({dim: DIMS.frequency})


class XmrisFourierMixin:
    """Generalized N-D Fourier transforms and shifts."""

    def fftshift(self, dim):
        """Roll the zero-frequency component to the center (data + coords)."""
        return fftshift(self._obj, dim=dim)

    def ifftshift(self, dim):
        """Exact inverse of :meth:`fftshift`."""
        return ifftshift(self._obj, dim=dim)

    def fft(self, dim=DIMS.time, out_dim=None):
        """Ortho-normalized N-D FFT (no shifts)."""
        return fft(self._obj, dim=dim, out_dim=out_dim)

    def ifft(self, dim=DIMS.frequency, out_dim=None):
        """Ortho-normalized N-D inverse FFT (no shifts)."""
        return ifft(self._obj, dim=dim, out_dim=out_dim)

    def fftc(self, dim=DIMS.time, out_dim=None):
        """Centered N-D FFT (ifftshift -> fft -> fftshift)."""
        return fftc(self._obj, dim=dim, out_dim=out_dim)

    def ifftc(self, dim=DIMS.frequency, out_dim=None):
        """Centered N-D inverse FFT (ifftshift -> ifft -> fftshift)."""
        return ifftc(self._obj, dim=dim, out_dim=out_dim)


class XmrisProcessingMixin:
    """Common FID processing tools."""

    def apodize_exp(self, dim: str = DIMS.time, lb: float = 1.0):
        """Exponential line-broadening filter ``exp(-pi*lb*t)``."""
        return apodize_exp(self._obj, dim=dim, lb=lb)

    def apodize_lg(self, dim: str = DIMS.time, lb: float = 1.0, gb: float = 1.0):
        """Lorentz-to-Gauss resolution-enhancement filter."""
        return apodize_lg(self._obj, dim=dim, lb=lb, gb=gb)

    def to_spectrum(self, dim: str = DIMS.time, out_dim: str = DIMS.frequency):
        """FID -> centered frequency-domain spectrum."""
        return to_spectrum(self._obj, dim=dim, out_dim=out_dim)

    def to_fid(self, dim: str = DIMS.frequency, out_dim: str = DIMS.time):
        """Centered spectrum -> time-domain FID."""
        return to_fid(self._obj, dim=dim, out_dim=out_dim)

    def zero_fill(
        self, dim: str = DIMS.time, target_points: int = 1024, position: str = "end"
    ):
        """Pad ``dim`` with zeros to ``target_points``."""
        return zero_fill(
            self._obj, dim=dim, target_points=target_points, position=position
        )

    def baseline_als(
        self,
        dim: str = DIMS.frequency,
        lam: float = 1e5,
        p: float = 0.001,
        n_iter: int = 10,
        solver: str = "auto",
        device="cuda",
    ):
        """AsLS baseline correction (real component only), on ``device``."""
        return baseline_als(self._obj, dim=dim, lam=lam, p=p, n_iter=n_iter,
                            solver=solver, device=device)


class XmrisPhasingMixin:
    """Spectral phasing tools."""

    def phase(self, dim=DIMS.frequency, p0: float = 0.0, p1: float = 0.0, pivot=None):
        """Apply zero/first-order phase correction (degrees)."""
        return phase(self._obj, dim=dim, p0=p0, p1=p1, pivot=pivot)

    def autophase(
        self,
        dim=DIMS.frequency,
        method: str = "acme",
        peak_width: int = 100,
        lb: float = 0.0,
        temp_time_dim: str = DIMS.time,
        **kwargs,
    ):
        """Automatically find and apply phase correction (``device`` and the
        search options pass through ``kwargs``)."""
        return autophase(
            self._obj,
            dim=dim,
            method=method,
            peak_width=peak_width,
            lb=lb,
            temp_time_dim=temp_time_dim,
            **kwargs,
        )


# =============================================================================
# Main accessors
# =============================================================================


class XmrisDatasetAccessor:
    """Accessor for :class:`XmrDataset` objects (e.g. fitting results)."""

    def __init__(self, obj: XmrDataset):
        self._obj = obj
        self._plot = None

    @property
    def plot(self) -> XmrisDatasetPlotAccessor:
        """Dataset plotting namespace."""
        if self._plot is None:
            self._plot = XmrisDatasetPlotAccessor(self._obj)
        return self._plot


class XmrisAccessor(
    XmrisSpectrumCoordsMixin, XmrisFourierMixin, XmrisProcessingMixin, XmrisPhasingMixin
):
    """Main accessor: the flat, chainable MRS/MRI operation namespace,
    the ``.xmr`` property of :class:`XmrArray`."""

    def __init__(self, obj: XmrArray):
        self._obj = obj
        self._plot = None
        self._widget = None

    @property
    def plot(self) -> XmrisPlotAccessor:
        """Array plotting namespace."""
        if self._plot is None:
            self._plot = XmrisPlotAccessor(self._obj)
        return self._plot

    @property
    def widget(self) -> XmrisWidgetAccessor:
        """Interactive widget namespace."""
        if self._widget is None:
            self._widget = XmrisWidgetAccessor(self._obj)
        return self._widget

    # --- Fitting ---

    def fit_amares(
        self,
        prior_knowledge_file: str | Path,
        dim: str = "time",
        mhz: float | None = None,
        sw: float | None = None,
        deadtime: float | None = None,
        method: str = "leastsq",
        initialize_with_lm: bool = True,
        num_workers: int = 4,
        init_fid: np.ndarray | None = None,
        **kwargs,
    ) -> XmrDataset:
        """AMARES prior-knowledge time-domain fitting over all voxels: the
        batched bounded LM of :func:`~xmris_tpu_torch.fitting.amares.fit_amares`
        (``num_workers`` is accepted and ignored; ``device``,
        ``device_fids`` and the engine options pass through ``kwargs``)."""
        from xmris_tpu_torch.fitting.amares import fit_amares as _fit_amares

        return _fit_amares(
            self._obj,
            prior_knowledge_file=prior_knowledge_file,
            dim=dim,
            mhz=mhz,
            sw=sw,
            deadtime=deadtime,
            method=method,
            initialize_with_lm=initialize_with_lm,
            num_workers=num_workers,
            init_fid=init_fid,
            **kwargs,
        )

    # --- Vendor specific ---

    def remove_digital_filter(
        self, group_delay: float, dim: str = "time", keep_length: bool = True
    ):
        """Remove the Bruker digital-filter group delay from FID data."""
        from xmris_tpu_torch.vendor.bruker import remove_digital_filter

        return remove_digital_filter(
            self._obj, group_delay=group_delay, dim=dim, keep_length=keep_length
        )

    # --- Utility / formatting ---

    def to_real_imag(self, dim=DIMS.component, coords=("real", "imag")):
        """Split complex data into a stacked real/imag component dimension."""
        from xmris_tpu_torch.ops.utils import to_real_imag as _to_real_imag

        return _to_real_imag(self._obj, dim=dim, coords=coords)

    def to_complex(self, dim=DIMS.component, coords=("real", "imag")):
        """Rebuild complex data from a stacked component dimension."""
        from xmris_tpu_torch.ops.utils import to_complex as _to_complex

        return _to_complex(self._obj, dim=dim, coords=coords)
