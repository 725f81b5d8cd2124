"""xarray interop (PyTorch port of :mod:`xmris_tpu.interop.xarray`):
conversion and optional registration of the ``.xmr`` accessor.

xarray is optional: the import is tried once (``HAS_XARRAY``); with it,
:func:`register_xarray_accessors` makes ``xr.DataArray.xmr`` and
``xr.Dataset.xmr`` work by converting to the native carrier, running the
port and converting back (host numpy payloads both ways); without it,
registration is a no-op that returns False and the conversions raise
``ImportError``.  Every delegated method is written out, so each return
type's conversion is visible.
"""

from __future__ import annotations

from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset

try:
    import xarray as xr

    HAS_XARRAY = True
except ImportError:  # pragma: no cover - exercised in envs with xarray
    xr = None
    HAS_XARRAY = False


def _require_xarray():
    if not HAS_XARRAY:
        raise ImportError(
            "xarray is not installed. Install it to use xarray interop "
            "(`pip install xarray`); the native XmrArray API works without it."
        )


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def from_xarray(da) -> XmrArray:
    """Convert an ``xarray.DataArray`` to a native :class:`XmrArray`."""
    _require_xarray()
    out = XmrArray(
        da.values,
        dims=tuple(da.dims),
        attrs=dict(da.attrs),
        name=da.name,
    )
    coords = {}
    for cname, cvar in da.coords.items():
        if cvar.ndim != 1:
            continue  # only 1-D coords are representable
        coords[str(cname)] = Coord(str(cvar.dims[0]), cvar.values, dict(cvar.attrs))
    out.coords = coords
    return out


def to_xarray(da: XmrArray):
    """Convert a native :class:`XmrArray` to an ``xarray.DataArray``."""
    _require_xarray()
    coords = {
        cname: (c.dim, c.values, c.attrs) for cname, c in da.coords.items()
    }
    return xr.DataArray(
        da.values, dims=da.dims, coords=coords, attrs=dict(da.attrs), name=da.name
    )


def from_xarray_dataset(ds) -> XmrDataset:
    """Convert an ``xarray.Dataset`` to a native :class:`XmrDataset`."""
    _require_xarray()
    out = XmrDataset(attrs=dict(ds.attrs))
    for name in ds.data_vars:
        out[str(name)] = from_xarray(ds[name])
    return out


def to_xarray_dataset(ds: XmrDataset):
    """Convert a native :class:`XmrDataset` to an ``xarray.Dataset``."""
    _require_xarray()
    variables = {name: to_xarray(var) for name, var in ds.items()}
    return xr.Dataset(variables, attrs=dict(ds.attrs))


def _returned(result):
    """Convert a native return value back into the xarray world.

    ``XmrArray`` -> ``DataArray``, ``XmrDataset`` -> ``Dataset`` (the
    ``fit_amares`` path); anything else (figures, widgets, scalars) passes
    through untouched.
    """
    if isinstance(result, XmrArray):
        return to_xarray(result)
    if isinstance(result, XmrDataset):
        return to_xarray_dataset(result)
    return result


# ---------------------------------------------------------------------------
# Adapters (defined lazily: they subclass nothing and hold a native accessor)
# ---------------------------------------------------------------------------


def _build_dataarray_adapter():
    from xmris_tpu_torch.core.accessor import XmrisAccessor

    class XmrisXarrayAccessor:
        """``.xmr`` on ``xarray.DataArray``: convert, delegate, convert back.

        Every method is delegated explicitly so each return type's
        conversion is visible; ``plot``/``widget`` return the native
        sub-accessors directly (their methods raise ``NotImplementedError``
        until ROADMAP.md queue 1, item 13 ports the visualization).
        """

        def __init__(self, xarray_obj):
            self._native = XmrisAccessor(from_xarray(xarray_obj))

        # --- sub-accessors (terminal namespaces) ---
        @property
        def plot(self):
            """Array plotting namespace."""
            return self._native.plot

        @property
        def widget(self):
            """Interactive widget namespace."""
            return self._native.widget

        # --- coordinate translations ---
        def to_ppm(self, *args, **kwargs):
            return _returned(self._native.to_ppm(*args, **kwargs))

        def to_hz(self, *args, **kwargs):
            return _returned(self._native.to_hz(*args, **kwargs))

        # --- Fourier ---
        def fftshift(self, *args, **kwargs):
            return _returned(self._native.fftshift(*args, **kwargs))

        def ifftshift(self, *args, **kwargs):
            return _returned(self._native.ifftshift(*args, **kwargs))

        def fft(self, *args, **kwargs):
            return _returned(self._native.fft(*args, **kwargs))

        def ifft(self, *args, **kwargs):
            return _returned(self._native.ifft(*args, **kwargs))

        def fftc(self, *args, **kwargs):
            return _returned(self._native.fftc(*args, **kwargs))

        def ifftc(self, *args, **kwargs):
            return _returned(self._native.ifftc(*args, **kwargs))

        # --- processing ---
        def apodize_exp(self, *args, **kwargs):
            return _returned(self._native.apodize_exp(*args, **kwargs))

        def apodize_lg(self, *args, **kwargs):
            return _returned(self._native.apodize_lg(*args, **kwargs))

        def to_spectrum(self, *args, **kwargs):
            return _returned(self._native.to_spectrum(*args, **kwargs))

        def to_fid(self, *args, **kwargs):
            return _returned(self._native.to_fid(*args, **kwargs))

        def zero_fill(self, *args, **kwargs):
            return _returned(self._native.zero_fill(*args, **kwargs))

        def baseline_als(self, *args, **kwargs):
            return _returned(self._native.baseline_als(*args, **kwargs))

        # --- phasing ---
        def phase(self, *args, **kwargs):
            return _returned(self._native.phase(*args, **kwargs))

        def autophase(self, *args, **kwargs):
            return _returned(self._native.autophase(*args, **kwargs))

        # --- fitting (returns a Dataset) ---
        def fit_amares(self, *args, **kwargs):
            return _returned(self._native.fit_amares(*args, **kwargs))

        # --- vendor ---
        def remove_digital_filter(self, *args, **kwargs):
            return _returned(self._native.remove_digital_filter(*args, **kwargs))

        # --- complex/real utilities ---
        def to_real_imag(self, *args, **kwargs):
            return _returned(self._native.to_real_imag(*args, **kwargs))

        def to_complex(self, *args, **kwargs):
            return _returned(self._native.to_complex(*args, **kwargs))

    # Copy the native docstrings (incl. injected "Required Attributes"
    # sections) onto the delegates so help() matches the native API.
    for _name in vars(XmrisXarrayAccessor):
        if _name.startswith("_"):
            continue
        native_attr = getattr(XmrisAccessor, _name, None)
        adapter_attr = vars(XmrisXarrayAccessor)[_name]
        if callable(adapter_attr) and native_attr is not None:
            adapter_attr.__doc__ = native_attr.__doc__

    return XmrisXarrayAccessor


def _build_dataset_adapter():
    from xmris_tpu_torch.core.accessor import XmrisDatasetAccessor

    class XmrisXarrayDatasetAccessor:
        """``.xmr`` on ``xarray.Dataset`` (fit results): plotting namespace.

        The reference's Dataset accessor: ``fit_ds.xmr.plot`` is the native
        dataset plotting namespace.
        """

        def __init__(self, xarray_ds):
            self._native = XmrisDatasetAccessor(from_xarray_dataset(xarray_ds))

        @property
        def plot(self):
            """Dataset plotting namespace."""
            return self._native.plot

    return XmrisXarrayDatasetAccessor


def register_xarray_accessors() -> bool:
    """Register ``.xmr`` on xarray objects (no-op if xarray missing).

    Registers on both ``DataArray`` and ``Dataset`` (matching the reference);
    safe to call repeatedly.  Returns True when xarray is present.
    """
    if not HAS_XARRAY:
        return False

    if not hasattr(xr.DataArray, "xmr"):
        xr.register_dataarray_accessor("xmr")(_build_dataarray_adapter())

    if (
        hasattr(xr, "Dataset")
        and hasattr(xr, "register_dataset_accessor")
        and not hasattr(xr.Dataset, "xmr")
    ):
        xr.register_dataset_accessor("xmr")(_build_dataset_adapter())

    return True
