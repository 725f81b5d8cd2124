"""Array I/O (PyTorch port of :mod:`xmris_tpu.interop.io`): netCDF-3
loading through SciPy and native ``.npz`` round-trips.

The file formats are the reference's, so a file written by either package
loads in the other.  Loads give host (numpy) payloads; a tensor payload is
saved through its host copy (``.values``, i.e. ``.cpu().numpy()``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from xmris_tpu_torch.core.array import Coord, XmrArray


def _decode_attr(val):
    if isinstance(val, bytes):
        return val.decode("utf-8", "replace")
    if isinstance(val, np.generic):
        return val.item()
    return val


def load_dataarray(path: str | Path, variable: str | None = None) -> XmrArray:
    """Load a DataArray-like variable from a classic (netCDF-3) file.

    Reads xarray-written single-variable files (the Bruker raw exports the
    reference ships); attrs attach from the variable, coordinate variables
    become labeled coords.  HDF5-backed netCDF-4 files require h5py/netCDF4
    and raise a clear error when absent.
    """
    path = Path(path)
    with path.open("rb") as fh:
        magic = fh.read(4)
    if magic[:3] != b"CDF":
        raise ValueError(
            f"{path} is not a classic netCDF-3 file (magic {magic!r}). "
            "netCDF-4/HDF5 files need the optional netCDF4 or h5netcdf package."
        )

    from scipy.io import netcdf_file

    f = netcdf_file(str(path), "r", mmap=False)
    try:
        dim_names = set(f.dimensions)
        # Candidate data variables: not pure coordinate variables
        candidates = {
            name: var
            for name, var in f.variables.items()
            if variable is None or name == variable
        }
        if variable is None:
            data_vars = {
                n: v
                for n, v in candidates.items()
                if n not in dim_names and len(v.shape) >= 1
            }
            # Prefer xarray's unnamed-variable sentinel, else largest variable
            if "__xarray_dataarray_variable__" in data_vars:
                name = "__xarray_dataarray_variable__"
            elif data_vars:
                name = max(data_vars, key=lambda n: int(np.prod(data_vars[n].shape)))
            else:
                raise ValueError(f"No data variables found in {path}.")
        else:
            if variable not in candidates:
                raise KeyError(f"Variable {variable!r} not found in {path}.")
            name = variable

        var = f.variables[name]
        dims = tuple(var.dimensions)
        data = np.array(var[:])
        attrs = {k: _decode_attr(v) for k, v in var._attributes.items()}
        attrs.pop("_FillValue", None)

        coords: dict[str, Coord] = {}
        for d in dims:
            if d in f.variables and d != name:
                cvar = f.variables[d]
                cvals = np.array(cvar[:])
                # Fixed-width char coords (e.g. 'realimag') decode to strings
                if cvals.dtype.kind in ("S", "c") and cvals.ndim == 2:
                    cvals = np.array(
                        [b"".join(row).decode() for row in cvals], dtype=object
                    )
                coords[d] = Coord(d, cvals, dict(cvar._attributes))

        out = XmrArray(data, dims=dims, attrs=attrs, name=None)
        out.coords = coords
        return out
    finally:
        f.close()


def _storable(values) -> np.ndarray:
    """Make an array np.savez-safe without pickling.

    Object-dtype arrays (e.g. the ``Metabolite`` coord ``fit_amares``
    creates) would be pickled by ``np.savez`` and then rejected by the
    ``allow_pickle=False`` loaders; store them as fixed-width unicode
    instead.  The original object dtype is recorded in the JSON meta and
    restored by :func:`_restore`.
    """
    arr = np.asarray(values)
    if arr.dtype == object:
        if not all(isinstance(v, str) for v in arr.ravel()):
            raise TypeError(
                "Cannot serialize an object-dtype array with non-string "
                "elements without pickling (allow_pickle is disabled); "
                "convert the values to a numeric or string dtype first."
            )
        return np.asarray(arr, dtype=np.str_)
    return arr


def _restore(arr: np.ndarray, was_object: bool) -> np.ndarray:
    return arr.astype(object) if was_object else arr


def save_npz(da: XmrArray, path: str | Path) -> None:
    """Lossless native serialization of an XmrArray to ``.npz``."""
    coord_meta = {
        cname: {
            "dim": c.dim,
            "attrs": _jsonable(c.attrs),
            "object": np.asarray(c.values).dtype == object,
        }
        for cname, c in da.coords.items()
    }
    arrays = {f"coord::{cname}": _storable(c.values) for cname, c in da.coords.items()}
    np.savez(
        path,
        # _storable on the payload too: an object-dtype data array would be
        # silently pickled here and then rejected by load_npz's
        # allow_pickle=False — the exact save/load asymmetry this module
        # exists to prevent.
        data=_storable(da.values),
        __meta__=np.frombuffer(
            json.dumps(
                {
                    "dims": list(da.dims),
                    "attrs": _jsonable(da.attrs),
                    "name": da.name,
                    "object": np.asarray(da.values).dtype == object,
                    "coords": coord_meta,
                }
            ).encode(),
            dtype=np.uint8,
        ),
        **arrays,
    )


def load_npz(path: str | Path) -> XmrArray:
    """Load an XmrArray previously saved with :func:`save_npz`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        out = XmrArray(
            _restore(z["data"], meta.get("object", False)),
            dims=tuple(meta["dims"]), attrs=meta["attrs"], name=meta["name"]
        )
        coords = {}
        for cname, cm in meta["coords"].items():
            cvals = _restore(z[f"coord::{cname}"], cm.get("object", False))
            coords[cname] = Coord(cm["dim"], cvals, cm["attrs"])
        out.coords = coords
        return out


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def save_dataset_npz(ds, path: str | Path) -> None:
    """Serialize an :class:`~xmris_tpu_torch.core.array.XmrDataset` (e.g. fit
    results) to a single ``.npz``: every variable's payload + metadata."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"attrs": _jsonable(ds.attrs), "vars": {}}
    for name, var in ds.items():
        arrays[f"var::{name}"] = _storable(var.values)
        meta["vars"][name] = {
            "dims": list(var.dims),
            "attrs": _jsonable(var.attrs),
            "name": var.name,
            "object": np.asarray(var.values).dtype == object,
            "coords": {
                cname: {
                    "dim": c.dim,
                    "attrs": _jsonable(c.attrs),
                    "object": np.asarray(c.values).dtype == object,
                }
                for cname, c in var.coords.items()
            },
        }
        for cname, c in var.coords.items():
            key = f"coord::{cname}"
            cvals = _storable(c.values)
            if key in arrays:
                # One array is stored per coordinate NAME: a second
                # variable whose same-named coord holds different values
                # would silently round-trip with the first variable's
                # values — refuse instead.
                prev = arrays[key]
                try:
                    same = prev.shape == cvals.shape and np.array_equal(
                        prev, cvals, equal_nan=True
                    )
                except TypeError:  # non-float dtypes reject equal_nan
                    same = prev.shape == cvals.shape and np.array_equal(
                        prev, cvals
                    )
                if not same:
                    raise ValueError(
                        f"Dataset variables disagree on coordinate "
                        f"'{cname}' values; rename one of the coordinates "
                        "before saving (save_dataset_npz stores one array "
                        "per coordinate name)."
                    )
            else:
                arrays[key] = cvals
    payload = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, __meta__=payload, **arrays)


def load_dataset_npz(path: str | Path):
    """Load an :class:`~xmris_tpu_torch.core.array.XmrDataset` saved with
    :func:`save_dataset_npz`."""
    from xmris_tpu_torch.core.array import XmrDataset

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        ds = XmrDataset(attrs=meta["attrs"])
        for name, vm in meta["vars"].items():
            var = XmrArray(
                _restore(z[f"var::{name}"], vm.get("object", False)),
                dims=tuple(vm["dims"]),
                attrs=vm["attrs"], name=vm["name"],
            )
            coords = {}
            for cname, cm in vm["coords"].items():
                cvals = _restore(z[f"coord::{cname}"], cm.get("object", False))
                coords[cname] = Coord(cm["dim"], cvals, cm["attrs"])
            var.coords = coords
            ds[name] = var
        return ds
