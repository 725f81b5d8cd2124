"""XmrArray and XmrDataset: the labeled complex-array carrier (PyTorch port).

Port of :mod:`xmris_tpu.core.array`.  ``data`` is a ``torch.Tensor`` (on any
device) or a host ``numpy`` array; ``dims`` / ``coords`` / ``attrs`` are
host-side Python metadata.  Every operation is functional: methods return
new objects and never mutate the original.

Differences from the reference carrier: ``.tensor`` takes the place of
``.jax``, :meth:`XmrArray.to` moves the payload to any device and
:meth:`XmrArray.device_put` to the card; ``.values`` is always a host numpy
copy.  The ``.xmr`` accessor and the xarray interop import lazily, as in
the reference.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def get_namespace(*arrays: Any):
    """``torch`` if any operand is a tensor, else ``np``: host pipelines stay
    on the host and device pipelines on the device."""
    for a in arrays:
        if _is_tensor(a):
            return torch
    return np


def _to_numpy(x: Any) -> np.ndarray:
    if _is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(x: Any, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``ref``'s device (scalars stay Python numbers)."""
    if _is_tensor(x) or np.isscalar(x):
        return x
    return torch.as_tensor(np.asarray(x), device=ref.device)


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


class Coord:
    """A coordinate: 1-D (or scalar) values attached to a named dimension."""

    __slots__ = ("dim", "values", "attrs")

    def __init__(self, dim: str, values: Any, attrs: dict | None = None):
        self.dim = str(dim)
        self.values = _to_numpy(values)
        self.attrs = dict(attrs) if attrs else {}

    def copy(self) -> "Coord":
        return Coord(self.dim, self.values.copy(), dict(self.attrs))

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Coord(dim={self.dim!r}, n={self.values.size}, attrs={self.attrs})"


def _coerce_coord(name: str, spec: Any, dims: Sequence[str]) -> Coord:
    """Accept the xarray-style coordinate spec forms."""
    if isinstance(spec, Coord):
        return spec
    if isinstance(spec, tuple):
        if len(spec) == 2:
            dim, values = spec
            return Coord(dim, values)
        if len(spec) == 3:
            dim, values, attrs = spec
            return Coord(dim, values, attrs)
        raise ValueError(f"Coordinate tuple for {name!r} must be (dim, values[, attrs]).")
    if name not in dims:
        raise ValueError(
            f"Coordinate {name!r} given as a bare array, but {name!r} is not a "
            f"dimension of the array (dims={tuple(dims)}). Pass (dim, values) instead."
        )
    return Coord(name, spec)


# Array primitives on either namespace.


def _transpose(data, order):
    return data.permute(tuple(order)) if _is_tensor(data) else np.transpose(data, order)


def _roll(data, shift: int, axis: int):
    if _is_tensor(data):
        return torch.roll(data, shift, dims=axis)
    return np.roll(data, shift, axis=axis)


def _pad(data, widths, mode: str, constant_values):
    if not _is_tensor(data):
        if mode == "constant":
            return np.pad(data, widths, mode=mode, constant_values=constant_values)
        return np.pad(data, widths, mode=mode)
    if mode != "constant":
        raise NotImplementedError(
            f"pad(mode={mode!r}) on a tensor payload; only 'constant' is ported"
        )
    flat = [w for pair in reversed(widths) for w in pair]
    return torch.nn.functional.pad(data, flat, value=constant_values)


_BINARY = {
    "add": (np.add, torch.add),
    "subtract": (np.subtract, torch.subtract),
    "multiply": (np.multiply, torch.multiply),
    "true_divide": (np.true_divide, torch.true_divide),
    "power": (np.power, torch.pow),
}


def _reduce_fn(op: str, data, axes):
    if not _is_tensor(data):
        return getattr(np, op)(data, axis=axes)
    dim = axes if axes is not None else tuple(range(data.ndim))
    if op == "max":
        return torch.amax(data, dim=dim)
    if op == "min":
        return torch.amin(data, dim=dim)
    if op == "std":
        return torch.std(data, dim=dim, correction=0)
    return getattr(torch, op)(data, dim=dim)


class XmrArray:
    """Labeled N-D array: tensor or numpy data + host dims/coords/attrs.

    Parameters
    ----------
    data : array-like
        The payload.  A ``torch.Tensor`` stays where it is; anything else
        becomes a host numpy array.
    dims : sequence of str
        One name per axis of ``data``.
    coords : mapping, optional
        ``{name: values}`` (name must be a dim), ``{name: (dim, values)}``,
        ``{name: (dim, values, attrs)}``, or ``{name: Coord}``.
    attrs : dict, optional
        Free-form metadata; every processing op copies and appends to it.
    name : str, optional
    """

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(
        self,
        data: Any,
        dims: Sequence[str] | str,
        coords: Mapping[str, Any] | None = None,
        attrs: dict | None = None,
        name: str | None = None,
    ):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims: tuple[str, ...] = tuple(str(d) for d in dims)
        if not _is_tensor(data):
            data = np.asarray(data)
        if data.ndim != len(self.dims):
            raise ValueError(
                f"Data has {data.ndim} axes but {len(self.dims)} dims were given: "
                f"{self.dims}."
            )
        self.data = data
        self.coords: dict[str, Coord] = {}
        if coords:
            for cname, spec in coords.items():
                coord = _coerce_coord(cname, spec, self.dims)
                self._validate_coord(cname, coord)
                self.coords[str(cname)] = coord
        self.attrs: dict = dict(attrs) if attrs else {}
        self.name = name

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def _validate_coord(self, name: str, coord: Coord) -> None:
        if coord.dim not in self.dims:
            raise ValueError(
                f"Coordinate {name!r} is defined on dimension {coord.dim!r}, "
                f"which is not in dims {self.dims}."
            )
        n = self.sizes[coord.dim]
        if coord.values.ndim == 0:
            return
        if coord.values.shape != (n,):
            raise ValueError(
                f"Coordinate {name!r} has {coord.values.shape} values but dimension "
                f"{coord.dim!r} has length {n}."
            )

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.shape))

    @property
    def values(self) -> np.ndarray:
        """Host numpy copy of the data (device->host transfer if needed)."""
        return _to_numpy(self.data)

    @property
    def tensor(self) -> torch.Tensor:
        """The data as a tensor (a host numpy payload becomes a CPU tensor)."""
        if _is_tensor(self.data):
            return self.data
        return torch.as_tensor(self.data)

    def get_axis_num(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"Dimension {dim!r} not found in dims {self.dims}.")

    def coord_values(self, name: str) -> np.ndarray:
        return self.coords[name].values

    def coord_array(self, name: str) -> "XmrArray":
        """Lift a coordinate into a 1-D :class:`XmrArray` (for dim-aligned math)."""
        c = self.coords[name]
        return XmrArray(c.values, (c.dim,), attrs=dict(c.attrs), name=name)

    # ------------------------------------------------------------------
    # Functional reconstruction helpers
    # ------------------------------------------------------------------
    def copy(self, data: Any | None = None, deep: bool = False) -> "XmrArray":
        """A new XmrArray, optionally with another payload of the same shape
        (``xr.DataArray.copy(data=...)``); dims, coords, attrs and name are
        kept."""
        new_data = self.data if data is None else data
        if data is not None and not _is_tensor(new_data):
            new_data = np.asarray(new_data)
        if deep:
            new_data = new_data.clone() if _is_tensor(new_data) else new_data.copy()
        if tuple(new_data.shape) != self.shape:
            raise ValueError(
                f"copy(data=...) must preserve shape {self.shape}, got "
                f"{tuple(new_data.shape)}. Use XmrArray(...) for reshaping ops."
            )
        return self._rebuild(new_data)

    def _rebuild(
        self,
        data: Any,
        dims: tuple[str, ...] | None = None,
        coords: dict[str, Coord] | None = None,
        attrs: dict | None = None,
    ) -> "XmrArray":
        out = XmrArray.__new__(XmrArray)
        out.data = data
        out.dims = self.dims if dims is None else dims
        out.coords = (
            {k: v.copy() for k, v in self.coords.items()} if coords is None else coords
        )
        out.attrs = dict(self.attrs) if attrs is None else attrs
        out.name = self.name
        return out

    # ------------------------------------------------------------------
    # Metadata ops
    # ------------------------------------------------------------------
    def assign_attrs(self, *args, **kwargs) -> "XmrArray":
        new_attrs = dict(self.attrs)
        for a in args:
            new_attrs.update(a)
        new_attrs.update(kwargs)
        return self._rebuild(self.data, attrs=new_attrs)

    def assign_coords(self, coords: Mapping[str, Any]) -> "XmrArray":
        new_coords = {k: v.copy() for k, v in self.coords.items()}
        for cname, spec in coords.items():
            coord = _coerce_coord(cname, spec, self.dims)
            self._validate_coord(cname, coord)
            new_coords[str(cname)] = coord
        return self._rebuild(self.data, coords=new_coords)

    def drop_coords(self, names: str | Iterable[str]) -> "XmrArray":
        if isinstance(names, str):
            names = [names]
        drop = set(names)
        new_coords = {k: v.copy() for k, v in self.coords.items() if k not in drop}
        return self._rebuild(self.data, coords=new_coords)

    def rename(self, mapping: Mapping[str, str]) -> "XmrArray":
        """Rename dimensions and/or coordinates."""
        new_dims = tuple(mapping.get(d, d) for d in self.dims)
        new_coords: dict[str, Coord] = {}
        for cname, c in self.coords.items():
            new_coords[mapping.get(cname, cname)] = Coord(
                mapping.get(c.dim, c.dim), c.values, c.attrs
            )
        return self._rebuild(self.data, dims=new_dims, coords=new_coords)

    def swap_dims(self, mapping: Mapping[str, str]) -> "XmrArray":
        """Promote an existing coordinate to be the dimension (xarray semantics)."""
        new_dims = list(self.dims)
        new_coords = {k: v.copy() for k, v in self.coords.items()}
        for old, new in mapping.items():
            if old not in self.dims:
                raise KeyError(f"Dimension {old!r} not found in {self.dims}.")
            if new not in self.coords and new != old:
                raise KeyError(
                    f"swap_dims target {new!r} must be an existing coordinate."
                )
            new_dims[new_dims.index(old)] = new
            for c in new_coords.values():
                if c.dim == old:
                    c.dim = new
        return self._rebuild(self.data, dims=tuple(new_dims), coords=new_coords)

    # ------------------------------------------------------------------
    # Shape / indexing ops
    # ------------------------------------------------------------------
    def transpose(self, *dims: str) -> "XmrArray":
        if not dims:
            dims = tuple(reversed(self.dims))
        if set(dims) != set(self.dims) or len(dims) != len(self.dims):
            raise ValueError(f"transpose dims {dims} must be a permutation of {self.dims}.")
        order = tuple(self.get_axis_num(d) for d in dims)
        return self._rebuild(_transpose(self.data, order), dims=tuple(dims))

    def isel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "XmrArray":
        """Integer/slice-based selection by dimension name.

        Integer indexers drop the dimension (and its coordinates); slices keep
        it and slice the coordinates accordingly.
        """
        indexers = dict(indexers or {})
        indexers.update(kw)
        dropped: set[str] = set()
        data = self.data
        # One axis at a time: several array indexers select outer products.
        for dim, idx in indexers.items():
            ax = self.get_axis_num(dim) - sum(
                1 for d in dropped if self.get_axis_num(d) < self.get_axis_num(dim)
            )
            sel: list[Any] = [slice(None)] * data.ndim
            sel[ax] = idx
            data = data[tuple(sel)]
            if isinstance(idx, (int, np.integer)):
                dropped.add(dim)
        new_dims = tuple(d for d in self.dims if d not in dropped)
        new_coords: dict[str, Coord] = {}
        for cname, c in self.coords.items():
            if c.dim in dropped:
                continue
            if c.dim in indexers:
                new_coords[cname] = Coord(c.dim, c.values[indexers[c.dim]], c.attrs)
            else:
                new_coords[cname] = c.copy()
        return self._rebuild(data, dims=new_dims, coords=new_coords)

    def sel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "XmrArray":
        """Label-based selection on dimension coordinates (exact match)."""
        indexers = dict(indexers or {})
        indexers.update(kw)
        iidx: dict[str, Any] = {}
        for dim, label in indexers.items():
            if dim not in self.coords:
                raise KeyError(f"No coordinate found for dimension {dim!r}.")
            matches = np.nonzero(self.coords[dim].values == label)[0]
            if matches.size == 0:
                raise KeyError(f"Label {label!r} not found in coordinate {dim!r}.")
            iidx[dim] = int(matches[0])
        return self.isel(iidx)

    def roll(self, shifts: Mapping[str, int], roll_coords: bool = True) -> "XmrArray":
        data = self.data
        for dim, shift in shifts.items():
            data = _roll(data, shift, self.get_axis_num(dim))
        new_coords = {}
        for cname, c in self.coords.items():
            if roll_coords and c.dim in shifts:
                new_coords[cname] = Coord(
                    c.dim, np.roll(c.values, shifts[c.dim]), c.attrs
                )
            else:
                new_coords[cname] = c.copy()
        return self._rebuild(data, coords=new_coords)

    def pad(
        self,
        pad_width: Mapping[str, tuple[int, int]],
        mode: str = "constant",
        constant_values: Any = 0,
    ) -> "XmrArray":
        """Pad along named dimensions; coordinates on padded dims are dropped
        (callers re-derive them)."""
        widths = [(0, 0)] * self.ndim
        for dim, w in pad_width.items():
            widths[self.get_axis_num(dim)] = tuple(w)
        data = _pad(self.data, widths, mode, constant_values)
        new_coords = {
            k: v.copy()
            for k, v in self.coords.items()
            if v.dim not in pad_width or pad_width[v.dim] == (0, 0)
        }
        return self._rebuild(data, coords=new_coords)

    def expand_dims(self, dim: str, axis: int = 0) -> "XmrArray":
        if _is_tensor(self.data):
            data = self.data.unsqueeze(axis)
        else:
            data = np.expand_dims(self.data, axis=axis)
        new_dims = list(self.dims)
        new_dims.insert(axis if axis >= 0 else len(new_dims) + axis + 1, dim)
        return self._rebuild(data, dims=tuple(new_dims))

    def squeeze(self, dim: str | None = None) -> "XmrArray":
        if dim is not None:
            dims_to_drop = [dim]
        else:
            dims_to_drop = [d for d, s in self.sizes.items() if s == 1]
        out = self
        for d in dims_to_drop:
            if out.sizes[d] != 1:
                raise ValueError(f"Cannot squeeze dimension {d!r} of size {out.sizes[d]}.")
            out = out.isel({d: 0})
        return out

    # ------------------------------------------------------------------
    # Math
    # ------------------------------------------------------------------
    @property
    def real(self) -> "XmrArray":
        return self._rebuild(self.data.real)

    @property
    def imag(self) -> "XmrArray":
        return self._rebuild(self.data.imag)

    def conj(self) -> "XmrArray":
        if _is_tensor(self.data):
            return self._rebuild(self.data.conj().resolve_conj())
        return self._rebuild(self.data.conj())

    def astype(self, dtype) -> "XmrArray":
        if _is_tensor(self.data):
            return self._rebuild(self.data.to(torch_dtype(dtype)))
        return self._rebuild(self.data.astype(dtype))

    def item(self):
        return self.values.item()

    def __abs__(self) -> "XmrArray":
        return self._rebuild(abs(self.data))

    def __neg__(self) -> "XmrArray":
        return self._rebuild(-self.data)

    def _align_other(self, other: Any):
        """Broadcast-align ``other`` against self by dimension names.

        Returns (self_data, other_data, result_dims, result_coords); the
        result dims are self's followed by any extra dims of other.
        """
        if isinstance(other, XmrArray):
            extra = [d for d in other.dims if d not in self.dims]
            result_dims = self.dims + tuple(extra)
            pos = {d: i for i, d in enumerate(result_dims)}
            other_order = sorted(other.dims, key=lambda d: pos[d])
            o = other.transpose(*other_order).data
            o_shape = [other.sizes[d] if d in other.dims else 1 for d in result_dims]
            o = o.reshape(tuple(o_shape))
            s = self.data
            if extra:
                s = s.reshape(self.shape + (1,) * len(extra))
            # merged coords: self's coords win on collision
            merged: dict[str, Coord] = {
                k: v.copy() for k, v in other.coords.items() if v.dim in result_dims
            }
            merged.update({k: v.copy() for k, v in self.coords.items()})
            return s, o, result_dims, merged
        return self.data, other, self.dims, {k: v.copy() for k, v in self.coords.items()}

    def _binary_op(self, other: Any, op: str, reflexive: bool = False) -> "XmrArray":
        s, o, dims, coords = self._align_other(other)
        np_fn, torch_fn = _BINARY[op]
        if _is_tensor(s) or _is_tensor(o):
            ref = s if _is_tensor(s) else o
            s, o = _like(s, ref), _like(o, ref)
            fn = torch_fn
        else:
            fn = np_fn
        data = fn(o, s) if reflexive else fn(s, o)
        out = XmrArray.__new__(XmrArray)
        out.data = data
        out.dims = dims
        out.coords = coords
        out.attrs = {}  # xarray default: binary ops drop attrs
        out.name = None
        return out

    def __add__(self, other):
        return self._binary_op(other, "add")

    def __radd__(self, other):
        return self._binary_op(other, "add", reflexive=True)

    def __sub__(self, other):
        return self._binary_op(other, "subtract")

    def __rsub__(self, other):
        return self._binary_op(other, "subtract", reflexive=True)

    def __mul__(self, other):
        return self._binary_op(other, "multiply")

    def __rmul__(self, other):
        return self._binary_op(other, "multiply", reflexive=True)

    def __truediv__(self, other):
        return self._binary_op(other, "true_divide")

    def __rtruediv__(self, other):
        return self._binary_op(other, "true_divide", reflexive=True)

    def __pow__(self, other):
        return self._binary_op(other, "power")

    def _reduce(self, op: str, dim: str | list[str] | None = None) -> "XmrArray":
        if dim is None:
            out = XmrArray.__new__(XmrArray)
            out.data = _reduce_fn(op, self.data, None)
            out.dims = ()
            out.coords = {}
            out.attrs = {}
            out.name = self.name
            return out
        dims = [dim] if isinstance(dim, str) else list(dim)
        axes = tuple(self.get_axis_num(d) for d in dims)
        data = _reduce_fn(op, self.data, axes)
        new_dims = tuple(d for d in self.dims if d not in dims)
        new_coords = {k: v.copy() for k, v in self.coords.items() if v.dim not in dims}
        return self._rebuild(data, dims=new_dims, coords=new_coords)

    def max(self, dim=None):
        return self._reduce("max", dim)

    def min(self, dim=None):
        return self._reduce("min", dim)

    def mean(self, dim=None):
        return self._reduce("mean", dim)

    def sum(self, dim=None):
        return self._reduce("sum", dim)

    def std(self, dim=None):
        return self._reduce("std", dim)

    # ------------------------------------------------------------------
    # Interop & ergonomics
    # ------------------------------------------------------------------
    def pipe(self, func, *args, **kwargs):
        return func(self, *args, **kwargs)

    def __array__(self, dtype=None, copy=None):
        v = self.values
        return v.astype(dtype) if dtype is not None else v

    def to(self, device) -> "XmrArray":
        """The same array with its payload as a tensor on ``device``."""
        if _is_tensor(self.data):
            return self._rebuild(self.data.to(device))
        return self._rebuild(torch.as_tensor(self.data, device=device))

    @property
    def xmr(self):
        """The fluent accessor namespace (``da.xmr`` in the reference)."""
        from xmris_tpu_torch.core.accessor import XmrisAccessor

        return XmrisAccessor(self)

    def to_xarray(self):
        """Convert to an ``xarray.DataArray`` (requires xarray installed)."""
        from xmris_tpu_torch.interop.xarray import to_xarray

        return to_xarray(self)

    @classmethod
    def from_xarray(cls, da) -> "XmrArray":
        from xmris_tpu_torch.interop.xarray import from_xarray

        return from_xarray(da)

    def block_until_ready(self) -> "XmrArray":
        """Wait for the work queued on the payload's CUDA device."""
        if _is_tensor(self.data) and self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)
        return self

    def device_put(self, sharding=None) -> "XmrArray":
        """Move the payload to the card (a tensor on the current CUDA
        device); raises where there is none.

        A tensor lies on one device, so with a ``sharding``
        (:func:`~xmris_tpu_torch.parallel.mesh.voxel_sharding` or
        :func:`~xmris_tpu_torch.parallel.mesh.replicated`) the payload goes
        to its mesh's first device: the sharded entry points (``mesh=``)
        split their inputs per shard from there and gather their results
        there.  Any other ``sharding`` raises ``TypeError``."""
        if sharding is None:
            return self.to("cuda")
        from xmris_tpu_torch.parallel.mesh import Sharding

        if not isinstance(sharding, Sharding):
            raise TypeError(
                f"device_put: expected a Sharding (voxel_sharding or "
                f"replicated of a Mesh), got {type(sharding).__name__}")
        return self.to(sharding.mesh.devices.flat[0])

    def _repr_html_(self) -> str:
        """Rich notebook rendering: dims, backend, coords, and attrs tables."""
        dims_s = ", ".join(f"<b>{d}</b>: {s}" for d, s in self.sizes.items())
        kind = "torch" if _is_tensor(self.data) else "numpy"
        coord_rows = "".join(
            f"<tr><td style='padding:2px 8px'><code>{k}</code></td>"
            f"<td style='padding:2px 8px'>({c.dim})</td>"
            f"<td style='padding:2px 8px'>{c.values.dtype}</td>"
            f"<td style='padding:2px 8px'><code>{_summ(c.values)}</code></td>"
            f"<td style='padding:2px 8px'>{c.attrs.get('units', '')}</td></tr>"
            for k, c in self.coords.items()
        )
        attr_rows = "".join(
            f"<tr><td style='padding:2px 8px'><code>{k}</code></td>"
            f"<td style='padding:2px 8px'><code>{str(v)[:80]}</code></td></tr>"
            for k, v in list(self.attrs.items())[:16]
        )
        return (
            "<div style='font-family:monospace;font-size:12px;'>"
            f"<div><b>xmris_tpu_torch.XmrArray</b> {self.name or ''} ({dims_s}) "
            f"&mdash; {kind}, {self.dtype}</div>"
            f"<details open><summary>Coordinates ({len(self.coords)})</summary>"
            f"<table>{coord_rows}</table></details>"
            f"<details><summary>Attributes ({len(self.attrs)})</summary>"
            f"<table>{attr_rows}</table></details></div>"
        )

    def __repr__(self) -> str:
        dims_s = ", ".join(f"{d}: {s}" for d, s in self.sizes.items())
        coord_s = "\n".join(
            f"  * {k:<18} ({c.dim}) {c.values.dtype} {_summ(c.values)}"
            for k, c in self.coords.items()
        )
        attr_s = "\n".join(f"    {k}: {v!r}" for k, v in list(self.attrs.items())[:12])
        more = "" if len(self.attrs) <= 12 else f"\n    ... ({len(self.attrs)} attrs total)"
        kind = (f"torch ({self.data.device})" if _is_tensor(self.data) else "numpy")
        return (
            f"<xmris_tpu_torch.XmrArray {self.name or ''} ({dims_s})>\n"
            f"  backend: {kind}, dtype: {self.dtype}\n"
            f"Coordinates:\n{coord_s or '  (none)'}\n"
            f"Attributes:\n{attr_s or '    (none)'}{more}"
        )


def _summ(v: np.ndarray) -> str:
    if v.size == 0:
        return "[]"
    if v.size <= 4:
        return np.array2string(v, precision=4, separator=", ")
    return (
        f"[{v.flat[0]:.4g} {v.flat[1]:.4g} ... {v.flat[-1]:.4g}]"
        if np.issubdtype(v.dtype, np.number)
        else f"[{v.flat[0]!r} ... {v.flat[-1]!r}]"
    )


class XmrDataset:
    """A dict of aligned :class:`XmrArray` variables (fitting results etc.):
    named data variables and shared attrs, as the reference's dataset."""

    __slots__ = ("data_vars", "attrs")

    def __init__(
        self,
        data_vars: Mapping[str, XmrArray] | None = None,
        attrs: dict | None = None,
    ):
        self.data_vars: dict[str, XmrArray] = dict(data_vars) if data_vars else {}
        self.attrs: dict = dict(attrs) if attrs else {}

    def __getitem__(self, key: str) -> XmrArray:
        return self.data_vars[key]

    def __setitem__(self, key: str, value: XmrArray) -> None:
        self.data_vars[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.data_vars

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def items(self):
        return self.data_vars.items()

    @property
    def dims(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for v in self.data_vars.values():
            out.update(v.sizes)
        return out

    @property
    def coords(self) -> dict[str, Coord]:
        out: dict[str, Coord] = {}
        for v in self.data_vars.values():
            for k, c in v.coords.items():
                out.setdefault(k, c)
        return out

    def assign_attrs(self, *args, **kwargs) -> "XmrDataset":
        new_attrs = dict(self.attrs)
        for a in args:
            new_attrs.update(a)
        new_attrs.update(kwargs)
        return XmrDataset(self.data_vars, new_attrs)

    def isel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "XmrDataset":
        """Integer/slice selection applied to every variable carrying the dim."""
        indexers = dict(indexers or {})
        indexers.update(kw)
        out = {}
        for name, var in self.data_vars.items():
            applicable = {d: i for d, i in indexers.items() if d in var.dims}
            out[name] = var.isel(applicable) if applicable else var
        return XmrDataset(out, dict(self.attrs))

    def sel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "XmrDataset":
        """Label selection applied to every variable carrying the dim."""
        indexers = dict(indexers or {})
        indexers.update(kw)
        out = {}
        for name, var in self.data_vars.items():
            applicable = {d: v for d, v in indexers.items() if d in var.dims}
            out[name] = var.sel(applicable) if applicable else var
        return XmrDataset(out, dict(self.attrs))

    @property
    def xmr(self):
        from xmris_tpu_torch.core.accessor import XmrisDatasetAccessor

        return XmrisDatasetAccessor(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        vars_s = "\n".join(
            f"    {k:<12} ({', '.join(v.dims)}) {v.dtype}" for k, v in self.data_vars.items()
        )
        return (
            f"<xmris_tpu_torch.XmrDataset ({len(self.data_vars)} variables)>\n"
            f"Data variables:\n{vars_s}\n"
            f"Attributes: {list(self.attrs)[:8]}"
        )
