"""The port's file formats and xarray interop against the JAX package's.

* ``.npz`` files written by either package load in the other, losslessly
  (payload, dims, coords with their attrs and object dtype, attrs, name;
  datasets too), and a tensor payload saves through its host copy;
* ``load_dataarray`` reads the synthetic Bruker export exactly as the
  reference reads it;
* xarray is installed neither here nor on the card machine: registration
  is a no-op that returns False and the conversions raise ImportError; the
  adapters run against a stub of the consumed xarray surface (this file's
  own copy of ``tests/test_interop_xarray.py``'s pattern).
"""

import importlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.core.array import XmrDataset as JDataset
from xmris_tpu.interop import io as jio

import xmris_tpu_torch as xt
from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset
from xmris_tpu_torch.interop import io as tio

NC = Path(__file__).parent / "data" / "synth_nspect_1H" / "rawdatajob0.nc"


def _same(got, ref):
    assert type(got.values) is np.ndarray
    assert got.dims == ref.dims and got.name == ref.name and got.attrs == ref.attrs
    assert got.values.dtype == np.asarray(ref.values).dtype
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    assert sorted(got.coords) == sorted(ref.coords)
    for k, c in ref.coords.items():
        g = got.coords[k]
        assert g.dim == c.dim and g.attrs == c.attrs
        assert g.values.dtype == c.values.dtype
        np.testing.assert_array_equal(g.values, c.values)


def _pair(pkg_arr, pkg_coord):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))).astype(
        np.complex64)
    return pkg_arr(
        data, dims=("Metabolite", "time"),
        coords={"time": pkg_coord("time", np.arange(16) / 4e3, {"units": "s"}),
                "Metabolite": pkg_coord("Metabolite",
                                        np.array(["PCr", "ATP", "Pi"], dtype=object))},
        attrs={"MHz": 120.0, "lineage": [1, 2], "flag": True}, name="fid")


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_npz_cross_loads_losslessly(tmp_path, direction):
    ref_da, port_da = _pair(xmt.XmrArray, JCoord), _pair(XmrArray, Coord)
    path = tmp_path / "a.npz"
    if direction == "port_to_ref":
        tio.save_npz(port_da, path)
        _same(jio.load_npz(path), ref_da)
    else:
        jio.save_npz(ref_da, path)
        _same(tio.load_npz(path), port_da)
    # A tensor payload saves through its host copy.
    tio.save_npz(port_da.to("cpu"), tmp_path / "t.npz")
    _same(jio.load_npz(tmp_path / "t.npz"), ref_da)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_dataset_npz_cross_loads_losslessly(tmp_path, direction):
    ref_da, port_da = _pair(xmt.XmrArray, JCoord), _pair(XmrArray, Coord)
    ref_ds = JDataset({"fid": ref_da, "amp": ref_da.isel({"time": 0})},
                      attrs={"fit_method": "leastsq"})
    port_ds = XmrDataset({"fid": port_da, "amp": port_da.isel({"time": 0})},
                         attrs={"fit_method": "leastsq"})
    path = tmp_path / "ds.npz"
    if direction == "port_to_ref":
        tio.save_dataset_npz(port_ds, path)
        got, want = jio.load_dataset_npz(path), port_ds
    else:
        jio.save_dataset_npz(ref_ds, path)
        got, want = tio.load_dataset_npz(path), ref_ds
    assert got.attrs == want.attrs and list(got.keys()) == list(want.keys())
    for k in want.keys():
        _same(got[k], want[k])


def test_npz_refusals_match_reference(tmp_path):
    bad = XmrArray(np.array([1, "a"], dtype=object), dims=("x",))
    with pytest.raises(TypeError, match="pickling"):
        tio.save_npz(bad, tmp_path / "b.npz")
    a = XmrArray(np.zeros(2), dims=("x",), coords={"x": np.array([0.0, 1.0])})
    b = XmrArray(np.zeros(2), dims=("x",), coords={"x": np.array([0.0, 2.0])})
    with pytest.raises(ValueError, match="disagree"):
        tio.save_dataset_npz(XmrDataset({"a": a, "b": b}), tmp_path / "c.npz")
    h5 = tmp_path / "x.nc"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n")
    with pytest.raises(ValueError, match="netCDF-3"):
        tio.load_dataarray(h5)


def test_load_dataarray_matches_reference():
    ref, got = jio.load_dataarray(NC), tio.load_dataarray(NC)
    assert got.dims == ("raw", "component")
    _same(got, ref)
    with pytest.raises(KeyError, match="nope"):
        tio.load_dataarray(NC, variable="nope")


def test_xarray_absent_is_a_no_op():
    from xmris_tpu_torch.interop import xarray as txr

    assert txr.HAS_XARRAY is False
    assert xt.register_xarray_accessors() is False
    da = XmrArray(np.ones(3), dims=("x",))
    for call in (lambda: txr.to_xarray(da), lambda: txr.from_xarray(object()),
                 lambda: txr.to_xarray_dataset(XmrDataset()),
                 lambda: txr.from_xarray_dataset(object())):
        with pytest.raises(ImportError, match="xarray is not installed"):
            call()


# ---------------------------------------------------------------------------
# A stub of the xarray surface the adapters consume.
# ---------------------------------------------------------------------------


class _StubCoord:
    def __init__(self, dims, values, attrs=None):
        self.dims = dims if isinstance(dims, tuple) else (dims,)
        self.values = np.asarray(values)
        self.attrs = dict(attrs or {})

    @property
    def ndim(self):
        return self.values.ndim


class _StubDataArray:
    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        self.values = np.asarray(data)
        self.dims = tuple(dims or ())
        self.coords = {}
        for k, spec in (coords or {}).items():
            if isinstance(spec, tuple):
                self.coords[k] = _StubCoord(spec[0], spec[1],
                                            spec[2] if len(spec) > 2 else {})
            else:
                self.coords[k] = _StubCoord(k, spec)
        self.attrs = dict(attrs or {})
        self.name = name


class _StubDataset:
    def __init__(self, data_vars=None, attrs=None):
        self.data_vars = dict(data_vars or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, key):
        return self.data_vars[key]

    def __contains__(self, key):
        return key in self.data_vars


def _make_stub():
    stub = types.ModuleType("xarray")
    stub.DataArray = _StubDataArray
    stub.Dataset = _StubDataset
    stub._accessors = {}

    def _register(target_cls):
        def factory(name):
            def deco(cls):
                stub._accessors[(target_cls.__name__, name)] = cls
                setattr(target_cls, name, property(lambda self: cls(self)))
                return cls

            return deco

        return factory

    stub.register_dataarray_accessor = _register(_StubDataArray)
    stub.register_dataset_accessor = _register(_StubDataset)
    return stub


@pytest.fixture
def xr_stub(monkeypatch):
    stub = _make_stub()
    monkeypatch.setitem(sys.modules, "xarray", stub)
    import xmris_tpu_torch.interop.xarray as txr

    importlib.reload(txr)
    yield txr, stub
    monkeypatch.delitem(sys.modules, "xarray")
    importlib.reload(txr)
    for cls in (_StubDataArray, _StubDataset):
        if "xmr" in vars(cls):
            delattr(cls, "xmr")


def test_conversions_through_the_stub(xr_stub):
    txr, stub = xr_stub
    da = stub.DataArray(np.arange(8.0) + 1j, dims=("time",),
                        coords={"time": ("time", np.arange(8.0) / 1e3,
                                         {"units": "s"})},
                        attrs={"MHz": 100.0}, name="fid")
    native = txr.from_xarray(da)
    assert isinstance(native, XmrArray) and native.dims == ("time",)
    assert native.attrs == {"MHz": 100.0} and native.name == "fid"
    assert native.coords["time"].attrs["units"] == "s"
    back = native.to("cpu").to_xarray()
    assert isinstance(back, stub.DataArray) and back.dims == ("time",)
    np.testing.assert_array_equal(back.values, da.values)
    assert XmrArray.from_xarray(da).attrs == native.attrs
    ds = XmrDataset({"amplitude": XmrArray(
        np.ones((2, 3)), dims=("voxel", "Metabolite"),
        coords={"Metabolite": np.array(["a", "b", "c"], dtype=object)})},
        attrs={"fit_method": "leastsq"})
    xds = txr.to_xarray_dataset(ds)
    assert isinstance(xds, stub.Dataset) and xds.attrs == ds.attrs
    again = txr.from_xarray_dataset(xds)
    np.testing.assert_array_equal(again["amplitude"].values,
                                  ds["amplitude"].values)


def test_accessor_adapter_runs_the_port_through_the_stub(xr_stub):
    """The Quick Start on a (stub) DataArray: every link re-enters through
    ``.xmr`` and comes back as a DataArray, the peak at its ppm."""
    txr, stub = xr_stub
    assert txr.register_xarray_accessors() is True
    assert ("_StubDataArray", "xmr") in stub._accessors
    assert ("_StubDataset", "xmr") in stub._accessors
    n, sw, mhz = 256, 4000.0, 100.0
    t = np.arange(n) / sw
    da = stub.DataArray(5.0 * np.exp((1j * 2 * np.pi * 500.0 - 30.0) * t),
                        dims=("time",), coords={"time": ("time", t, {"units": "s"})},
                        attrs={"MHz": mhz, "reference_frequency": mhz,
                               "carrier_ppm": 4.7})
    out = (da.xmr.zero_fill(target_points=512).xmr.apodize_exp(lb=5.0)
             .xmr.to_spectrum().xmr.autophase(device="cpu"))
    assert isinstance(out, stub.DataArray) and "phase_p0" in out.attrs
    ppm = out.xmr.to_ppm()
    assert ppm.dims == ("chemical_shift",)
    peak = float(ppm.coords["chemical_shift"].values[np.argmax(np.abs(ppm.values))])
    assert peak == pytest.approx(4.7 + 500.0 / 100.0, abs=0.1)
    assert out.xmr.to_spectrum.__doc__ is not None
    with pytest.raises(NotImplementedError, match="item 13"):
        da.xmr.plot.waterfall()
    fit_ds = stub.Dataset({"a": da})
    with pytest.raises(NotImplementedError, match="item 13"):
        fit_ds.xmr.plot.qc_grid("x")
    # Registration is idempotent.
    assert txr.register_xarray_accessors() is True
