"""The port's labeled layer against the JAX package's: the XmrArray /
XmrDataset carrier, the vocabulary and validation helpers, the Fourier
engine, the FID ops and ``phase``.

The same numpy arrays go through both packages; the port runs each op on a
numpy payload (the host path) and on a CPU tensor payload (the device
path).  Values are held to 1e-12 in float64 and dims, coords, attrs and
names exactly.
"""

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu.core import config as jconfig
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.core.array import XmrDataset as JDataset
from xmris_tpu.core.utils import _check_dims as j_check_dims
from xmris_tpu.core.utils import as_coord as j_as_coord
from xmris_tpu.ops import fid as jfid
from xmris_tpu.ops import fourier as jfourier
from xmris_tpu.ops import phasing as jph
from xmris_tpu.runtime.config import matching_dtypes as j_matching

from xmris_tpu_torch.core import config as tconfig
from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset, get_namespace
from xmris_tpu_torch.core.utils import _check_dims, as_coord
from xmris_tpu_torch.core.validation import requires_attrs
from xmris_tpu_torch.ops import fid as tfid
from xmris_tpu_torch.ops import fourier as tfourier
from xmris_tpu_torch.ops import phasing as tph
from xmris_tpu_torch.runtime.config import matching_dtypes

PAYLOADS = ["numpy", "tensor"]


def _pair(data, dims, coords=None, attrs=None, name=None):
    """The same labeled array in both packages (numpy payloads)."""
    jc = {k: JCoord(*v) for k, v in (coords or {}).items()}
    tc = {k: Coord(*v) for k, v in (coords or {}).items()}
    return (xmt.XmrArray(data, dims=dims, coords=jc, attrs=attrs, name=name),
            XmrArray(data, dims=dims, coords=tc, attrs=attrs, name=name))


def _as(payload, da):
    return da.to("cpu") if payload == "tensor" else da


def _assert_same(got, ref, rtol=1e-12, atol=1e-12):
    assert got.dims == ref.dims
    assert got.shape == ref.shape
    assert got.name == ref.name
    np.testing.assert_allclose(got.values, np.asarray(ref.values), rtol=rtol,
                               atol=atol)
    assert sorted(got.coords) == sorted(ref.coords)
    for k, c in ref.coords.items():
        assert got.coords[k].dim == c.dim
        assert got.coords[k].attrs == c.attrs
        np.testing.assert_allclose(got.coords[k].values, c.values, rtol=1e-12)
    assert sorted(got.attrs) == sorted(ref.attrs)
    for k, v in ref.attrs.items():
        np.testing.assert_array_equal(np.asarray(got.attrs[k]), np.asarray(v))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 4, 16)) + 1j * rng.normal(size=(3, 4, 16))
    coords = {
        "x": ("x", np.arange(3) * 2.0),
        "time": ("time", np.arange(16) / 400.0, {"units": "s"}),
    }
    return _pair(data, ("x", "y", "time"), coords, attrs={"MHz": 120.0},
                 name="fid")


# ---------------------------------------------------------------------------
# The carrier
# ---------------------------------------------------------------------------

OPS = {
    "transpose": lambda a: a.transpose("time", "x", "y"),
    "transpose_rev": lambda a: a.transpose(),
    "isel_int": lambda a: a.isel(x=1),
    "isel_slice": lambda a: a.isel({"time": slice(2, 9), "y": slice(1, 3)}),
    "isel_array": lambda a: a.isel(x=np.array([0, 2]), y=np.array([1, 3])),
    "sel": lambda a: a.sel(x=4.0),
    "roll": lambda a: a.roll({"time": 5}),
    "roll_data_only": lambda a: a.roll({"time": -3}, roll_coords=False),
    "pad": lambda a: a.pad({"time": (2, 3)}),
    "rename": lambda a: a.rename({"time": "t", "x": "xx"}),
    "assign": lambda a: a.assign_attrs({"k": 1}, j=2).assign_coords(
        {"y": np.arange(4) + 0.5}),
    "drop_coords": lambda a: a.drop_coords("x"),
    "expand_squeeze": lambda a: a.expand_dims("avg", axis=1).squeeze("avg"),
    "copy": lambda a: a.copy(deep=True),
    "abs": lambda a: abs(a),
    "neg_conj": lambda a: (-a).conj(),
    "real_imag": lambda a: a.real + a.imag,
    "scalar_ops": lambda a: ((a * 2.0 + 1.0) / 3.0 - 0.5) ** 2,
    "reflexive": lambda a: 1.0 - 2.0 / (a + 3.0),
    "max": lambda a: abs(a).max("time"),
    "min_mean": lambda a: abs(a).min(["x", "y"]) + abs(a).mean("time").sum(),
    "sum_std": lambda a: a.real.sum("y") * a.real.std("x").mean(),
    "reduce_all": lambda a: abs(a).max(),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("op", sorted(OPS))
def test_carrier_ops_match_reference(arrays, op, payload):
    ref, port = arrays
    got = OPS[op](_as(payload, port))
    want = OPS[op](ref)
    _assert_same(got, want)
    assert isinstance(got.data, torch.Tensor) == (payload == "tensor")


@pytest.mark.parametrize("payload", PAYLOADS)
def test_broadcast_binary_ops_match_reference(arrays, payload):
    ref, port = arrays
    w = np.linspace(0.5, 2.0, 16)
    v = np.arange(3.0) + 1
    jw, tw = _pair(w, ("time",))
    jv, tv = _pair(np.stack([v] * 5, 1), ("x", "extra"))
    p = _as(payload, port)
    _assert_same(p * tw, ref * jw)
    _assert_same(tw * p, jw * ref)
    _assert_same(p / tv, ref / jv)


def test_carrier_is_functional_and_validates(arrays):
    _, port = arrays
    before = port.values.copy()
    out = port.assign_attrs(new=1).rename({"time": "t"}).roll({"t": 3})
    assert "new" not in port.attrs and port.dims == ("x", "y", "time")
    np.testing.assert_array_equal(port.values, before)
    assert out.dims == ("x", "y", "t")
    with pytest.raises(ValueError, match="axes"):
        XmrArray(np.zeros((2, 3)), dims=("a",))
    with pytest.raises(ValueError, match="length"):
        XmrArray(np.zeros((2, 3)), dims=("a", "b"), coords={"a": np.arange(3)})
    with pytest.raises(ValueError, match="bare array"):
        XmrArray(np.zeros((2,)), dims=("a",), coords={"c": np.arange(2)})
    with pytest.raises(ValueError, match="preserve shape"):
        port.copy(data=np.zeros((2, 2)))
    with pytest.raises(KeyError):
        port.sel(x=99.0)


def test_values_tensor_and_namespace(arrays):
    _, port = arrays
    tens = port.to("cpu")
    assert isinstance(tens.data, torch.Tensor)
    assert isinstance(tens.values, np.ndarray) and get_namespace(tens.data) is torch
    assert get_namespace(port.data) is np
    assert torch.equal(port.tensor, tens.data)
    assert tens.astype(np.complex64).dtype == torch.complex64
    np.testing.assert_array_equal(np.asarray(tens), port.values)


def test_dataset_matches_reference(arrays):
    ref, port = arrays
    jds = JDataset({"a": ref, "b": abs(ref).max("time")}, attrs={"k": 1})
    tds = XmrDataset({"a": port, "b": abs(port).max("time")}, attrs={"k": 1})
    assert dict(tds.dims) == dict(jds.dims)
    assert sorted(tds.coords) == sorted(jds.coords)
    for sub_t, sub_j in ((tds.isel(x=1), jds.isel(x=1)),
                         (tds.sel(x=2.0), jds.sel(x=2.0))):
        for k in jds.keys():
            _assert_same(sub_t[k], sub_j[k])
    assert tds.assign_attrs(z=2).attrs == jds.assign_attrs(z=2).attrs
    assert "a" in tds and list(tds) == ["a", "b"]


# ---------------------------------------------------------------------------
# Vocabulary, validation, dtypes
# ---------------------------------------------------------------------------


def test_vocabulary_is_the_references():
    for name in ("ATTRS", "DIMS", "COORDS", "VARS"):
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        jt, tt = j._get_terms(), t._get_terms()
        assert list(tt) == list(jt)
        for key in jt:
            assert tt[key] == jt[key]
            assert tt[key].unit == jt[key].unit
            assert tt[key].description == jt[key].description
            assert tt[key].long_name == jt[key].long_name


def test_dim_check_and_as_coord_match_reference(arrays):
    ref, port = arrays
    with pytest.raises(ValueError) as e_ref:
        j_check_dims(ref, ["time", "freq"], "op")
    with pytest.raises(ValueError) as e_port:
        _check_dims(port, ["time", "freq"], "op")
    assert str(e_port.value) == str(e_ref.value)
    jc = j_as_coord(jconfig.COORDS.frequency, "frequency", np.arange(3.0))
    tc = as_coord(tconfig.COORDS.frequency, "frequency", np.arange(3.0))
    assert (tc.dim, tc.attrs) == (jc.dim, jc.attrs)


def test_requires_attrs_matches_reference():
    from xmris_tpu.core.validation import requires_attrs as j_requires

    class Holder:
        def __init__(self, attrs):
            self._obj = type("O", (), {"attrs": attrs})()

    def make(deco):
        class Acc(Holder):
            @deco("reference_frequency")
            def to_ppm(self):
                """Convert."""
                return 1

        return Acc

    j_acc, t_acc = make(j_requires), make(requires_attrs)
    assert t_acc.to_ppm.__doc__ == j_acc.to_ppm.__doc__
    assert t_acc({"reference_frequency": 1}).to_ppm() == 1
    with pytest.raises(ValueError) as e_ref:
        j_acc({}).to_ppm()
    with pytest.raises(ValueError) as e_port:
        t_acc({}).to_ppm()
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128, np.int32])
def test_matching_dtypes_match_reference(dtype):
    assert matching_dtypes(dtype) == j_matching(dtype)
    from xmris_tpu_torch.core.array import torch_dtype

    if dtype is not np.int32:
        assert matching_dtypes(torch_dtype(dtype)) == j_matching(dtype)


# ---------------------------------------------------------------------------
# Fourier engine and FID ops
# ---------------------------------------------------------------------------

FOURIER = {
    "fft": lambda m, a: m.fft(a, dim="time"),
    "fft_out_dim": lambda m, a: m.fft(a, dim="time", out_dim="frequency"),
    "fft_2d": lambda m, a: m.fft(a, dim=["x", "time"], out_dim=["kx", "f"]),
    "ifft": lambda m, a: m.ifft(m.fft(a, dim="time"), dim="time"),
    "fftc": lambda m, a: m.fftc(a, dim="time", out_dim="frequency"),
    "ifftc": lambda m, a: m.ifftc(a, dim="time", out_dim="frequency"),
    "fftshift": lambda m, a: m.fftshift(a, dim="time"),
    "ifftshift": lambda m, a: m.ifftshift(a, dim=["time", "y"]),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("op", sorted(FOURIER))
def test_fourier_ops_match_reference(arrays, op, payload):
    ref, port = arrays
    _assert_same(FOURIER[op](tfourier, _as(payload, port)),
                 FOURIER[op](jfourier, ref))


FID = {
    "to_spectrum": lambda m, a: m.to_spectrum(a),
    "to_fid": lambda m, a: m.to_fid(m.to_spectrum(a)),
    "apodize_exp": lambda m, a: m.apodize_exp(a, lb=5.0),
    "zero_fill_end": lambda m, a: m.zero_fill(a, target_points=40),
    "zero_fill_sym": lambda m, a: m.zero_fill(a, target_points=31,
                                              position="symmetric"),
    "zero_fill_noop": lambda m, a: m.zero_fill(a, target_points=8),
    "chain": lambda m, a: m.to_spectrum(m.apodize_exp(
        m.zero_fill(a, target_points=32), lb=2.0)),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("op", sorted(FID))
def test_fid_ops_match_reference(arrays, op, payload):
    ref, port = arrays
    _assert_same(FID[op](tfid, _as(payload, port)), FID[op](jfid, ref))


def test_fid_op_errors_match_reference(arrays):
    ref, port = arrays
    with pytest.raises(ValueError) as e_ref:
        jfid.zero_fill(ref, target_points=40, position="middle")
    with pytest.raises(ValueError) as e_port:
        tfid.zero_fill(port, target_points=40, position="middle")
    assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match="missing"):
        tfid.to_spectrum(port, dim="frequency")


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kw", [
    dict(p0=30.0), dict(p0=-45.0, p1=120.0), dict(p0=10.0, p1=-300.0, pivot=20.0),
])
def test_phase_matches_reference(arrays, payload, kw):
    ref, port = arrays
    spec_ref = jfid.to_spectrum(ref)
    spec = tfid.to_spectrum(_as(payload, port))
    _assert_same(tph.phase(spec, **kw), jph.phase(spec_ref, **kw))
    f = spec_ref.coords["frequency"].values
    np.testing.assert_allclose(
        tph.phase_factor_raw(f, 30.0, 60.0, 10.0, 400.0),
        np.asarray(jph.phase_factor_raw(f, 30.0, 60.0, 10.0, 400.0)),
        rtol=1e-12)
    np.testing.assert_allclose(
        tph.phase_factor_raw(torch.as_tensor(f), 30.0, 60.0, 10.0, 400.0).numpy(),
        np.asarray(jph.phase_factor_raw(f, 30.0, 60.0, 10.0, 400.0)), rtol=1e-12)


def test_phase_warns_on_another_coordinate_as_reference(arrays):
    ref, port = arrays
    s_ref = jph.phase(jfid.to_spectrum(ref), p0=1.0).rename({"frequency": "f"})
    s_port = tph.phase(tfid.to_spectrum(port), p0=1.0).rename({"frequency": "f"})
    with pytest.warns(UserWarning) as w_ref:
        jph.phase(s_ref, dim="f", p0=2.0, pivot=0.0)
    with pytest.warns(UserWarning) as w_port:
        tph.phase(s_port, dim="f", p0=2.0, pivot=0.0)
    assert str(w_port[0].message) == str(w_ref[0].message)
