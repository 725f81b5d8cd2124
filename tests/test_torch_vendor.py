"""The port's Bruker ingest (``xmris_tpu_torch.vendor.bruker``) against the
JAX package's.

The whole chain on the synthetic 1H export in ``tests/data`` —
``load_dataarray -> .xmr.to_complex -> reshape_bruker_raw -> build_fid ->
.xmr.remove_digital_filter`` — equals the reference's at every step (host
NumPy in both packages: the sub-sample advance to 1e-12), and the
filter's cases of ``tests/test_vendor.py`` run on both: integer and
fractional delays, ``keep_length``, the re-zeroed time axis, lineage, a
tensor payload, and the reshape and build refusals.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu.interop.io import load_dataarray as j_load
from xmris_tpu.vendor import bruker as jb

import xmris_tpu_torch as xt
from xmris_tpu_torch.interop.io import load_dataarray as t_load
from xmris_tpu_torch.vendor import bruker as tb

NC = Path(__file__).parent / "data" / "synth_nspect_1H" / "rawdatajob0.nc"


def _same(got, ref, atol=0.0):
    assert isinstance(got.data, np.ndarray)
    assert got.dims == ref.dims and got.name == ref.name and got.attrs == ref.attrs
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got.values, ref.values, rtol=0, atol=atol)
    assert sorted(got.coords) == sorted(ref.coords)
    for k, c in ref.coords.items():
        assert got.coords[k].dim == c.dim and got.coords[k].attrs == c.attrs
        np.testing.assert_array_equal(got.coords[k].values, c.values)


def _chain(load, build, reshape):
    raw = load(NC)
    cplx = raw.xmr.to_complex()
    data, dims = reshape(cplx.values, cplx.attrs)
    fid = build(data, dims, cplx.attrs)
    out = fid.xmr.remove_digital_filter(
        group_delay=float(fid.attrs["bruker_group_delay"]))
    return raw, cplx, (data, dims), fid, out


def test_bruker_chain_matches_reference(capsys):
    ref = _chain(j_load, jb.build_fid, jb.reshape_bruker_raw)
    got = _chain(t_load, tb.build_fid, tb.reshape_bruker_raw)
    _same(got[0], ref[0])
    _same(got[1], ref[1])
    assert got[2][1] == ref[2][1]
    np.testing.assert_array_equal(got[2][0], ref[2][0])
    _same(got[3], ref[3])
    scale = float(np.abs(ref[4].values).max())
    _same(got[4], ref[4], atol=1e-12 * scale)
    # Both packages announce the reshape the same way.
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("Reshaped Bruker data")


def _delayed(pkg, delay_pts=20, n=512, sw=4000.0):
    t = np.arange(n) / sw
    clean = np.exp((1j * 2 * np.pi * 200.0 - 30.0) * t)
    shifted = np.concatenate([np.zeros(delay_pts, complex), clean[: n - delay_pts]])
    return pkg.XmrArray(shifted, dims=("time",), coords={"time": t})


@pytest.mark.parametrize("kw", [
    dict(group_delay=20.0), dict(group_delay=20.0, keep_length=False),
    dict(group_delay=20.5), dict(group_delay=0.37), dict(group_delay=0.0),
    dict(group_delay=76.125, keep_length=False),
])
def test_remove_digital_filter_matches_reference(kw):
    ref = jb.remove_digital_filter(_delayed(xmt), **kw)
    got = tb.remove_digital_filter(_delayed(xt), **kw)
    _same(got, ref, atol=1e-12)
    # A tensor payload comes back on the host, as the reference's device
    # payload does; a zero delay returns a copy where it lies, as there.
    on_t = tb.remove_digital_filter(_delayed(xt).to("cpu"), **kw)
    if kw["group_delay"] == 0:
        assert on_t.data.dtype == torch.complex128
        on_t = on_t.copy(data=on_t.values)
    _same(on_t, ref, atol=1e-12)
    if kw["group_delay"] > 0:
        assert got.coords["time"].values[0] == 0.0
        assert got.attrs["digital_filter_removed"] is True


def test_reshape_and_build_match_reference_and_refuse_alike(capsys):
    params = {"PVM_SpecMatrix": 4, "PVM_NAverages": 3, "PVM_NRepetitions": [2],
              "PVM_SpecSWH": [5000.0], "PVM_RepetitionTime": 1000.0,
              "PVM_FrqRef": 127.6, "PVM_FrqWorkPpm": 4.7, "groupDelay": 76.125}
    flat = np.arange(24.0)
    d_r, dims_r = jb.reshape_bruker_raw(flat, params)
    d, dims = tb.reshape_bruker_raw(flat, params)
    assert dims == dims_r == ["time", "averages", "repetitions"]
    np.testing.assert_array_equal(d, d_r)
    _same(tb.build_fid(d + 0j, dims, params), jb.build_fid(d_r + 0j, dims_r, params))
    cases = [
        (lambda m: m.reshape_bruker_raw(np.zeros(4), {}), "PVM_SpecMatrix"),
        (lambda m: m.reshape_bruker_raw(np.zeros(7), {"PVM_SpecMatrix": 4,
                                                      "PVM_NAverages": 3}),
         "Cannot reshape"),
        (lambda m: m.build_fid(np.zeros((4,)), ["averages"], {"PVM_SpecSWH": 1.0}),
         "time"),
        (lambda m: m.build_fid(np.zeros((4,)), ["time"], {"PVM_SpecSWH": 1.0}),
         "PVM_RepetitionTime"),
        (lambda m: m.build_fid(np.zeros((4, 2)), ["time"], {}), "ndim"),
        (lambda m: m.remove_digital_filter(
            (xmt if m is jb else xt).XmrArray(np.zeros(4), dims=("t",)), 2.0),
         "missing"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match) as r_ref:
            call(jb)
        with pytest.raises(ValueError) as r_got:
            call(tb)
        assert str(r_got.value) == str(r_ref.value)
