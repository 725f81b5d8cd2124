"""The port's accessor layer against the JAX package's: ``simulate_fid``
(bit for bit), the Eq.6 model, ``to_real_imag``/``to_complex``, the
``fftn_ortho`` pair, the ``.xmr`` chain of the Quick Start and
``.xmr.fit_amares``, the carrier's notebook and device helpers, the
``processing`` alias and the ``DEFAULTS`` shim.

Values are held to 1e-12 in float64 unless a test says otherwise; the
searches and the fit run with ``device="cpu"`` (their default is the card).
The default autophase is differential evolution, whose draws differ between
the packages (``torch.Generator``, ``jax.random``): it is held by the pivot,
p0 within 1 deg and the ACME score reached, as ``tests/test_torch_de.py``
holds it.
"""

import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu.fitting import simulation as jsim
from xmris_tpu.models import lineshapes as jls
from xmris_tpu.ops import fourier as jfourier

import xmris_tpu_torch as xt
from xmris_tpu_torch import core as tcore
from xmris_tpu_torch.core.accessor import XmrisAccessor
from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset
from xmris_tpu_torch.fitting import simulation as tsim
from xmris_tpu_torch.models import lineshapes as tls
from xmris_tpu_torch.ops import fourier as tfourier
from xmris_tpu_torch.ops import phasing as tph
from xmris_tpu_torch.parallel.mesh import make_mesh, replicated, voxel_sharding

from _phantom31p import MHZ as ORACLE_MHZ
from _phantom31p import PRIOR as ORACLE_PRIOR
from _phantom31p import make_phantom

QUICK = dict(amplitudes=[10.0, 3.0], chemical_shifts=[4.7, 1.3],
             reference_frequency=127.6, carrier_ppm=4.7, spectral_width=5000.0,
             n_points=1024, dampings=[30.0, 20.0], target_snr=50.0)


def _same(got, ref, rtol=1e-12, atol=1e-12):
    assert got.dims == ref.dims and got.name == ref.name
    assert got.attrs == ref.attrs
    np.testing.assert_allclose(got.values, np.asarray(ref.values), rtol=rtol,
                               atol=atol)
    assert sorted(got.coords) == sorted(ref.coords)
    for k, c in ref.coords.items():
        assert got.coords[k].dim == c.dim and got.coords[k].attrs == c.attrs
        np.testing.assert_array_equal(got.coords[k].values, c.values)


@pytest.mark.parametrize("kw", [
    dict(QUICK, target_snr=None),
    dict(QUICK, seed=3),
    dict(amplitudes=[2.0, 1.0, 0.5], frequencies=[-120.0, 40.0, 310.0],
         spectral_width=4000.0, n_points=512, dampings=[12.0, 40.0, 25.0],
         phases=[0.1, -0.4, 1.0], lineshape_g=[0.0, 0.5, 1.7], dead_time=2e-4,
         target_snr=20.0, seed=11),
    dict(amplitudes=5.0, frequencies=0.0, n_points=64),
])
def test_simulate_fid_is_the_references_bit_for_bit(kw):
    ref, got = xmt.simulate_fid(**kw), xt.simulate_fid(**kw)
    assert isinstance(got.data, np.ndarray) and got.dtype == np.complex128
    np.testing.assert_array_equal(got.values, ref.values)
    _same(got, ref, rtol=0, atol=0)


def test_simulate_fid_errors_match_reference():
    bad = [dict(amplitudes=[1.0], frequencies=[1.0], chemical_shifts=[1.0]),
           dict(amplitudes=[1.0], chemical_shifts=[1.0]),
           dict(amplitudes=[1.0]),
           dict(amplitudes=[1.0, 2.0], frequencies=[1.0])]
    for kw in bad:
        with pytest.raises(ValueError) as r:
            xmt.simulate_fid(**kw)
        with pytest.raises(ValueError, match=re.escape(str(r.value))):
            xt.simulate_fid(**kw)


def _peaks(rng, shape):
    return (rng.uniform(0.5, 5.0, shape), rng.uniform(-300, 300, shape),
            rng.uniform(5, 60, shape), rng.uniform(-np.pi, np.pi, shape),
            rng.uniform(0, 1, shape))


def test_eq6_model_matches_reference():
    rng = np.random.default_rng(2)
    t = np.arange(256) / 4000.0 + 1e-4
    one = _peaks(rng, (3,))
    ref = np.asarray(jls.eq6_fid(t, *one))
    got = tls.eq6_fid(torch.as_tensor(t), *map(torch.as_tensor, one))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    many = _peaks(rng, (5, 3))
    ref_m = np.asarray(jls.eq6_fid_multi(t, *many))
    got_m = tls.eq6_fid_multi(torch.as_tensor(t), *map(torch.as_tensor, many))
    np.testing.assert_allclose(got_m.numpy(), ref_m, rtol=1e-12, atol=1e-12)
    # simulate_fid_raw broadcasts the per-peak arguments and clips g.
    args = (t, np.array([2.0, 1.0]), np.array([50.0, -80.0]), 20.0, 0.3,
            np.array([0.5, 1.5]))
    ref_r = np.asarray(jsim.simulate_fid_raw(*args))
    got_r = tsim.simulate_fid_raw(*args)
    np.testing.assert_allclose(got_r.numpy(), ref_r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_real_imag_round_trip_matches_reference(payload):
    fid_r = xmt.simulate_fid(**dict(QUICK, seed=1))
    fid = xt.simulate_fid(**dict(QUICK, seed=1))
    if payload == "tensor":
        fid = fid.to("cpu")
    ri_r, ri = fid_r.xmr.to_real_imag(), fid.xmr.to_real_imag()
    assert isinstance(ri.data, torch.Tensor) == (payload == "tensor")
    _same(ri, ri_r, rtol=0, atol=0)
    back_r, back = ri_r.xmr.to_complex(), ri.xmr.to_complex()
    _same(back, back_r, rtol=0, atol=0)
    assert back.dtype == (torch.complex128 if payload == "tensor" else np.complex128)
    with pytest.raises(ValueError, match="to_complex"):
        fid.xmr.to_complex()


def test_fftn_ortho_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 8, 10)) + 1j * rng.normal(size=(6, 8, 10))
    for axes in ((0,), (1, 2), (0, 1, 2)):
        for j, t in ((jfourier.fftn_ortho, tfourier.fftn_ortho),
                     (jfourier.ifftn_ortho, tfourier.ifftn_ortho)):
            np.testing.assert_allclose(t(torch.as_tensor(x), axes).numpy(),
                                       np.asarray(j(x, axes)), rtol=1e-12,
                                       atol=1e-12)


def _quickstart_grid(pkg, n_voxels=5):
    """BASELINE config 1: five simulated voxels of 1024 points."""
    fids = [pkg.simulate_fid(**dict(QUICK, seed=s)) for s in range(n_voxels)]
    one = fids[0]
    return pkg.XmrArray(np.stack([f.values for f in fids]),
                        dims=("voxel", "time"), coords={"time": one.coords["time"]},
                        attrs=one.attrs, name=one.name)


def _front(da):
    return da.xmr.zero_fill(target_points=2048).xmr.apodize_exp(lb=5.0) \
             .xmr.to_spectrum()


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_quickstart_chain_matches_reference(payload):
    """The README's chain on config 1 in both packages: the spectra before
    the phase search at 1e-12, the same pivot, p0 within 1 deg, the ACME
    score no worse than the reference's by 1e-3, and the peak at 4.7 ppm."""
    ref_da, da = _quickstart_grid(xmt), _quickstart_grid(xt)
    if payload == "tensor":
        da = da.to("cpu")
    spec_r, spec = _front(ref_da), _front(da)
    _same(spec, spec_r)
    out_r = spec_r.xmr.autophase().xmr.to_ppm()
    out = spec.xmr.autophase(device="cpu").xmr.to_ppm()
    assert isinstance(out.data, torch.Tensor) == (payload == "tensor")
    assert out.dims == out_r.dims == ("voxel", "chemical_shift")
    assert out.attrs["phase_pivot"] == out_r.attrs["phase_pivot"]
    dp = (out.attrs["phase_p0"] - out_r.attrs["phase_p0"] + 180.0) % 360.0 - 180.0
    assert abs(dp) <= 1.0
    f = spec.coords["frequency"].values
    vals = spec.values
    row = vals[np.unravel_index(np.argmax(np.abs(vals)), vals.shape)[0]]
    scores = [float(tph.acme_score_raw(tph._phased_real_planar(
        torch.as_tensor(row.real[None]), torch.as_tensor(row.imag[None]),
        torch.as_tensor(f), torch.tensor([o.attrs["phase_p0"]]),
        torch.tensor([o.attrs["phase_p1"]]),
        torch.tensor([[o.attrs["phase_pivot"]]]), float(f.max() - f.min())))[0])
        for o in (out, out_r)]
    assert scores[0] <= scores[1] * (1 + 1e-3)
    ppm = out.coords["chemical_shift"].values
    peak = ppm[np.argmax(np.abs(out.values), axis=1)]
    np.testing.assert_allclose(peak, 4.7, atol=float(np.abs(ppm[1] - ppm[0])))
    back = out.xmr.to_hz()
    np.testing.assert_allclose(back.coords["frequency"].values,
                               out_r.xmr.to_hz().coords["frequency"].values,
                               rtol=1e-12, atol=1e-9)


def test_accessor_methods_match_reference():
    ref, got = _quickstart_grid(xmt, 3), _quickstart_grid(xt, 3)
    cases = [
        lambda d: d.xmr.fftshift("time"),
        lambda d: d.xmr.ifftshift("time"),
        lambda d: d.xmr.fft(),
        lambda d: d.xmr.fft().xmr.ifft("time"),
        lambda d: d.xmr.fftc(),
        lambda d: d.xmr.fftc().xmr.ifftc("time"),
        lambda d: d.xmr.apodize_lg(lb=3.0, gb=6.0),
        lambda d: d.xmr.to_spectrum().xmr.to_fid(),
        lambda d: d.xmr.to_spectrum().xmr.phase(p0=30.0, p1=-100.0),
        lambda d: d.xmr.zero_fill(target_points=1500, position="symmetric"),
    ]
    for op in cases:
        _same(op(got), op(ref))
    bl_r = ref.xmr.to_spectrum().xmr.baseline_als(lam=1e4, n_iter=5)
    bl = got.xmr.to_spectrum().xmr.baseline_als(lam=1e4, n_iter=5, device="cpu")
    scale = float(np.abs(bl_r.values).max())
    _same(bl, bl_r, rtol=0, atol=1e-8 * scale)


@pytest.fixture(scope="module")
def oracle_fit(tmp_path_factory):
    path = tmp_path_factory.mktemp("oracle") / "prior_31p.csv"
    path.write_text(ORACLE_PRIOR)
    fids, t = make_phantom()
    da = XmrArray(fids, dims=("voxel", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": ORACLE_MHZ})
    oracle = json.loads(
        (Path(__file__).parent / "data" / "oracle_31p_scipy.json").read_text())
    return da.xmr.fit_amares(path, device="cpu"), oracle


@pytest.mark.parametrize("field,var,tol", [
    ("amplitude", "amplitude", dict(rtol=0.01)),
    ("chem_shift", "chem_shift", dict(atol=0.01)),
    ("linewidth", "linewidth", dict(rtol=0.02)),
    ("phase", "phase", dict(atol=1.0)),
    ("amplitude_sd", "crlb", dict(rtol=0.25)),
])
def test_accessor_fit_amares_matches_the_oracle(oracle_fit, field, var, tol):
    """``.xmr.fit_amares`` at ``tests/test_torch_fit_amares.py``'s oracle
    tolerances (``tests/test_oracle_parity.py``'s)."""
    ds, oracle = oracle_fit
    metabs = [str(m) for m in ds[var].coords["Metabolite"].values]
    vals = np.asarray(ds[var].values)
    if var == "crlb":  # percent of the amplitude -> absolute SD
        vals = np.asarray(ds["amplitude"].values) * vals / 100.0
    for i, m in enumerate(metabs):
        want = np.array([row[m][field] for row in oracle["voxels"]])
        np.testing.assert_allclose(vals[:, i], want, err_msg=m, **tol)


def test_plot_and_widget_namespaces_raise_with_item_13():
    """Item 13 is ported: each namespace call returns a figure, axes or
    widget, and the top-level visualization names resolve."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from xmris_tpu_torch.visualization.widget import (
        ApodizerWidget,
        PhaseWidget,
        ScrollWidget,
    )

    da = xt.simulate_fid(**QUICK)
    spec = da.xmr.to_spectrum()
    stack = XmrArray(np.stack([spec.values.real, 2.0 * spec.values.real]),
                     dims=("repetitions", "frequency"),
                     coords={"frequency": spec.coords["frequency"]})
    fids = XmrArray(np.stack([da.values, 0.5 * da.values]), dims=("voxel", "time"),
                    coords={"time": da.coords["time"]})
    crlb = XmrArray(np.array([[5.0], [np.nan]]), dims=("voxel", "Metabolite"),
                    coords={"Metabolite": np.array(["a"], dtype=object)})
    fit_ds = XmrDataset({"raw_data": fids, "fit_data": fids, "crlb": crlb,
                         "amplitude": crlb.copy(data=np.array([[1.0], [0.5]]))})
    axes = matplotlib.axes.Axes
    calls = [(lambda: stack.xmr.plot.waterfall(), axes),
             (lambda: stack.xmr.plot.carpet(), axes),
             (lambda: spec.xmr.widget.phase_spectrum(), PhaseWidget),
             (lambda: stack.xmr.widget.scroll_spectra(), ScrollWidget),
             (lambda: da.xmr.widget.apodize(), ApodizerWidget),
             (lambda: fit_ds.xmr.plot.qc_grid("voxel"), matplotlib.figure.Figure),
             (lambda: fit_ds.xmr.plot.trajectory("voxel"), axes)]
    for call, kind in calls:
        assert isinstance(call(), kind)
    plt.close("all")
    assert da.xmr.plot is not None and isinstance(da.xmr, XmrisAccessor)
    assert xt.WaterfallConfig is xt.visualization.plot.WaterfallConfig
    assert xt.visualization.__name__ == "xmris_tpu_torch.visualization"


def test_carrier_device_and_notebook_helpers():
    da = xt.simulate_fid(**QUICK)
    assert da.block_until_ready() is da
    t = da.to("cpu")
    assert t.block_until_ready() is t
    with pytest.raises(TypeError, match="Sharding"):
        da.device_put(sharding=object())
    mesh = make_mesh(2, device="cpu")
    for sharding in (replicated(mesh), voxel_sharding(mesh, 1)):
        placed = da.device_put(sharding)
        assert isinstance(placed.data, torch.Tensor)
        assert placed.data.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            da.device_put()
    assert "numpy" in da._repr_html_() and "torch" in t._repr_html_()
    assert "FID Signal" in da._repr_html_()
    with pytest.raises(ImportError, match="xarray"):
        da.to_xarray()
    with pytest.raises(ImportError, match="xarray"):
        XmrArray.from_xarray(object())


def test_processing_alias_config_shim_and_core_exports():
    from xmris_tpu_torch import processing
    from xmris_tpu_torch.ops import fid

    assert sorted(processing.__all__) == sorted(xmt.processing.__all__)
    assert processing.fid is fid and processing.to_spectrum is fid.to_spectrum
    assert sorted(tcore.__all__) == sorted(xmt.core.__all__)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        defaults = xt.DEFAULTS
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert defaults.time.dim == "time" and defaults.b0.key == "B0"
    from xmris_tpu_torch import config

    assert config.__dir__() == xmt.config.__dir__()
