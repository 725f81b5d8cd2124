"""The port's labeled front-end ``mrsi_pipeline``, ``PipelineConfig(lb=,
gb=)`` and ``apodize_lg`` against the JAX package and against the port's
own op-by-op chain.

Both packages get the same complex128 grids (``test_parallel.make_grid``).
The reference runs its CPU engines on a one-device mesh (``mesh=None``
would shard over the eight virtual CPU devices of ``conftest.py``):
"complex" with ``autophase="none"`` and "planar" for the grid search,
never the in-graph DE.  The port computes the spectra in float32 planes (kernel K1's plain
version here), so spectra are held to 1e-6 max|S| (PAPER.md's parity bar),
the single-pivot phase to 0.5 deg, and the front-end to its own raw
pipeline bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import xmris_tpu as xmt
from xmris_tpu.ops.fid import apodize_lg as ref_apodize_lg
from xmris_tpu.parallel import PipelineConfig as RefConfig
from xmris_tpu.parallel import make_mesh
from xmris_tpu.parallel import mrsi_pipeline as ref_pipeline

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.ops import fid as tfid
from xmris_tpu_torch.ops.phasing import autophase
from xmris_tpu_torch.parallel import PipelineConfig, mrsi_pipeline
from xmris_tpu_torch.parallel.mesh import make_mesh as port_make_mesh
from xmris_tpu_torch.parallel.pipeline import spectral_constants
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw

from test_parallel import make_grid


def _port(da):
    return XmrArray(np.asarray(da.values), dims=da.dims,
                    coords={k: Coord(c.dim, np.asarray(c.values), dict(c.attrs))
                            for k, c in da.coords.items()},
                    attrs=dict(da.attrs))


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= rel * scale


def _attrs_equal(a, b):
    """The same keys; the same values, but the phases (held apart): the
    same type and shape."""
    assert set(a) == set(b)
    for k in a:
        if k in ("phase_p0", "phase_p1", "phase_pivot"):
            assert type(a[k]) is type(b[k]), k
            assert np.shape(a[k]) == np.shape(b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("lb,gb,zf", [(5.0, 0.0, 512), (2.0, 8.0, 512),
                                      (4.0, 0.0, 256)])
def test_no_autophase_matches_reference(lb, gb, zf):
    """Spectra, coordinates and lineage against the reference front-end
    (256 -> 512 zero-fill, and none at 256)."""
    da = make_grid()
    cfg_kw = dict(zero_fill_to=zf, lb=lb, gb=gb, autophase="none")
    ref = ref_pipeline(da, cfg=RefConfig(**cfg_kw), engine="complex",
                       mesh=make_mesh(1))
    out = mrsi_pipeline(_port(da), cfg=PipelineConfig(**cfg_kw), device="cpu")
    assert out.dims == ref.dims and out.dtype == ref.dtype
    _close(out.values, ref.values)
    np.testing.assert_array_equal(out.coords["frequency"].values,
                                  ref.coords["frequency"].values)
    assert set(out.coords) == set(ref.coords)
    _attrs_equal(out.attrs, ref.attrs)
    assert ("zero_fill_target" in out.attrs) == (zf > 256)
    assert ("apodization_gb" in out.attrs) == (gb != 0)


def test_single_grid_search_matches_reference():
    da = make_grid(nx=2, ny=2)
    cfg_kw = dict(zero_fill_to=512, lb=3.0, autophase="single",
                  ap_optimizer="grid")
    ref = ref_pipeline(da, cfg=RefConfig(**cfg_kw), engine="planar",
                       mesh=make_mesh(1))
    out = mrsi_pipeline(_port(da), cfg=PipelineConfig(**cfg_kw), device="cpu")
    _attrs_equal(out.attrs, ref.attrs)
    assert isinstance(out.attrs["phase_p0"], float)
    d = (out.attrs["phase_p0"] - ref.attrs["phase_p0"] + 180.0) % 360.0 - 180.0
    assert abs(d) <= 0.5
    assert out.attrs["phase_pivot"] == pytest.approx(ref.attrs["phase_pivot"],
                                                     rel=1e-6)


def test_per_voxel_grid_search_lineage_matches_reference():
    """autophase="all": voxel-shaped phase attrs as the reference's, each
    voxel's p0 within 0.5 deg."""
    da = make_grid(nx=2, ny=2, n=128)
    cfg_kw = dict(zero_fill_to=256, lb=3.0, autophase="all",
                  ap_optimizer="grid", p0_only=True)
    ref = ref_pipeline(da, cfg=RefConfig(**cfg_kw), engine="complex",
                       mesh=make_mesh(1))
    out = mrsi_pipeline(_port(da), cfg=PipelineConfig(**cfg_kw), device="cpu")
    _attrs_equal(out.attrs, ref.attrs)
    assert out.attrs["phase_p0"].shape == (2, 2)
    d = (out.attrs["phase_p0"] - ref.attrs["phase_p0"] + 180.0) % 360.0 - 180.0
    assert np.all(np.abs(d) <= 0.5)
    np.testing.assert_array_equal(out.attrs["phase_p1"], 0.0)


def test_matches_the_port_op_chain():
    """As the reference's ``TestFusedPipelineParity``: the front-end
    against ``zero_fill -> apodize -> to_spectrum [-> autophase]`` of the
    port's own ops."""
    da = _port(make_grid())
    chain = tfid.to_spectrum(tfid.apodize_exp(
        tfid.zero_fill(da, target_points=512), lb=5.0))
    fused = mrsi_pipeline(da, cfg=PipelineConfig(zero_fill_to=512, lb=5.0,
                                                 autophase="none"),
                          device="cpu")
    _close(fused.values, chain.values)
    np.testing.assert_allclose(fused.coords["frequency"].values,
                               chain.coords["frequency"].values)
    chain = tfid.to_spectrum(tfid.apodize_lg(
        tfid.zero_fill(da, target_points=512), lb=2.0, gb=8.0))
    fused = mrsi_pipeline(da, cfg=PipelineConfig(zero_fill_to=512, lb=2.0,
                                                 gb=8.0, autophase="none"),
                          device="cpu")
    _close(fused.values, chain.values)
    for k in ("zero_fill_target", "apodization_lb", "apodization_gb"):
        assert fused.attrs[k] == chain.attrs[k]

    small = _port(make_grid(nx=2, ny=2))
    chain = autophase(tfid.to_spectrum(tfid.apodize_exp(
        tfid.zero_fill(small, target_points=512), lb=3.0)),
        optimizer="grid", device="cpu")
    fused = mrsi_pipeline(small, cfg=PipelineConfig(
        zero_fill_to=512, lb=3.0, ap_optimizer="grid"), device="cpu")
    num = np.max(np.abs(fused.values - chain.values))
    assert num / np.max(np.abs(chain.values)) < 0.05


@pytest.mark.parametrize("autophase_mode", ["none", "single", "all"])
def test_front_end_is_its_raw_pipeline(autophase_mode):
    """The front-end adds only host staging: its spectra and phases equal
    ``spectral_pipeline_planar_raw`` on the same float32 planes, window
    and frequency axis, bit for bit; the stacked layout reshapes C-order to
    the flat one."""
    da = _port(make_grid(nx=3, ny=2))
    cfg = PipelineConfig(zero_fill_to=512, lb=4.0, autophase=autophase_mode,
                         ap_optimizer="grid")
    out = mrsi_pipeline(da, cfg=cfg, device="cpu")
    fids = da.values.reshape(-1, da.sizes["time"])
    _, weight, freqs = spectral_constants(da.coords["time"].values, cfg)
    sr, si, (p0, p1, piv) = spectral_pipeline_planar_raw(
        *(torch.tensor(a, dtype=torch.float32)
          for a in (fids.real, fids.imag, weight, freqs)), cfg)
    want = (sr.numpy() + 1j * si.numpy().astype(np.complex128))
    np.testing.assert_array_equal(out.values.reshape(-1, 512), want)
    if autophase_mode != "none":
        np.testing.assert_array_equal(
            np.ravel(out.attrs["phase_p0"]), np.ravel(p0.numpy()))
        np.testing.assert_array_equal(
            np.ravel(out.attrs["phase_pivot"]), np.ravel(piv.numpy()))
    if autophase_mode != "all":
        stacked = mrsi_pipeline(
            da, cfg=dataclasses.replace(cfg, spec_layout="stacked"),
            device="cpu")
        np.testing.assert_array_equal(stacked.values, out.values)
        assert stacked.dims == out.dims


def test_tensor_payload_axis_order_and_dims():
    """A tensor payload gives a tensor; the time axis may sit anywhere and
    keeps its place as the frequency axis; other coordinates are kept."""
    da = make_grid(nx=2, ny=3)
    moved = _port(da).transpose("time", "x", "y")
    moved.coords["x"] = Coord("x", np.arange(2.0))
    tensor_da = moved.copy(data=torch.from_numpy(moved.values))
    cfg = PipelineConfig(zero_fill_to=512, autophase="none")
    out = mrsi_pipeline(tensor_da, cfg=cfg, device="cpu")
    assert isinstance(out.data, torch.Tensor)
    assert out.data.dtype == torch.complex128
    assert out.dims == ("frequency", "x", "y")
    np.testing.assert_array_equal(out.coords["x"].values, np.arange(2.0))
    flat = mrsi_pipeline(_port(da), cfg=cfg, device="cpu")
    np.testing.assert_array_equal(out.values.transpose(1, 2, 0), flat.values)


def test_mesh_and_engine_arguments():
    da = _port(make_grid(nx=1, ny=2))
    cfg = PipelineConfig(zero_fill_to=256, autophase="none")
    with pytest.raises(ValueError, match="1-D Mesh"):
        mrsi_pipeline(da, cfg=cfg, mesh=object(), device="cpu")
    outs = [mrsi_pipeline(da, cfg=cfg, engine=e, device="cpu").values
            for e in ("auto", "planar", "complex")]
    outs.append(mrsi_pipeline(da, cfg=cfg, mesh=port_make_mesh(2, device="cpu"),
                              device="cpu").values)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    with pytest.raises(ValueError, match="engine"):
        mrsi_pipeline(da, cfg=cfg, engine="xla", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            mrsi_pipeline(da, cfg=cfg)  # the card by default


def test_pipeline_config_lb_gb_match_reference():
    """The reference's fields in its order, without the XLA DFT knobs and
    ``phase_barrier``; the same defaults and validation."""
    dropped = {"dft_variant", "dft_precision", "phase_barrier"}
    ref_fields = [f for f in dataclasses.fields(RefConfig)
                  if f.name not in dropped]
    fields = dataclasses.fields(PipelineConfig)
    assert [f.name for f in fields] == [f.name for f in ref_fields]
    assert [f.default for f in fields] == [f.default for f in ref_fields]
    cfg = PipelineConfig(lb=5.0, gb=8.0)
    assert (cfg.lb, cfg.gb) == (5.0, 8.0)


@pytest.mark.parametrize("lb,gb", [(2.0, 8.0), (3.0, 0.0)])
def test_apodize_lg_equals_reference(lb, gb):
    da = make_grid(nx=2, ny=1)
    ref = ref_apodize_lg(da, lb=lb, gb=gb)
    out = tfid.apodize_lg(_port(da), lb=lb, gb=gb)
    np.testing.assert_allclose(out.values, ref.values, rtol=1e-12, atol=0)
    assert out.attrs == {**ref.attrs}
    assert out.dims == ref.dims
    assert xmt.ATTRS.apodization_gb in out.attrs
