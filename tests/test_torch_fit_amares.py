"""The port's public ``fit_amares``, its CRLB pieces and the K6b plain twin
against the JAX package.

``fit_amares`` runs on the CPU (``device="cpu"``) on both engines, against
the reference's same engine (Pallas in interpret mode), on the bench phantom
cut to a 4x4x2 grid: parameters within rtol/atol 2e-3 and CRLB % within
2e-2 (``tests/test_process.py:78-84``), the dataset's variables, dims,
coords and attrs the reference's.  On the 5-voxel 31P oracle phantom it is
held to ``tests/test_oracle_parity.py``'s tolerances against the recorded
independent fits.  K6b's plain twin is held to
``spd_inverse_diag_pallas(interpret=True)`` at ``tests/test_spd.py``'s rtol
2e-4, with NaN rows exactly where a pivot is not positive.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xmris_tpu as xmt
from xmris_tpu.core.array import Coord as JCoord
from xmris_tpu.fitting import lm as jlm
from xmris_tpu.fitting.amares import fit_amares as ref_fit_amares
from xmris_tpu.ops.kernels.spd import spd_inverse_diag_pallas

from xmris_tpu_torch import bench_inputs as bi
from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.fitting.amares import (
    fit_amares,
    select_template_fid,
    select_template_planes,
    stage_device_fids,
    template_seeded_x0,
)
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.ops.kernels import spd
from xmris_tpu_torch.runtime import profiling

from _phantom31p import MHZ as ORACLE_MHZ
from _phantom31p import PRIOR as ORACLE_PRIOR
from _phantom31p import make_phantom
from _torch_parity import TEST_PK_CSV, load_priors

GRID = (4, 4, 2)
DIMS = ("x", "y", "z", "time")
PARAMS = ("amplitude", "chem_shift", "linewidth", "phase")


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _grid_arrays():
    """The phantom in double precision (the parity mode of the reference's
    CPU tests: the "xla" engines fit in float64, the kernel engines cast to
    float32 as on the card)."""
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    data = fids.reshape(GRID + (bi.N_TIME,)).astype(np.complex128)
    ref = xmt.XmrArray(data, dims=DIMS, coords={"time": JCoord("time", t)},
                       attrs={"MHz": bi.MHZ})
    port = XmrArray(data, dims=DIMS, coords={"time": Coord("time", t)},
                    attrs={"MHz": bi.MHZ})
    return ref, port


@pytest.fixture(scope="module")
def bench_fits(tmp_path_factory):
    path = tmp_path_factory.mktemp("pk") / "pk.csv"
    path.write_text(bi.PK_CSV)
    ref_da, port_da = _grid_arrays()
    out = {}
    for engine in ("xla", "pallas"):
        out[engine] = (ref_fit_amares(ref_da, path, engine=engine),
                       fit_amares(port_da, path, engine=engine, device="cpu"))
    return out, path


def _phase_sds(ds):
    """The Jacobian CRLB (degrees) of every peak's phase at ``ds``'s
    solution, (x, y, z, Metabolite) like the maps."""
    pk = prior_from_csv_text(bi.PK_CSV)
    n_peaks = pk.n_peaks
    x = np.zeros((int(np.prod(GRID)), pk.n_free))
    for c, name in enumerate(PARAMS):
        vals = ds[name].values.reshape(-1, n_peaks)
        for k in range(n_peaks):
            slot = pk.pmap.idx[5 * k + c]
            if slot >= 0:
                x[:, slot] = vals[:, k]
    fids, _, _ = bi.make_inputs(GRID)
    sds, _ = tlm.crlb_batched_planar(
        _t(fids.real.astype(np.float64)), _t(fids.imag.astype(np.float64)),
        _t(np.arange(bi.N_TIME) / bi.SW), _t(x), tlm.hashable_pmap(pk.pmap),
        bi.MHZ)
    slots = [pk.pmap.idx[5 * k + 3] for k in range(n_peaks)]
    return sds.numpy()[:, slots].reshape(GRID + (n_peaks,))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fit_amares_matches_reference(bench_fits, engine):
    """Maps within 2e-3 of the reference's.  On the float32 kernel engine
    the refinement pass keeps the lower of two costs that are equal to
    float32 resolution, and the two packages may keep different ones:
    phases then move along flat valleys by a few thousandths of a degree,
    so they are held to 2e-3 + 0.1 CRLB there (as chip_smoke.py holds the
    kernel path against the plain one)."""
    ref, got = bench_fits[0][engine]
    assert got["fit_converged"].values.all() and ref["fit_converged"].values.all()
    for name in PARAMS + ("snr",):
        if engine == "pallas" and name == "phase":
            continue
        np.testing.assert_allclose(got[name].values, ref[name].values,
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    if engine == "pallas":
        dp = np.abs(got["phase"].values - ref["phase"].values)
        assert np.all(dp <= 2e-3 + 0.1 * _phase_sds(got))
    np.testing.assert_allclose(got["crlb"].values, ref["crlb"].values,
                               rtol=2e-2, atol=1e-4)
    scale = float(np.abs(ref["raw_data"].values).max())
    np.testing.assert_array_equal(got["raw_data"].values, ref["raw_data"].values)
    for name in ("fit_data", "residuals"):
        np.testing.assert_allclose(got[name].values, ref[name].values,
                                   rtol=0, atol=2e-3 * scale, err_msg=name)
    amp = got["amplitude"].values.reshape(-1, 5)[:, 0]
    truth = bi.pcr_amplitudes(GRID)
    assert np.median(np.abs(amp - truth) / truth) <= 0.05


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fit_amares_dataset_layout_matches_reference(bench_fits, engine):
    ref, got = bench_fits[0][engine]
    assert sorted(got.keys()) == sorted(ref.keys())
    for name in ref.keys():
        r, g = ref[name], got[name]
        assert g.dims == r.dims, name
        assert g.shape == r.shape, name
        assert g.dtype == r.dtype, name
        assert sorted(g.coords) == sorted(r.coords), name
        for c in r.coords:
            np.testing.assert_array_equal(g.coords[c].values, r.coords[c].values)
            assert g.coords[c].dim == r.coords[c].dim
    assert sorted(got.attrs) == sorted(ref.attrs)
    for key in ("MHz", "fit_method", "prior_knowledge_file"):
        assert got.attrs[key] == ref.attrs[key]
    assert got.attrs["amares_version"].startswith("xmris_tpu_torch-")


def test_fit_amares_options_match_reference(bench_fits):
    """No refinement pass, no amplitude rescale, chunks and no curves: the
    same maps as the reference's with the same options."""
    _, path = bench_fits
    ref_da, port_da = _grid_arrays()
    kw = dict(engine="xla", initialize_with_lm=False, max_iter=40,
              scale_init_amplitudes=False, chunk_size=7, return_curves=False)
    ref = ref_fit_amares(ref_da, path, **kw)
    got = fit_amares(port_da, path, device="cpu", **kw)
    assert "fit_data" not in got and "fit_data" not in ref
    np.testing.assert_array_equal(got["fit_converged"].values,
                                  ref["fit_converged"].values)
    for name in PARAMS:
        np.testing.assert_allclose(got[name].values, ref[name].values,
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_fit_amares_takes_a_tensor_payload_and_a_prior_object(bench_fits):
    ref, got = bench_fits[0]["xla"]
    _, port_da = _grid_arrays()
    again = fit_amares(port_da.to("cpu"), prior_from_csv_text(bi.PK_CSV),
                       device="cpu", engine="xla")
    for name in PARAMS:
        np.testing.assert_allclose(again[name].values, got[name].values,
                                   rtol=1e-6, atol=1e-6)


def test_fit_amares_kernel_counts_on_the_cpu(bench_fits):
    """On the CPU the "pallas" engine runs the plain versions of K2, K3 and
    K6b (and launches nothing)."""
    _, path = bench_fits
    _, port_da = _grid_arrays()
    K.reset_counters()
    fit_amares(port_da, path, engine="pallas", device="cpu")
    counts = K.counters()
    assert not any(counts["launches"].values())
    for name in K.PATHS["fit_amares"]:
        assert counts["plain_calls"][name] > 0, name


@pytest.fixture(scope="module")
def oracle_fit(tmp_path_factory):
    path = tmp_path_factory.mktemp("oracle") / "prior_31p.csv"
    path.write_text(ORACLE_PRIOR)
    fids, t = make_phantom()
    da = XmrArray(fids, dims=("voxel", "time"),
                  coords={"time": Coord("time", t)}, attrs={"MHz": ORACLE_MHZ})
    oracle = json.loads(
        (Path(__file__).parent / "data" / "oracle_31p_scipy.json").read_text())
    return fit_amares(da, path, device="cpu"), oracle


@pytest.mark.parametrize("field,var,tol", [
    ("amplitude", "amplitude", dict(rtol=0.01)),
    ("chem_shift", "chem_shift", dict(atol=0.01)),
    ("linewidth", "linewidth", dict(rtol=0.02)),
    ("phase", "phase", dict(atol=1.0)),
    ("amplitude_sd", "crlb", dict(rtol=0.25)),
])
def test_fit_amares_matches_the_oracle(oracle_fit, field, var, tol):
    """``tests/test_oracle_parity.py``'s tolerances against the recorded
    independent scipy fits of the 5-voxel 31P phantom."""
    ds, oracle = oracle_fit
    metabs = [str(m) for m in ds[var].coords["Metabolite"].values]
    vals = np.asarray(ds[var].values)
    if var == "crlb":  # percent of the amplitude -> absolute SD
        vals = np.asarray(ds["amplitude"].values) * vals / 100.0
    for i, m in enumerate(metabs):
        want = np.array([row[m][field] for row in oracle["voxels"]])
        np.testing.assert_allclose(vals[:, i], want, err_msg=m, **tol)


def test_fit_amares_mesh_auto_is_no_mesh_on_one_device(bench_fits):
    """``mesh="auto"`` resolves to no mesh on the CPU, as the reference
    resolves it on one device: the same dataset as ``mesh=None``; any
    other string raises the reference's ValueError."""
    out, path = bench_fits
    ref_da, port_da = _grid_arrays()
    got = fit_amares(port_da, path, engine="xla", device="cpu", mesh="auto")
    want = out["xla"][1]
    assert set(got.data_vars) == set(want.data_vars)
    for name in want.data_vars:
        np.testing.assert_array_equal(np.asarray(got[name].values),
                                      np.asarray(want[name].values))
    with pytest.raises(ValueError, match="mesh='bogus'"):
        ref_fit_amares(ref_da, path, engine="xla", mesh="bogus")
    with pytest.raises(ValueError, match="mesh='bogus'"):
        fit_amares(port_da, path, device="cpu", mesh="bogus")


def test_fit_amares_unported_options_raise(bench_fits, tmp_path):
    _, path = bench_fits
    _, da = _grid_arrays()
    with pytest.raises(ValueError, match="expected a Mesh"):
        fit_amares(da, path, device="cpu", mesh=2.0)
    with pytest.raises(ValueError, match="mhz"):
        fit_amares(XmrArray(da.data, dims=da.dims, coords=da.coords), path,
                   device="cpu")
    with pytest.raises(ValueError, match="missing"):
        fit_amares(da, path, dim="t", device="cpu")


def test_fit_amares_runs_staged_planes_and_free_g(bench_fits, tmp_path):
    """Item 6, which raised in ``test_fit_amares_unported_options_raise``,
    runs: staged planes give the unstaged dataset bit for bit, and a
    free-g prior fits on the default path and at v6."""
    _, path = bench_fits
    _, da = _grid_arrays()
    staged = stage_device_fids(da, device="cpu")
    a = fit_amares(da, path, device="cpu", device_fids=staged,
                   return_curves=False)
    b = fit_amares(da, path, device="cpu", return_curves=False)
    for name in b.data_vars:
        np.testing.assert_array_equal(a[name].values, b[name].values)
    free_g = tmp_path / "free_g.csv"
    free_g.write_text(TEST_PK_CSV)
    for kw in ({}, dict(engine="pallas", kernel_version=6)):
        K.reset_counters()
        ds = fit_amares(da, free_g, device="cpu", return_curves=False,
                        max_iter=5, **kw)
        assert np.isfinite(ds["amplitude"].values).all()
        if kw:
            assert K.counters()["plain_calls"]["eq6_normal_eq_v6"] > 0


def test_template_seeded_x0_matches_reference(tmp_path):
    from xmris_tpu.fitting.amares import template_seeded_x0 as ref_seed

    pk, pkt = load_priors(bi.PK_CSV, tmp_path)
    fids, _, _ = bi.make_inputs(GRID)
    t = np.arange(bi.N_TIME) / bi.SW
    want = ref_seed(fids, pk, jnp.asarray(t), bi.MHZ)
    got = template_seeded_x0(fids, pkt, _t(t), bi.MHZ)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _template_grid(case, dtype):
    """A (33, 128) grid for the template scan: seeded noise with a few
    strong rows, and the case's edge rows (a NaN in the strongest row, a
    strong row whose tail is constant, or nothing but zeros or NaNs)."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=(33, 128)) + 1j * rng.normal(size=(33, 128))
    z[[4, 17, 29], :10] *= [[6.0], [9.0], [7.5]]
    if case == "nan_row":
        z[17, 3] = np.nan
    elif case == "zero_noise":
        z[17, -40:] = 0.25 - 0.5j
    elif case == "all_zero":
        z[:] = 0.0
    elif case == "all_nan":
        z[:] = np.nan
    return z.astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("case", ["random", "nan_row", "zero_noise",
                                  "all_zero", "all_nan"])
def test_select_template_planes_matches_select_template_fid(case, dtype):
    """The scan on the planes, and ``select_template_fid`` on the array,
    pick the voxel of the rule stated in NumPy: ``np.nanargmax`` of signal
    = mean |first 10 points| over noise = std of the last fifth, in
    float64, SNR 0 where the noise is 0 (NaN rows skipped, an all-NaN grid
    raises), with that voxel's SNR."""
    z = _template_grid(case, dtype)
    re, im = _t(z.real), _t(z.imag)
    if case == "all_nan":
        with pytest.raises(ValueError):
            select_template_fid(z, announce=False)
        with pytest.raises(ValueError):
            select_template_planes(re, im, announce=False)
        return
    z64 = z.astype(np.complex128)
    signal = np.mean(np.abs(z64[:, :10]), axis=1)
    noise = np.std(z64[:, -max(10, z.shape[1] // 5):], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        snrs = np.where(noise == 0, 0.0, signal / noise)
    want_idx = int(np.nanargmax(snrs))
    idx, snr = select_template_planes(re, im, announce=False)
    assert idx == want_idx == select_template_fid(z, announce=False)
    np.testing.assert_allclose(snr, snrs[idx], rtol=1e-12, atol=0)
    if case in ("nan_row", "zero_noise"):
        assert idx != 17
    if case == "all_zero":
        assert (idx, snr) == (0, 0.0)


@pytest.mark.parametrize("return_curves", [True, False])
def test_fit_amares_tensor_payload_matches_numpy_payload(bench_fits,
                                                         return_curves):
    """A tensor payload is fitted from its own planes (no host copy of the
    grid; resident) and gives the numpy payload's dataset; with curves its
    ``raw_data`` is the payload."""
    _, path = bench_fits
    _, port_da = _grid_arrays()
    kw = dict(engine="pallas", device="cpu", return_curves=return_curves)
    want = fit_amares(port_da, path, **kw)
    payload = port_da.to("cpu")
    assert isinstance(payload.data, torch.Tensor)
    with profiling.recording() as rec:
        got = fit_amares(payload, path, **kw)
    counters = rec.snapshot()["counters"]
    assert counters["fit_amares.resident"] == 1
    assert set(got.data_vars) == set(want.data_vars)
    assert ("raw_data" in got.data_vars) == return_curves
    for name in want.data_vars:
        np.testing.assert_allclose(got[name].values, want[name].values,
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    if return_curves:
        np.testing.assert_array_equal(got["raw_data"].values,
                                      payload.data.numpy())


def test_stage_device_fids_splits_a_tensor_payload_where_it_lies(bench_fits):
    """``stage_device_fids`` on a tensor payload copies nothing to the host,
    and ``fit_amares`` fits the staged planes as it fits the payload."""
    _, path = bench_fits
    _, port_da = _grid_arrays()
    payload = port_da.to("cpu")
    with profiling.recording() as rec:
        staged = stage_device_fids(payload, device="cpu")
    assert not rec.snapshot()["counters"].get("host.d2h_bytes", 0)
    assert staged.dims == DIMS and staged.shape == payload.shape
    np.testing.assert_array_equal(
        staged.re.numpy() + 1j * staged.im.numpy(),
        payload.data.numpy().reshape(-1, bi.N_TIME))
    kw = dict(engine="pallas", device="cpu", return_curves=False)
    a = fit_amares(payload, path, device_fids=staged, **kw)
    b = fit_amares(payload, path, **kw)
    for name in b.data_vars:
        np.testing.assert_array_equal(a[name].values, b[name].values)


# ---------------------------------------------------------------------------
# CRLB pieces and K6b
# ---------------------------------------------------------------------------


def _hessians(b=21, f=20, seed=0):
    """SPD (B, F, F) float32 Hessians with a wide spread of scales, and the
    voxels 3 and b-1 made non-SPD."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, 2 * f, f)) * np.logspace(-2, 2, f)[None, None, :]
    h = np.einsum("bki,bkj->bij", a, a).astype(np.float32)
    h[[3, b - 1], 0, 0] = -1.0
    return h


def test_spd_inverse_diag_dense_plain_matches_reference():
    h = _hessians()
    want = np.asarray(spd_inverse_diag_pallas(jnp.asarray(h), interpret=True))
    got = spd.spd_inverse_diag_dense_plain(_t(h)).numpy()
    bad = np.zeros(len(h), bool)
    bad[[3, len(h) - 1]] = True
    np.testing.assert_array_equal(np.isnan(got).all(1), bad)
    np.testing.assert_array_equal(np.isnan(want).all(1), bad)
    assert not np.isnan(got[~bad]).any()
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=2e-4)
    # The wrapper takes the plain version on the CPU.
    np.testing.assert_array_equal(spd.spd_inverse_diag_dense(_t(h)).numpy(), got)


def test_slab_to_bff_and_the_slab_inverse_agree():
    h = _hessians(seed=1)
    slab = _t(h).permute(1, 2, 0).reshape(20 * 20, -1).contiguous()
    assert torch.equal(tlm.slab_to_bff(slab, 20), _t(h))
    a = spd.spd_inverse_diag_dense_plain(_t(h))
    b = spd.spd_inverse_diag_plain(slab)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ~torch.isnan(a)
    assert torch.equal(a[ok], b[ok])


def test_crlb_from_hessian_matches_reference():
    h = _hessians(seed=2)
    h[5, 7, :] = 0.0  # an unidentifiable parameter: zero Fisher row
    h[5, :, 7] = 0.0
    h[[3, len(h) - 1], 0, 0] = 1.0  # SPD again
    cost = np.random.default_rng(3).uniform(1.0, 5.0, len(h)).astype(np.float32)
    sds_ref, s2_ref = jlm.crlb_from_hessian(jnp.asarray(h), jnp.asarray(cost),
                                            512, interpret=True)
    sds, s2 = tlm.crlb_from_hessian(_t(h), _t(cost), 512, kernels=K.DISPATCH)
    assert np.isinf(sds.numpy()[5, 7]) and np.isinf(np.asarray(sds_ref)[5, 7])
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_ref), rtol=1e-6)
    np.testing.assert_allclose(sds.numpy(), np.asarray(sds_ref), rtol=2e-4)


def test_crlb_batched_planar_matches_reference(tmp_path):
    pk, _ = load_priors(bi.PK_CSV, tmp_path)
    fids, _, _ = bi.make_inputs((3, 2, 1))
    t = np.arange(bi.N_TIME) / bi.SW
    rng = np.random.default_rng(4)
    x = np.clip(pk.init_free[None] * rng.uniform(0.9, 1.1, (6, pk.n_free)),
                pk.lower, pk.upper)
    ps = jlm.hashable_pmap(pk.pmap)
    re, im = np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag)
    want = jlm.crlb_batched_planar(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(t), jnp.asarray(x), ps, bi.MHZ)
    got = tlm.crlb_batched_planar(_t(re), _t(im), _t(t), _t(x), ps, bi.MHZ)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)


def test_lm_fit_batched_pallas_returns_the_reference_hessian(tmp_path):
    """The public kernel LM with ``return_hessian=True``: the dense external
    Hessian at the optimum, as the reference's (slab path, interpret)."""
    pk, _ = load_priors(bi.PK_CSV, tmp_path)
    fids, _, _ = bi.make_inputs((3, 2, 1))
    t = np.arange(bi.N_TIME) / bi.SW
    ps = jlm.hashable_pmap(pk.pmap)
    u0 = jlm.external_to_internal(pk.init_free[None].repeat(6, 0), pk.lower,
                                  pk.upper, pk.kind)
    re, im = np.ascontiguousarray(fids.real), np.ascontiguousarray(fids.imag)
    args = (re, im, t, u0, pk.lower, pk.upper, pk.kind)
    res_r, h_r = jlm.lm_fit_batched_pallas(*(jnp.asarray(a) for a in args), ps,
                                           bi.MHZ, max_iter=30, interpret=True,
                                           return_hessian=True)
    res, h = tlm.lm_fit_batched_pallas(*(_t(a) for a in args), ps, bi.MHZ,
                                       max_iter=30, return_hessian=True,
                                       kernels=K.DISPATCH)
    assert h.shape == (6, pk.n_free, pk.n_free)
    np.testing.assert_allclose(res.x_free.numpy(), np.asarray(res_r.x_free),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(res_r.cost), rtol=1e-4)
    h_r = np.asarray(h_r)
    np.testing.assert_allclose(h.numpy(), h_r, rtol=2e-3,
                               atol=1e-4 * float(np.abs(h_r).max()))
    # The other versions land on the same optimum (v6: K11 on the CPU).
    res6, h6 = tlm.lm_fit_batched_pallas(*(_t(a) for a in args), ps, bi.MHZ,
                                         max_iter=30, kernel_version=6,
                                         return_hessian=True,
                                         kernels=K.DISPATCH)
    np.testing.assert_allclose(res6.x_free.numpy(), np.asarray(res_r.x_free),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res6.cost.numpy(), np.asarray(res_r.cost),
                               rtol=1e-4)
    np.testing.assert_allclose(h6.numpy(), h_r, rtol=2e-3,
                               atol=1e-4 * float(np.abs(h_r).max()))
