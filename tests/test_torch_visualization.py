"""The port's plot layer (``xmris_tpu_torch.visualization.plot``) under Agg.

1. Every case of ``tests/test_visualization.py``, run on the port: the
   configs, the dimension parsing, and each plot's rendering.
2. Parity with the JAX package's plots on the same seeded numpy inputs.
   Every line's ``get_xydata()``, the ``fill_between`` paths, the
   pcolormesh array, the texts, the face colours, the labels and the
   limits are compared.  Lines drawn straight from input values are held
   exactly; lines drawn from a spectrum (``qc_grid``) at 1e-6 of max|S|
   (PAPER.md §0's bar), and so are the limits autoscaled from them.
3. Each package's own ``fit_amares`` on the oracle phantom
   (``device="cpu"`` for the port), drawn by its own package: the two
   fits agree to ~1e-10, so every line is held at 1e-6 of its scale.
4. CPU tensor payloads draw exactly what numpy payloads draw, except the
   spectra of ``qc_grid``, which ``torch.fft`` and ``np.fft`` round
   differently: those at 1e-12 of max|S| (float64).
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import QuadMesh  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

from xmris_tpu.core.array import XmrArray as JArray  # noqa: E402
from xmris_tpu.core.array import XmrDataset as JDataset  # noqa: E402
from xmris_tpu.visualization import plot as jplot  # noqa: E402

import xmris_tpu_torch as xt  # noqa: E402
from xmris_tpu_torch import DIMS, XmrArray  # noqa: E402
from xmris_tpu_torch.core.array import Coord, XmrDataset  # noqa: E402
from xmris_tpu_torch.visualization import _host  # noqa: E402
from xmris_tpu_torch.visualization.plot import (  # noqa: E402
    CarpetConfig,
    PlotQCGridConfig,
    PlotTrajectoryConfig,
    WaterfallConfig,
    parse_input_dims_timeseries,
    plot_carpet,
    plot_qc_grid,
    plot_trajectory,
    plot_waterfall,
)

from _phantom31p import MHZ as ORACLE_MHZ  # noqa: E402
from _phantom31p import PRIOR as ORACLE_PRIOR  # noqa: E402
from _phantom31p import make_phantom as oracle_phantom  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _series_np(seed=0, n=256, reps=10):
    """``tests/test_visualization.py``'s series: reps x n-pt spectra."""
    rng = np.random.default_rng(seed)
    ppm = np.linspace(10, -10, n)
    data = np.exp(-((ppm[None, :] - 2.0) ** 2)) * np.arange(1, reps + 1)[:, None]
    data = data + rng.normal(0, 0.01, data.shape)
    return data, ppm, np.arange(reps) * 2.0


def _series(cls, data, ppm, reps, wrap=lambda x: x):
    return cls(
        wrap(data),
        dims=("repetitions", DIMS.chemical_shift),
        coords={
            DIMS.chemical_shift: (DIMS.chemical_shift, ppm, {"units": "ppm"}),
            "repetitions": ("repetitions", reps, {"units": "s"}),
        },
    )


@pytest.fixture
def series_da():
    return _series(XmrArray, *_series_np())


# ---------------------------------------------------------------------------
# 1. tests/test_visualization.py on the port
# ---------------------------------------------------------------------------


class TestInputParsing:
    def test_auto_detect_chemical_shift(self, series_da):
        x, stack = parse_input_dims_timeseries(series_da)
        assert x == DIMS.chemical_shift
        assert stack == "repetitions"

    def test_explicit_dims(self, series_da):
        x, stack = parse_input_dims_timeseries(
            series_da, "chemical_shift", "repetitions"
        )
        assert (x, stack) == ("chemical_shift", "repetitions")

    def test_missing_x_raises(self):
        da = XmrArray(np.zeros((2, 3)), dims=("a", "b"))
        with pytest.raises(ValueError, match="chemical_shift"):
            parse_input_dims_timeseries(da)

    def test_one_dim_raises(self):
        da = XmrArray(np.zeros(4), dims=(DIMS.frequency,))
        with pytest.raises(ValueError, match="at least two"):
            parse_input_dims_timeseries(da)

    def test_three_dim_prefers_average(self):
        da = XmrArray(
            np.zeros((2, 3, 4)), dims=("other", DIMS.average, DIMS.frequency)
        )
        x, stack = parse_input_dims_timeseries(da)
        assert x == DIMS.frequency
        assert stack == DIMS.average


class TestConfigs:
    @pytest.mark.parametrize(
        "cfg_cls",
        [WaterfallConfig, CarpetConfig, PlotTrajectoryConfig, PlotQCGridConfig],
    )
    def test_rich_reprs(self, cfg_cls):
        cfg = cfg_cls()
        html = cfg._repr_html_()
        assert cfg_cls.__name__ in html
        md = cfg._repr_markdown_()
        assert "| Parameter |" in md
        s = str(cfg)
        assert "Current Settings" in s

    @pytest.mark.parametrize("name", ["WaterfallConfig", "CarpetConfig",
                                      "PlotTrajectoryConfig", "PlotQCGridConfig"])
    def test_reprs_equal_the_references(self, name):
        ours, ref = getattr(xt, name)(), getattr(jplot, name)()
        assert ours._repr_html_() == ref._repr_html_()
        assert ours._repr_markdown_() == ref._repr_markdown_()
        assert str(ours) == str(ref)

    def test_waterfall_defaults(self):
        cfg = WaterfallConfig()
        assert cfg.cmap == "magma"
        assert cfg.stack_skew == -20.0
        assert cfg.figsize == (8, 6)

    def test_carpet_defaults(self):
        cfg = CarpetConfig()
        assert cfg.cbar_label == "Signal Intensity (a.u.)"
        assert cfg.cmap_start == 0.1


class TestWaterfall:
    def test_renders(self, series_da):
        ax = plot_waterfall(series_da)
        assert len(ax.lines) >= 10
        assert ax.xaxis_inverted()

    def test_accessor_route(self, series_da):
        ax = series_da.xmr.plot.waterfall()
        assert ax is not None

    def test_invalid_skew(self, series_da):
        with pytest.raises(ValueError, match="stack_skew"):
            plot_waterfall(series_da, config=WaterfallConfig(stack_skew=90.0))

    def test_no_cmap(self, series_da):
        ax = plot_waterfall(series_da, config=WaterfallConfig(cmap=None))
        assert len(ax.collections) == 0  # no fills

    def test_renders_without_x_coordinate(self, series_da):
        bare = XmrArray(
            np.asarray(series_da.values),
            dims=("repetitions", DIMS.chemical_shift),
        )
        ax = plot_waterfall(bare)
        assert len(ax.lines) >= 10
        plt.close("all")
        ax = plot_carpet(bare)
        assert len(ax.collections) >= 1


class TestCarpet:
    def test_renders(self, series_da):
        ax = plot_carpet(series_da)
        assert len(ax.collections) >= 1  # the pcolormesh
        assert ax.xaxis_inverted()

    def test_no_colorbar(self, series_da):
        ax = plot_carpet(series_da, config=CarpetConfig(cbar_on=False))
        assert len(ax.get_figure().axes) == 1


class TestTrajectoryAndQC:
    @pytest.fixture(scope="class")
    def fit_ds(self, tmp_path_factory):
        from tests.test_fitting import PK_CSV, make_phantom

        pk = tmp_path_factory.mktemp("pk") / "pk.csv"
        pk.write_text(PK_CSV)
        return _to_port(make_phantom(n_voxels=4)).xmr.fit_amares(pk, device="cpu")

    def test_trajectory(self, fit_ds):
        ax = fit_ds.xmr.plot.trajectory(dim="voxel")
        assert len(ax.lines) == 2  # PCr + ATP
        assert len(ax.collections) == 2  # error bands

    def test_trajectory_metabolite_subset(self, fit_ds):
        ax = fit_ds.xmr.plot.trajectory(dim="voxel", metabolites=["PCr"])
        assert len(ax.lines) == 1

    def test_trajectory_missing_var(self):
        with pytest.raises(ValueError, match="amplitude"):
            XmrDataset().xmr.plot.trajectory(dim="voxel")

    def test_qc_grid(self, fit_ds):
        fig = fit_ds.xmr.plot.qc_grid(dim="voxel")
        active = [a for a in fig.axes if a.axison]
        assert len(active) == 4

    def test_qc_grid_downsampling(self, fit_ds):
        fig = fit_ds.xmr.plot.qc_grid(
            dim="voxel", config=PlotQCGridConfig(max_plots=2)
        )
        active = [a for a in fig.axes if a.axison]
        assert len(active) == 2


# ---------------------------------------------------------------------------
# Drawing extraction and comparison
# ---------------------------------------------------------------------------


def _to_port(jda, wrap=lambda x: x):
    """A reference XmrArray's numpy payload, coords and attrs in the port's
    carrier (``wrap`` turns the payload into a tensor)."""
    return XmrArray(wrap(np.asarray(jda.values)), dims=jda.dims,
                    coords={k: Coord(c.dim, c.values, c.attrs)
                            for k, c in jda.coords.items()},
                    attrs=dict(jda.attrs), name=jda.name)


def _to_ref(da):
    return JArray(np.asarray(da.values), dims=da.dims,
                  coords={k: (c.dim, c.values, c.attrs) for k, c in da.coords.items()},
                  attrs=dict(da.attrs), name=da.name)


def _ds_to(ds, conv, cls):
    return cls({k: conv(v) for k, v in ds.items()}, dict(ds.attrs))


def _drawn(obj):
    """Everything a figure draws, per axes, as plain data."""
    fig = obj if isinstance(obj, Figure) else obj.get_figure()
    out = []
    for ax in fig.axes:
        meshes = [c for c in ax.collections if isinstance(c, QuadMesh)]
        polys = [c for c in ax.collections if not isinstance(c, QuadMesh)]
        out.append(dict(
            lines=[ln.get_xydata() for ln in ax.lines],
            line_style=[(ln.get_color(), ln.get_linewidth(), ln.get_marker(),
                         ln.get_label(), ln.get_alpha()) for ln in ax.lines],
            polys=[[p.vertices for p in c.get_paths()] for c in polys],
            poly_colors=[c.get_facecolor().tolist() for c in polys],
            meshes=[np.asarray(m.get_array()) for m in meshes],
            mesh_coords=[m.get_coordinates() for m in meshes],
            texts=[(t.get_text(), t.get_color()) for t in ax.texts],
            face=ax.get_facecolor(),
            labels=(ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
            legend=([t.get_text() for t in ax.get_legend().get_texts()]
                    if ax.get_legend() else None),
            xlim=ax.get_xlim(), ylim=ax.get_ylim(), axison=ax.axison,
        ))
    sup = fig._supxlabel.get_text() if fig._supxlabel else None
    return out, sup


def _close(got, ref, atol, what):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    if atol == 0:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def _assert_same_drawing(got, ref, y_atol=0.0, x_atol=0.0):
    """Identical drawings, the y values (and limits) within ``y_atol``."""
    (g_axes, g_sup), (r_axes, r_sup) = got, ref
    assert g_sup == r_sup and len(g_axes) == len(r_axes)
    for k, (g, r) in enumerate(zip(g_axes, r_axes)):
        for key in ("line_style", "poly_colors", "texts", "labels", "legend",
                    "axison"):
            assert g[key] == r[key], (k, key)
        assert g["face"] == r["face"], (k, "face")
        assert len(g["lines"]) == len(r["lines"]), k
        for i, (gl, rl) in enumerate(zip(g["lines"], r["lines"])):
            _close(gl[:, 0], rl[:, 0], x_atol, f"axes {k} line {i} x")
            _close(gl[:, 1], rl[:, 1], y_atol, f"axes {k} line {i} y")
        assert [len(p) for p in g["polys"]] == [len(p) for p in r["polys"]]
        for i, (gp, rp) in enumerate(zip(g["polys"], r["polys"])):
            for gv, rv in zip(gp, rp):
                _close(gv[:, 0], rv[:, 0], x_atol, f"axes {k} poly {i} x")
                _close(gv[:, 1], rv[:, 1], y_atol, f"axes {k} poly {i} y")
        for i, (gm, rm) in enumerate(zip(g["meshes"], r["meshes"])):
            _close(gm, rm, y_atol, f"axes {k} mesh {i}")
            _close(g["mesh_coords"][i], r["mesh_coords"][i], x_atol,
                   f"axes {k} mesh coords {i}")
        _close(g["xlim"], r["xlim"], x_atol, f"axes {k} xlim")
        _close(g["ylim"], r["ylim"], y_atol, f"axes {k} ylim")


# ---------------------------------------------------------------------------
# 2. Parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

WATERFALL_CFGS = [None, WaterfallConfig(cmap=None), WaterfallConfig(
    stack_skew=35.0, stack_label_step=3, pad_left=0.5, annotation=None)]
CARPET_CFGS = [None, CarpetConfig(cbar_on=False, grid_on=False),
               CarpetConfig(xlabel="Shift", ylabel="Time", cmap="viridis")]


def _ref_cfg(cfg):
    if cfg is None:
        return None
    import dataclasses

    return getattr(jplot, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("i", range(len(WATERFALL_CFGS)))
def test_waterfall_matches_the_reference(i):
    data, ppm, reps = _series_np(seed=3)
    cfg = WATERFALL_CFGS[i]
    got = _drawn(plot_waterfall(_series(XmrArray, data, ppm, reps), config=cfg))
    ref = _drawn(jplot.plot_waterfall(_series(JArray, data, ppm, reps),
                                      config=_ref_cfg(cfg)))
    _assert_same_drawing(got, ref)


@pytest.mark.parametrize("i", range(len(CARPET_CFGS)))
def test_carpet_matches_the_reference(i):
    data, ppm, reps = _series_np(seed=4)
    cfg = CARPET_CFGS[i]
    got = _drawn(plot_carpet(_series(XmrArray, data, ppm, reps), config=cfg))
    ref = _drawn(jplot.plot_carpet(_series(JArray, data, ppm, reps),
                                   config=_ref_cfg(cfg)))
    _assert_same_drawing(got, ref)


@pytest.fixture(scope="module")
def oracle_fits(tmp_path_factory):
    """Both packages' ``fit_amares`` on the oracle phantom."""
    path = tmp_path_factory.mktemp("oracle") / "prior_31p.csv"
    path.write_text(ORACLE_PRIOR)
    fids, t = oracle_phantom()
    ours = XmrArray(fids, dims=("voxel", "time"), coords={"time": Coord("time", t)},
                    attrs={"MHz": ORACLE_MHZ}).xmr.fit_amares(path, device="cpu")
    ref = JArray(fids, dims=("voxel", "time"), coords={"time": ("time", t)},
                 attrs={"MHz": ORACLE_MHZ}).xmr.fit_amares(path)
    return ours, ref


def _spectra_scale(ds):
    fids = np.asarray(ds["raw_data"].values)
    return float(np.abs(np.fft.fft(fids, axis=-1, norm="ortho")).max())


def _planted(ds):
    """The port's fit with one CRLB NaN and one above 20 %: the red panels."""
    crlb = np.asarray(ds["crlb"].values).copy()
    crlb[1, 0] = np.nan
    crlb[3, 1] = 25.0
    out = dict(ds.items())
    out["crlb"] = ds["crlb"].copy(data=crlb)
    return XmrDataset(out, dict(ds.attrs))


QC_CFGS = [None, PlotQCGridConfig(max_plots=3), PlotQCGridConfig(
    max_cols=2, sharey=True, plot_residuals=False, crlb_threshold=0.1,
    xlim=(400.0, -1200.0), ylim=(-5.0, 60.0), fail_color="#ddeeff")]


@pytest.mark.parametrize("i", range(len(QC_CFGS)))
def test_qc_grid_matches_the_reference_on_one_dataset(oracle_fits, i):
    ds = _planted(oracle_fits[0])
    cfg = QC_CFGS[i]
    got = _drawn(plot_qc_grid(ds, "voxel", config=cfg))
    ref = _drawn(jplot.plot_qc_grid(_ds_to(ds, _to_ref, JDataset), "voxel",
                                    config=_ref_cfg(cfg)))
    _assert_same_drawing(got, ref, y_atol=1e-6 * _spectra_scale(ds))


def test_qc_grid_red_panels_are_the_failed_ones(oracle_fits):
    ds = _planted(oracle_fits[0])
    fig = plot_qc_grid(ds, "voxel")
    red = [a.get_facecolor() == matplotlib.colors.to_rgba("#ffe6e6")
           for a in fig.axes]
    worst = np.nanmax(np.nan_to_num(ds["crlb"].values, nan=np.inf), axis=1)
    assert red == list(worst > 20.0)
    assert [t.get_text() for t in fig.axes[1].texts] == ["1\nCRLB: NaN"]
    assert [t.get_text() for t in fig.axes[3].texts] == ["3\nCRLB: 25.0%"]


@pytest.mark.parametrize("metabolites", [None, ["ATP"]])
def test_trajectory_matches_the_reference_on_one_dataset(oracle_fits, metabolites):
    ds = _planted(oracle_fits[0])
    cfg = PlotTrajectoryConfig(palette=("red", "blue"), title=None) \
        if metabolites else None
    got = _drawn(plot_trajectory(ds, "voxel", metabolites, config=cfg))
    ref = _drawn(jplot.plot_trajectory(_ds_to(ds, _to_ref, JDataset), "voxel",
                                       metabolites, config=_ref_cfg(cfg)))
    _assert_same_drawing(got, ref)


def test_trajectory_bands_are_amp_times_crlb(oracle_fits):
    ds = _planted(oracle_fits[0])
    ax = plot_trajectory(ds, "voxel")
    amp, crlb = ds["amplitude"].values, np.nan_to_num(ds["crlb"].values, nan=0.0)
    for k, (line, band) in enumerate(zip(ax.lines, ax.collections)):
        np.testing.assert_array_equal(line.get_ydata(), amp[:, k])
        v = band.get_paths()[0].vertices
        lo = np.array([v[v[:, 0] == x, 1].min() for x in range(amp.shape[0])])
        hi = np.array([v[v[:, 0] == x, 1].max() for x in range(amp.shape[0])])
        half = amp[:, k] * (crlb[:, k] / 100.0)
        np.testing.assert_array_equal(lo, amp[:, k] - np.abs(half))
        np.testing.assert_array_equal(hi, amp[:, k] + np.abs(half))


def test_each_packages_fit_draws_the_same_figures(oracle_fits):
    """The slice as a whole: each package fits the oracle phantom and draws
    its own QC grid and trajectories."""
    ours, ref = oracle_fits
    s = _spectra_scale(ours)
    _assert_same_drawing(_drawn(ours.xmr.plot.qc_grid("voxel")),
                         _drawn(ref.xmr.plot.qc_grid("voxel")), y_atol=1e-6 * s)
    amp = float(np.abs(ours["amplitude"].values).max())
    _assert_same_drawing(_drawn(ours.xmr.plot.trajectory("voxel")),
                         _drawn(ref.xmr.plot.trajectory("voxel")),
                         y_atol=1e-6 * amp)


def test_plot_errors_match_the_reference(oracle_fits):
    ds = oracle_fits[0]
    jds = _ds_to(ds, _to_ref, JDataset)
    for ours, ref, msg in (
            (lambda: plot_qc_grid(ds, "nope"), lambda: jplot.plot_qc_grid(jds, "nope"),
             "nope"),
            (lambda: plot_qc_grid(XmrDataset({"crlb": ds["crlb"]}), "voxel"),
             lambda: jplot.plot_qc_grid(JDataset({"crlb": jds["crlb"]}), "voxel"),
             "fit_data"),
            (lambda: plot_trajectory(ds, "nope"),
             lambda: jplot.plot_trajectory(jds, "nope"), "nope")):
        with pytest.raises(ValueError, match=msg):
            ours()
        with pytest.raises(ValueError, match=msg):
            ref()


# ---------------------------------------------------------------------------
# 4. CPU tensor payloads draw what numpy payloads draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plot", [plot_waterfall, plot_carpet])
def test_cpu_tensor_series_draws_the_numpy_drawing(plot):
    data, ppm, reps = _series_np(seed=5)
    got = _drawn(plot(_series(XmrArray, data, ppm, reps, torch.as_tensor)))
    ref = _drawn(plot(_series(XmrArray, data, ppm, reps)))
    _assert_same_drawing(got, ref)


def test_cpu_tensor_dataset_draws_the_numpy_drawing(oracle_fits):
    ds = _planted(oracle_fits[0])
    ds_t = _ds_to(ds, lambda v: _to_port(v, torch.as_tensor), XmrDataset)
    assert isinstance(ds_t["raw_data"].data, torch.Tensor)
    _assert_same_drawing(_drawn(plot_trajectory(ds_t, "voxel")),
                         _drawn(plot_trajectory(ds, "voxel")))
    _assert_same_drawing(_drawn(plot_qc_grid(ds_t, "voxel")),
                         _drawn(plot_qc_grid(ds, "voxel")),
                         y_atol=1e-12 * _spectra_scale(ds))


def test_host_data_is_what_the_figures_draw(oracle_fits):
    """``_host``'s arrays, which ``chip_smoke.py`` checks where matplotlib is
    missing, are the arrays the figures draw."""
    ds = _planted(oracle_fits[0])
    panels = _host.qc_panels(ds, "voxel", max_plots=3)
    fig = plot_qc_grid(ds, "voxel", PlotQCGridConfig(max_plots=3))
    for i, ax in enumerate(fig.axes[:3]):
        np.testing.assert_array_equal(ax.lines[0].get_ydata(), panels.raw.values[i])
        np.testing.assert_array_equal(ax.lines[1].get_ydata(), panels.fit.values[i])
    lines = _host.trajectory_lines(ds, "voxel").lines
    ax = plot_trajectory(ds, "voxel")
    for (metab, amps, _), line in zip(lines, ax.lines):
        assert line.get_label() == metab
        np.testing.assert_array_equal(line.get_ydata(), amps)
    data, ppm, reps = _series_np()
    view = _host.stack_view(_series(XmrArray, data, ppm, reps))
    np.testing.assert_array_equal(view.values, data)
    assert (view.x_unit, view.stack_unit) == ("ppm", "s")


def test_accessor_plots_return_axes_and_figures(oracle_fits):
    ds = oracle_fits[0]
    data, ppm, reps = _series_np()
    da = _series(XmrArray, data, ppm, reps)
    assert isinstance(da.xmr.plot.waterfall(), matplotlib.axes.Axes)
    assert isinstance(da.xmr.plot.carpet(), matplotlib.axes.Axes)
    assert isinstance(ds.xmr.plot.trajectory("voxel"), matplotlib.axes.Axes)
    assert isinstance(ds.xmr.plot.qc_grid("voxel"), Figure)
