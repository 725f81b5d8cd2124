"""The port's widget layer (``xmris_tpu_torch.visualization.widget``).

1. Every case of ``tests/test_widgets.py``, run on the port: factories,
   trait payloads, the static exporter.
2. Parity with the JAX package's widgets on the same seeded numpy inputs:
   each widget's synced traits are equal, and so is the standalone HTML of
   ``widget_to_iframe_html`` / ``export_widget_static``.  The port's JS and
   CSS assets are byte-identical to the reference's, so the HTML needs no
   exception for text that names a package.
3. CPU tensor payloads give exactly the traits of numpy payloads, and the
   apodizer zero-fills a tensor FID where it lies.
"""

import base64
import re

import numpy as np
import pytest
import torch

from xmris_tpu.core.array import XmrArray as JArray
from xmris_tpu.visualization import widget as jwidget
from xmris_tpu.visualization.widget._static_exporter import (
    extract_synced_traits as j_extract,
)

from xmris_tpu_torch import DIMS, XmrArray
from xmris_tpu_torch.visualization.widget import (
    HAS_ANYWIDGET,
    WidgetBase,
    apodize_interactive,
    export_widget_static,
    phase_spectrum,
    scroll_spectra,
    widget_to_iframe_html,
)
from xmris_tpu_torch.visualization.widget._static_exporter import (
    build_standalone_html,
    extract_synced_traits,
)


def _spectrum_np():
    n = 128
    ppm = np.linspace(10, -10, n)
    data = np.exp(-((ppm - 2.0) ** 2)) + 1j * np.exp(-((ppm - 2.0) ** 2)) * 0.1
    return data, ppm


def _fid_np(n=100):
    t = np.arange(n) / 4000.0
    return np.exp((1j * 2 * np.pi * 300.0 - 30.0) * t), t


FID_ATTRS = {"reference_frequency": 100.0, "carrier_ppm": 4.7}


@pytest.fixture
def spectrum_1d():
    data, ppm = _spectrum_np()
    return XmrArray(data, dims=(DIMS.chemical_shift,),
                    coords={DIMS.chemical_shift: ppm})


@pytest.fixture
def fid_1d():
    data, t = _fid_np()
    return XmrArray(data, dims=(DIMS.time,), coords={DIMS.time: t},
                    attrs=FID_ATTRS)


# ---------------------------------------------------------------------------
# 1. tests/test_widgets.py on the port
# ---------------------------------------------------------------------------


class TestPhaseWidget:
    def test_factory_traits(self, spectrum_1d):
        w = phase_spectrum(spectrum_1d)
        assert len(w.reals) == 128
        assert len(w.imags) == 128
        assert w.x_label == "Chemical Shift [ppm]"
        mags = np.abs(spectrum_1d.values)
        expected = spectrum_1d.coords[DIMS.chemical_shift].values[np.argmax(mags)]
        assert w.pivot_val == pytest.approx(expected)

    def test_requires_1d(self, spectrum_1d):
        da2 = XmrArray(np.zeros((2, 4), complex), dims=("a", "b"))
        with pytest.raises(ValueError, match="1-D"):
            phase_spectrum(da2)

    def test_requires_complex(self):
        da = XmrArray(np.ones(8), dims=(DIMS.frequency,),
                      coords={DIMS.frequency: np.arange(8.0)})
        with pytest.raises(ValueError, match="complex"):
            phase_spectrum(da)

    def test_accessor_route(self, spectrum_1d):
        w = spectrum_1d.xmr.widget.phase_spectrum(width=500)
        assert w.width == 500


class TestScrollWidget:
    def test_factory(self):
        data = np.random.default_rng(0).normal(size=(6, 64)) + 0j
        da = XmrArray(data, dims=("repetitions", DIMS.frequency),
                      coords={DIMS.frequency: np.linspace(-100, 100, 64)})
        w = scroll_spectra(da)
        assert w.scroll_dim == "repetitions"
        assert len(w.spectra) == 6
        assert len(w.spectra[0]) == 64

    def test_part_selection(self):
        data = (1.0 + 2.0j) * np.ones((2, 8))
        da = XmrArray(data, dims=("repetitions", DIMS.frequency),
                      coords={DIMS.frequency: np.arange(8.0)})
        assert scroll_spectra(da, part="imag").spectra[0][0] == 2.0
        assert scroll_spectra(da, part="abs").spectra[0][0] == pytest.approx(np.sqrt(5))
        with pytest.raises(ValueError, match="part"):
            scroll_spectra(da, part="bogus")

    def test_requires_2d(self, spectrum_1d):
        with pytest.raises(ValueError, match="2-D"):
            scroll_spectra(spectrum_1d)

    def test_transposed_layout(self):
        data = np.arange(24.0).reshape(8, 3) + 0j
        da = XmrArray(data, dims=(DIMS.frequency, "repetitions"),
                      coords={DIMS.frequency: np.arange(8.0)})
        w = scroll_spectra(da)
        assert len(w.spectra) == 3
        assert len(w.spectra[0]) == 8

    def test_rejects_spectral_scroll_axis(self):
        data = np.zeros((2, 8)) + 0j
        da = XmrArray(data, dims=("repetitions", DIMS.frequency),
                      coords={DIMS.frequency: np.arange(8.0)})
        with pytest.raises(ValueError, match="spectral dimension"):
            scroll_spectra(da, scroll_axis=DIMS.frequency)


class TestApodizerWidget:
    def test_factory_pads_to_pow2(self, fid_1d):
        w = apodize_interactive(fid_1d)
        assert len(w.reals_t) == 128  # 100 -> next pow2
        assert len(w.x_coords) == 128
        assert w.x_label == "Chemical Shift [ppm]"

    def test_hz_axis(self, fid_1d):
        w = apodize_interactive(fid_1d, unit="hz")
        assert w.x_label == "Frequency [Hz]"
        assert max(w.x_coords) <= 2000.0

    def test_requires_1d(self):
        with pytest.raises(ValueError, match="1-D"):
            apodize_interactive(XmrArray(np.zeros((2, 4), complex), dims=("a", "b")))


class TestStaticExporter:
    def test_iframe_html(self, spectrum_1d):
        w = phase_spectrum(spectrum_1d)
        html = widget_to_iframe_html(w)
        assert html.startswith("<iframe")
        assert "data:text/html;base64," in html

    def test_export_widget_static(self, spectrum_1d):
        out = export_widget_static(phase_spectrum, spectrum_1d, width=400)
        assert "<iframe" in out.data

    def test_payload_contains_js_engine(self, spectrum_1d):
        w = phase_spectrum(spectrum_1d)
        doc = _document(widget_to_iframe_html(w))
        assert "StandaloneModel" in doc
        assert "function render" in doc
        assert "remove-me-close-btn { display: none" in doc

    def test_max_points_cap(self):
        big = XmrArray(np.ones(200_001, complex), dims=(DIMS.frequency,),
                       coords={DIMS.frequency: np.arange(200_001.0)})
        w = phase_spectrum(big)
        with pytest.raises(ValueError, match="static limit"):
            widget_to_iframe_html(w)

    def test_float_rounding(self, spectrum_1d):
        w = phase_spectrum(spectrum_1d)
        payload = extract_synced_traits(w)
        assert all(round(v, 4) == v for v in payload["reals"][:10])
        assert payload["width"] == 740

    def test_kernel_less_repr(self, spectrum_1d):
        w = phase_spectrum(spectrum_1d)
        if hasattr(w, "_repr_html_"):
            assert "<iframe" in w._repr_html_()


def _document(iframe_html: str) -> str:
    uri = re.search(r'src="data:text/html;base64,([^"]+)"', iframe_html).group(1)
    return base64.b64decode(uri).decode()


# ---------------------------------------------------------------------------
# 2. Parity with the JAX package's widgets
# ---------------------------------------------------------------------------


def _cases():
    """(name, port factory call, reference factory call) on the same data."""
    spec, ppm = _spectrum_np()
    fid, t = _fid_np()
    rng = np.random.default_rng(7)
    series = rng.normal(size=(6, 64)) + 1j * rng.normal(size=(6, 64))
    hz = np.linspace(-100, 100, 64)

    def both(cls_fn):
        return cls_fn(XmrArray), cls_fn(JArray)

    cases = {
        "phase": both(lambda C: C(spec, dims=(DIMS.chemical_shift,),
                                  coords={DIMS.chemical_shift: ppm})),
        "phase_hz_no_coords": both(lambda C: C(spec, dims=("freq_hz",))),
        "scroll": both(lambda C: C(series, dims=("repetitions", DIMS.frequency),
                                   coords={DIMS.frequency: hz})),
        "scroll_transposed": both(lambda C: C(series.T, dims=(DIMS.frequency, "time"),
                                              coords={DIMS.frequency: hz})),
        "scroll_unnamed": both(lambda C: C(series, dims=("a", "b"))),
        "fid": both(lambda C: C(fid, dims=(DIMS.time,), coords={DIMS.time: t},
                                attrs=FID_ATTRS)),
    }
    calls = [
        ("phase", "phase_spectrum", {}),
        ("phase", "phase_spectrum", dict(width=500, show_grid=False, p0=12.5)),
        ("phase_hz_no_coords", "phase_spectrum", dict(show_pivot=False)),
        ("scroll", "scroll_spectra", {}),
        ("scroll", "scroll_spectra", dict(part="abs", xlim=(50.0, -50.0),
                                          ylim=(-1, 3), trace_count=3)),
        ("scroll", "scroll_spectra", dict(part="imag", show_trace=False)),
        ("scroll_transposed", "scroll_spectra", {}),
        ("scroll_unnamed", "scroll_spectra", dict(scroll_axis="a")),
        ("fid", "apodize_interactive", {}),
        ("fid", "apodize_interactive", dict(unit="hz", lb_range=(1.0, 9.0),
                                            gb_range=(0.5, 4.0), lb=3.0)),
        ("fid", "apodize_interactive", dict(dim="time", height=300,
                                            method="lg")),
    ]
    return [(f"{name}-{fn}-{i}", fn, cases[name], kw)
            for i, (name, fn, kw) in enumerate(calls)]


CASES = _cases()


@pytest.mark.parametrize("fn,arrays,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_traits_and_html_match_the_reference(fn, arrays, kw):
    from xmris_tpu_torch.visualization import widget as twidget

    ours = getattr(twidget, fn)(arrays[0], **kw)
    ref = getattr(jwidget, fn)(arrays[1], **kw)
    assert type(ours).__name__ == type(ref).__name__
    t_ours, t_ref = extract_synced_traits(ours), j_extract(ref)
    assert t_ours == t_ref
    raw = {k: getattr(ours, k) for k in ours.traits() if not k.startswith("_")}
    assert raw == {k: getattr(ref, k) for k in ref.traits() if not k.startswith("_")}
    assert build_standalone_html(ours, t_ours) == \
        jwidget._static_exporter.build_standalone_html(ref, t_ref)
    assert widget_to_iframe_html(ours, hide_selectors=[".x"]) == \
        jwidget.widget_to_iframe_html(ref, hide_selectors=[".x"])
    assert export_widget_static(getattr(twidget, fn), arrays[0], **kw).data == \
        jwidget.export_widget_static(getattr(jwidget, fn), arrays[1], **kw).data


@pytest.mark.parametrize("fn,bad,match", [
    ("phase_spectrum", XmrArray(np.ones(8), dims=("frequency",)), "complex"),
    ("scroll_spectra", XmrArray(np.zeros(4, complex), dims=("frequency",)), "2-D"),
    ("apodize_interactive", XmrArray(np.zeros((2, 4), complex), dims=("a", "b")),
     "1-D"),
])
def test_factory_errors_match_the_reference(fn, bad, match):
    from xmris_tpu_torch.visualization import widget as twidget

    jbad = JArray(bad.values, dims=bad.dims)
    with pytest.raises(ValueError, match=match) as ours:
        getattr(twidget, fn)(bad)
    with pytest.raises(ValueError, match=match) as ref:
        getattr(jwidget, fn)(jbad)
    assert str(ours.value) == str(ref.value)


def test_backend_matches_the_reference():
    assert HAS_ANYWIDGET == jwidget.HAS_ANYWIDGET
    assert [c.__name__ for c in WidgetBase.__mro__[1:]] == \
        [c.__name__ for c in jwidget.WidgetBase.__mro__[1:]]


# ---------------------------------------------------------------------------
# 3. CPU tensor payloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,arrays,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cpu_tensor_payload_gives_the_numpy_traits(fn, arrays, kw):
    from xmris_tpu_torch.visualization import widget as twidget

    da = arrays[0]
    da_t = da.copy(data=torch.as_tensor(da.values))
    ours = getattr(twidget, fn)(da_t, **kw)
    want = getattr(twidget, fn)(da, **kw)
    assert extract_synced_traits(ours) == extract_synced_traits(want)
    assert ours.trait_values() == want.trait_values()


def test_accessor_widgets_return_widgets(spectrum_1d, fid_1d):
    from xmris_tpu_torch.visualization.widget import (
        ApodizerWidget,
        PhaseWidget,
        ScrollWidget,
    )

    series = XmrArray(np.ones((3, 8), complex), dims=("repetitions", DIMS.frequency))
    assert isinstance(spectrum_1d.xmr.widget.phase_spectrum(), PhaseWidget)
    assert isinstance(series.xmr.widget.scroll_spectra(), ScrollWidget)
    w = fid_1d.xmr.widget.apodize()
    assert isinstance(w, ApodizerWidget) and (w.width, w.height) == (800, 600)
