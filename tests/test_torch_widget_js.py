"""The port's browser engines against the port's ops.

The port keeps its own copies of the widget assets
(``xmris_tpu_torch/visualization/widget/*/*.{js,css}``), byte-identical to
the JAX package's.  Every case of ``tests/test_widget_js.py`` and
``tests/test_fuzz_widgets.py`` that touches an engine runs here on the
port's copies, through the JS-subset interpreter of ``tests/_jsmini.py``:
the ``DSP`` object of ``apodizer.js`` (radix-2 ortho FFT, fftshift, the
windows) against the port's ``apodize_exp``, ``apodize_lg`` and
``to_spectrum``, and ``phase.js``'s ``PHASEMATH`` against the port's
``phase``, each on CPU tensors.  The interpreter's own self-checks stay in
``tests/test_widget_js.py``: they do not read an asset.
"""

import pathlib

import numpy as np
import pytest
import torch

from _jsmini import JSError, load_widget_module
from test_widget_js import scan_js

from xmris_tpu_torch import XmrArray

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIDGET_DIR = ROOT / "xmris_tpu_torch" / "visualization" / "widget"
REF_DIR = ROOT / "xmris_tpu" / "visualization" / "widget"
JS_FILES = sorted(WIDGET_DIR.glob("*/*.js"))
ASSETS = sorted(WIDGET_DIR.glob("*/*.js")) + sorted(WIDGET_DIR.glob("*/*.css"))


def _tensor_fid(sig, t):
    return XmrArray(torch.as_tensor(sig), dims=("time",), coords={"time": t})


@pytest.mark.parametrize("path", ASSETS, ids=[p.name for p in ASSETS])
def test_assets_are_the_references_byte_for_byte(path):
    ref = REF_DIR / path.relative_to(WIDGET_DIR)
    assert path.read_bytes() == ref.read_bytes()


def test_assets_are_all_the_references():
    ours = sorted(p.relative_to(WIDGET_DIR) for p in ASSETS)
    ref = sorted(p.relative_to(REF_DIR) for p in list(REF_DIR.glob("*/*.js"))
                 + list(REF_DIR.glob("*/*.css")))
    assert ours == ref and len(ours) == 6


class TestJSStructure:
    def test_engines_present(self):
        names = {p.name for p in JS_FILES}
        assert {"phase.js", "scroller.js", "apodizer.js"} <= names

    @pytest.mark.parametrize("path", JS_FILES, ids=[p.name for p in JS_FILES])
    def test_balanced_and_terminated(self, path):
        problem = scan_js(path.read_text())
        assert problem is None, f"{path.name}: {problem}"

    @pytest.mark.parametrize("path", JS_FILES, ids=[p.name for p in JS_FILES])
    def test_exports_render(self, path):
        assert "export function render" in path.read_text()

    @pytest.mark.parametrize("path", JS_FILES, ids=[p.name for p in JS_FILES])
    def test_close_button_convention(self, path):
        assert "remove-me-close-btn" in path.read_text()


@pytest.fixture(scope="module")
def dsp():
    interp, env = load_widget_module(WIDGET_DIR / "apodizer" / "apodizer.js")
    return interp, env.get("DSP")


@pytest.fixture(scope="module")
def phasemath():
    interp, env = load_widget_module(WIDGET_DIR / "phase" / "phase.js")
    return interp, env.get("PHASEMATH")


def _call(interp_obj, name, *args):
    interp, obj = interp_obj
    fn = obj[name].bind(obj)
    return interp.call(fn, list(args))


class TestApodizerDSPNumeric:
    @pytest.mark.parametrize("n", [8, 64, 256])
    def test_fft_ortho_matches_numpy(self, dsp, n):
        rng = np.random.default_rng(n)
        re, im = rng.normal(size=n), rng.normal(size=n)
        jre, jim = list(map(float, re)), list(map(float, im))
        _call(dsp, "fftOrtho", jre, jim)  # in-place
        expected = np.fft.fft(re + 1j * im, norm="ortho")
        np.testing.assert_allclose(jre, expected.real, atol=1e-12)
        np.testing.assert_allclose(jim, expected.imag, atol=1e-12)

    def test_fft_rejects_non_pow2(self, dsp):
        with pytest.raises(JSError):
            _call(dsp, "fftOrtho", [0.0] * 12, [0.0] * 12)

    @pytest.mark.parametrize("n", [8, 63])
    def test_fftshift_matches_numpy(self, dsp, n):
        out = _call(dsp, "fftshift", list(map(float, range(n))))
        np.testing.assert_array_equal(out, np.roll(np.arange(n), n // 2))

    def test_exp_window_matches_ops(self, dsp):
        t = np.arange(128) / 4000.0
        w_js = _call(dsp, "weight", list(map(float, t)), "exp", 7.5, 0.0)
        w_py = _tensor_fid(np.ones(128, complex), t).xmr.apodize_exp(lb=7.5).values.real
        np.testing.assert_allclose(w_js, w_py, atol=1e-12)

    def test_lg_window_matches_ops(self, dsp):
        t = np.arange(128) / 4000.0
        w_js = _call(dsp, "weight", list(map(float, t)), "lg", 6.0, 9.0)
        w_py = _tensor_fid(np.ones(128, complex), t).xmr.apodize_lg(
            lb=6.0, gb=9.0).values.real
        np.testing.assert_allclose(w_js, w_py, atol=1e-12)

    def test_to_spectrum_matches_pipeline(self, dsp):
        n, sw, lb = 256, 4000.0, 5.0
        t = np.arange(n) / sw
        sig = np.exp((1j * 2 * np.pi * 300.0 - 30.0) * t)
        out = _call(dsp, "toSpectrum", list(map(float, sig.real)),
                    list(map(float, sig.imag)), list(map(float, t)), "exp", lb, 0.0)
        js_spec = np.asarray(out["re"]) + 1j * np.asarray(out["im"])
        py_spec = _tensor_fid(sig, t).xmr.apodize_exp(lb=lb).xmr.to_spectrum().values
        np.testing.assert_allclose(js_spec, py_spec, atol=1e-9)


class TestPhaseMathNumeric:
    def test_phased_matches_ops(self, phasemath):
        n = 128
        x = np.linspace(-500.0, 500.0, n)
        rng = np.random.default_rng(0)
        spec = rng.normal(size=n) + 1j * rng.normal(size=n)
        p0, p1, pivot = 37.0, -210.0, 120.0
        out = _call(phasemath, "phased", list(map(float, x)),
                    list(map(float, spec.real)), list(map(float, spec.imag)),
                    p0, p1, pivot, float(x.min()), float(x.max()))
        js = np.asarray(out["re"]) + 1j * np.asarray(out["im"])
        da = XmrArray(torch.as_tensor(spec), dims=("frequency",),
                      coords={"frequency": x})
        py = da.xmr.phase(p0=p0, p1=p1, pivot=pivot).values
        np.testing.assert_allclose(js, py, atol=1e-12)

    def test_phi_formula(self, phasemath):
        phi = _call(phasemath, "phiAt", 10.0, 90.0, 180.0, -20.0, 100.0)
        expected = np.deg2rad(90.0) + np.deg2rad(180.0) * (10.0 + 20.0) / 100.0
        assert phi == pytest.approx(expected, abs=1e-15)


# ``tests/test_fuzz_widgets.py``'s randomized sweeps on the port.


def _rng(trial, salt=0):
    return np.random.default_rng(80_000 + 211 * trial + salt)


class TestDSPFuzz:
    @pytest.mark.parametrize("trial", range(6))
    def test_fft_random_signals_and_sizes(self, dsp, trial):
        rng = _rng(trial)
        n = int(2 ** rng.integers(3, 10))
        re = rng.normal(size=n) * float(rng.uniform(0.1, 100.0))
        im = rng.normal(size=n) * float(rng.uniform(0.1, 100.0))
        jre, jim = list(map(float, re)), list(map(float, im))
        _call(dsp, "fftOrtho", jre, jim)
        expected = np.fft.fft(re + 1j * im, norm="ortho")
        scale = max(1.0, float(np.max(np.abs(expected))))
        np.testing.assert_allclose(jre, expected.real, atol=1e-11 * scale)
        np.testing.assert_allclose(jim, expected.imag, atol=1e-11 * scale)

    @pytest.mark.parametrize("trial", range(6))
    def test_to_spectrum_chain_random_params(self, dsp, trial):
        rng = _rng(trial, salt=1)
        n = int(2 ** rng.integers(6, 9))
        sw = float(rng.uniform(1000.0, 16000.0))
        t = np.arange(n) / sw
        sig = np.zeros(n, dtype=np.complex128)
        for _ in range(int(rng.integers(1, 4))):
            f0 = rng.uniform(-sw / 2 * 0.8, sw / 2 * 0.8)
            sig += rng.uniform(0.5, 10.0) * np.exp(
                (1j * 2 * np.pi * f0 - rng.uniform(5.0, 50.0)) * t)
        sig += 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))

        window = str(rng.choice(["exp", "lg"]))
        lb = float(rng.uniform(0.0, 25.0))
        gb = float(rng.uniform(0.5, 20.0)) if window == "lg" else 0.0

        out = _call(dsp, "toSpectrum", list(map(float, sig.real)),
                    list(map(float, sig.imag)), list(map(float, t)), window, lb, gb)
        js_spec = np.asarray(out["re"]) + 1j * np.asarray(out["im"])

        fid = _tensor_fid(sig, t)
        apod = (fid.xmr.apodize_exp(lb=lb) if window == "exp"
                else fid.xmr.apodize_lg(lb=lb, gb=gb))
        py_spec = apod.xmr.to_spectrum().values
        scale = float(np.max(np.abs(py_spec)))
        np.testing.assert_allclose(js_spec, py_spec, atol=1e-9 * scale)


class TestPhaseMathFuzz:
    @pytest.mark.parametrize("trial", range(8))
    def test_phased_random_grids_and_params(self, phasemath, trial):
        rng = _rng(trial, salt=2)
        n = int(rng.integers(16, 300))
        x0 = float(rng.uniform(-2000.0, 0.0))
        x1 = x0 + float(rng.uniform(100.0, 4000.0))
        x = np.linspace(x0, x1, n)
        spec = rng.normal(size=n) + 1j * rng.normal(size=n)
        p0 = float(rng.uniform(-360.0, 360.0))
        p1 = float(rng.uniform(-4000.0, 4000.0))
        pivot = float(rng.uniform(x0 - 500.0, x1 + 500.0))

        out = _call(phasemath, "phased", list(map(float, x)),
                    list(map(float, spec.real)), list(map(float, spec.imag)),
                    p0, p1, pivot, float(x.min()), float(x.max()))
        js = np.asarray(out["re"]) + 1j * np.asarray(out["im"])
        da = XmrArray(torch.as_tensor(spec), dims=("frequency",),
                      coords={"frequency": x})
        py = da.xmr.phase(p0=p0, p1=p1, pivot=pivot).values
        np.testing.assert_allclose(js, py, atol=1e-11)
