"""Packaging and boundaries of the PyTorch port.

* ``import xmris_tpu_torch`` (and every module of it) pulls in neither jax
  nor triton — checked in a fresh interpreter, since this test process has
  imported jax already; the package alone pulls in neither matplotlib nor
  traitlets (the optional ``viz`` and ``widgets`` extras), and what a
  figure or widget draws is built without them;
* the kernel wrappers refuse devices they have no kernel for, and the
  build refuses to run without nvcc;
* ``chip_smoke.py`` exits non-zero without a CUDA device and prints no
  result;
* the numpy bench phantom is the bench's own.
"""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import xmris_tpu_torch
from xmris_tpu_torch import bench_inputs
from xmris_tpu_torch.ops.kernels import _build, acme_cuda, lm_cuda, spd

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "xmris_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            xmris_tpu_torch.__path__, "xmris_tpu_torch.")
    )


def test_import_pulls_in_neither_jax_nor_triton():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'xmris_tpu')\n"
        "       if m in sys.modules]\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("module", [
    "xmris_tpu_torch.core.array", "xmris_tpu_torch.core.config",
    "xmris_tpu_torch.core.utils", "xmris_tpu_torch.core.validation",
    "xmris_tpu_torch.runtime.config", "xmris_tpu_torch.ops.fourier",
    "xmris_tpu_torch.ops.fid", "xmris_tpu_torch.ops.phasing",
    "xmris_tpu_torch.ops.kernels.acme_cuda", "xmris_tpu_torch.fitting.amares",
    "xmris_tpu_torch.ops.kernels.lm_jac_cuda",
    "xmris_tpu_torch.ops.kernels.lm_loop_cuda", "xmris_tpu_torch.fitting.lm",
    "xmris_tpu_torch", "xmris_tpu_torch.core.accessor",
    "xmris_tpu_torch.ops.utils", "xmris_tpu_torch.interop.io",
    "xmris_tpu_torch.interop.xarray", "xmris_tpu_torch.fitting.simulation",
    "xmris_tpu_torch.models.lineshapes", "xmris_tpu_torch.recon.kspace",
    "xmris_tpu_torch.recon.sense", "xmris_tpu_torch.vendor.bruker",
    "xmris_tpu_torch.processing", "xmris_tpu_torch.config",
    "xmris_tpu_torch.visualization", "xmris_tpu_torch.visualization.plot",
    "xmris_tpu_torch.visualization.widget", "xmris_tpu_torch._scripts",
    "xmris_tpu_torch.visualization.widget.phase.phase",
    "xmris_tpu_torch.visualization.widget.scroller.scroller",
    "xmris_tpu_torch.visualization.widget.apodizer.apodizer",
])
def test_new_module_import_pulls_in_neither_jax_nor_triton(module):
    """Each module of the port's entry points, alone in a fresh
    interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'xmris_tpu')\n"
        "       if m in sys.modules]\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _fresh(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_in_neither_matplotlib_nor_traitlets():
    proc = _fresh(
        "import sys\n"
        "import xmris_tpu_torch as xt\n"
        "assert xt.WaterfallConfig().cmap == 'magma'\n"
        "import xmris_tpu_torch.visualization\n"
        "bad = [m for m in ('matplotlib', 'traitlets', 'IPython', 'jax',\n"
        "                   'triton', 'xmris_tpu') if m in sys.modules]\n"
        "print('LOADED', bad)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_drawn_data_builds_without_matplotlib_or_traitlets():
    """``visualization._host``, which ``chip_smoke.py`` drives where the
    extras are missing, imports and runs with both blocked; drawing then
    raises ImportError naming matplotlib."""
    proc = _fresh(
        "import sys\n"
        "sys.modules['matplotlib'] = sys.modules['traitlets'] = None\n"
        "import numpy as np\n"
        "from xmris_tpu_torch import XmrArray, XmrDataset\n"
        "from xmris_tpu_torch.visualization import _host, plot_waterfall\n"
        "t = np.arange(16) / 1e3\n"
        "fid = XmrArray(np.exp(-t * 50 + 2j * np.pi * 100 * t), dims=('time',),\n"
        "               coords={'time': t}, attrs={'reference_frequency': 100.0,\n"
        "                                          'carrier_ppm': 0.0})\n"
        "fids = XmrArray(np.stack([fid.values] * 3), dims=('voxel', 'time'),\n"
        "                coords={'time': t})\n"
        "crlb = XmrArray(np.ones((3, 1)), dims=('voxel', 'Metabolite'),\n"
        "                coords={'Metabolite': np.array(['a'], dtype=object)})\n"
        "ds = XmrDataset({'raw_data': fids, 'fit_data': fids, 'crlb': crlb,\n"
        "                 'amplitude': crlb})\n"
        "p = _host.qc_panels(ds, 'voxel', max_plots=2)\n"
        "assert p.raw.values.shape == (2, 16) and list(p.indices) == [0, 2]\n"
        "assert len(_host.trajectory_lines(ds, 'voxel').lines) == 1\n"
        "assert len(_host.apodize_traits(fid)['reals_t']) == 16\n"
        "spec = fid.xmr.to_spectrum()\n"
        "assert len(_host.phase_traits(spec)['mag']) == 16\n"
        "assert _host.scroll_traits(fids.xmr.to_spectrum())['scroll_dim'] == 'voxel'\n"
        "try:\n"
        "    plot_waterfall(fids.xmr.to_spectrum().real)\n"
        "except ImportError as e:\n"
        "    print('DRAWING', e)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DRAWING" in proc.stdout and "matplotlib" in proc.stdout


def test_package_source_never_imports_jax():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "triton", "xmris_tpu"), (
                    f"{path}: imports {n}")


def test_packaging_names_the_port():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    tool = cfg["tool"]["setuptools"]
    assert "xmris_tpu_torch*" in tool["packages"]["find"]["include"]
    globs = tool["package-data"]["xmris_tpu_torch"]
    csrc = sorted(p.name for p in (PKG / "ops/kernels/csrc").iterdir())
    assert csrc == ["acme.cu", "acme_eval.cuh", "lm_jac.cu", "lm_v10.cu",
                    "lm_v8.cu",
                    "lm_v9.cu", "lm_v9_eval.cuh", "lm_v9_warp.cuh",
                    "lm_v9_wide.cu", "spd.cu", "spd_factor.cuh", "spectrum.cu"]
    assert "ops/kernels/csrc/*.cu" in globs
    assert {"**/*.js", "**/*.css"} <= set(globs)
    scripts = cfg["project"]["scripts"]
    for name in ("test", "docs-api", "test-gen", "docs", "bench"):
        fn = scripts[f"xmris-tpu-torch-{name}"].split(":")[1]
        assert scripts[f"xmris-tpu-torch-{name}"] == f"xmris_tpu_torch._scripts:{fn}"
        assert callable(getattr(importlib.import_module("xmris_tpu_torch._scripts"),
                                fn))
    assert any(
        "cuda" in m for m in cfg["tool"]["pytest"]["ini_options"]["markers"]
    )


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_wrappers_refuse_devices_without_a_kernel():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spd.spd_solve_damped(torch.zeros(4, 3, **meta),
                             torch.zeros(3, 2, **meta),
                             torch.zeros(3, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        spd.spd_inverse_diag(torch.zeros(4, 3, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        spd.spd_inverse_diag_dense(torch.zeros(3, 2, 2, **meta))
    z1 = torch.zeros(3, 8, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        acme_cuda.acme_polish(z1, z1, torch.zeros(8, **meta),
                              torch.zeros(3, **meta), torch.zeros(3, 2, **meta),
                              1.0)
    plan = lm_cuda.NormalEqPlan(
        n_peaks=1, n_free=2, mhz=120.0, active=(0, 1), g_zero=(True,),
        fold_slots=(0, 1), fold_scales=(1.0, 1.0), factored=False,
    )
    z = lambda *s: torch.zeros(*s, **meta)  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        lm_cuda.eq6_normal_equations(z(2, 5), z(2, 8), z(2, 8), z(8), z(2, 2),
                                     plan)


def test_lm_family_wrappers_refuse_devices_without_a_kernel():
    from xmris_tpu_torch.fitting.lm import normal_eq_plan
    from xmris_tpu_torch.ops.kernels import lm_jac_cuda, lm_loop_cuda

    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        spd.spd_solve_damped_dense(z(3, 2, 2), z(3, 2), z(3))
    with pytest.raises(ValueError, match="unsupported device"):
        lm_jac_cuda.eq6_normal_equations_v3(z(2, 5), z(2, 8), z(2, 8), z(8),
                                            1, 120.0)
    with pytest.raises(ValueError, match="unsupported device"):
        lm_jac_cuda.eq6_normal_equations_v5(z(2, 5), z(2, 8), z(2, 8), z(8),
                                            1, 120.0, (0, 1))
    ps = ((0, 1, -1, -1, -1), (1.0, 1.0, 1.0, 1.0, 1.0),
          (0.0, 0.0, 10.0, 0.0, 0.0), 1)
    plan = normal_eq_plan(ps, 2, 120.0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        lm_loop_cuda.lm_loop_v10(z(2, 2), z(2, 8), z(2, 8), z(8), z(2), z(2),
                                 z(2), plan, ps, max_iter=3)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_inputs_are_the_bench_phantom():
    import bench

    assert bench_inputs.GRID == bench.GRID
    assert (bench_inputs.N_TIME, bench_inputs.ZERO_FILL) == (
        bench.N_TIME, bench.ZERO_FILL)
    assert (bench_inputs.SW, bench_inputs.MHZ) == (bench.SW, bench.MHZ)
    assert bench_inputs.PK_CSV == bench.PK_CSV
    assert bench_inputs.PEAKS_31P == bench.PEAKS_31P
    assert bench_inputs.FIXED_AMPS_31P == bench.FIXED_AMPS_31P
    for a, b in zip(bench_inputs.make_inputs(), bench.make_inputs()):
        np.testing.assert_array_equal(a, b)


def test_pcr_amplitudes_are_the_phantoms():
    grid = (2, 2, 3)
    fids, _, _ = bench_inputs.make_inputs(grid)
    amp = bench_inputs.pcr_amplitudes(grid)
    others = sum(a for a in bench_inputs.FIXED_AMPS_31P if a is not None)
    # FID at t = 0 is the sum of the amplitudes plus N(0, 0.3) noise.
    np.testing.assert_allclose(fids[:, 0].real, amp + others, atol=1.5)
