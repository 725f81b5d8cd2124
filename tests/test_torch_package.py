"""Packaging and boundaries of the PyTorch port.

* ``import xmris_tpu_torch`` (and every module of it) pulls in neither jax
  nor triton — checked in a fresh interpreter, since this test process has
  imported jax already;
* the kernel wrappers refuse devices they have no kernel for, and the
  build refuses to run without nvcc;
* ``chip_smoke.py`` exits non-zero without a CUDA device and prints no
  result;
* the numpy bench phantom is the bench's own.
"""

import ast
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
from xmris_tpu_torch.ops.kernels import _build, lm_cuda, spd

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
    assert csrc == ["lm_v9.cu", "spd.cu", "spectrum.cu"]
    assert "ops/kernels/csrc/*.cu" in globs
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
    plan = lm_cuda.NormalEqPlan(
        n_peaks=1, n_free=2, mhz=120.0, active=(0, 1), g_zero=(True,),
        fold_slots=(0, 1), fold_scales=(1.0, 1.0), factored=False,
    )
    z = lambda *s: torch.zeros(*s, **meta)  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        lm_cuda.eq6_normal_equations(z(2, 5), z(2, 8), z(2, 8), z(8), z(2, 2),
                                     plan)


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
