"""No module that the benchmark runs has the top-level name jax, jaxlib,
flax or xmris_tpu (whole names: xmris_tpu_torch is the program), and the
reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "xmris_tpu"}

WALK = r"""
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.control, benchmark.harness
from benchmark import harness
for w in harness.manifest()["workloads"]:
    cell = harness.load_cell(w["name"])
    harness.entry_module(cell)
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        for t in getattr(mod, "WRAPS", ()):
            harness._resolve(t)
{extra}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(extra=""):
    code = WALK.format(root=str(ROOT), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".", 1)[0] for m in mods}


def test_run_and_entries_load_no_jax_nor_the_jax_package():
    tops = _tops(_loaded())
    assert "xmris_tpu_torch" in tops
    assert not tops & BANNED, sorted(tops & BANNED)


def test_a_rehearsed_run_loads_no_jax_nor_the_jax_package():
    extra = (
        "sys.path.insert(0, {!r})\n".format(str(HERE / "tests"))
        + "from conftest import tiny_cell\n"
        + "import benchmark.run as r\n"
        + "r.run(tiny_cell('p31_grid.maps'), 3, 1.0, False, device='cpu')\n")
    tops = _tops(_loaded(extra))
    assert not tops & BANNED, sorted(tops & BANNED)


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.check, benchmark.reference.fit\n"
            "import benchmark.reference.recon, benchmark.reference.spectra\n"
            "import benchmark.roofline, benchmark.traffic.generator\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    tops = _tops(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (BANNED | {"xmris_tpu_torch"}), sorted(tops)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(HERE / path)}
    assert not tops & BANNED
    if path.startswith(("reference/", "traffic/")) or path == "roofline.py":
        assert "xmris_tpu_torch" not in tops
