"""Console entry points of the port: test runner, docs generator, benchmark.

Port of :mod:`xmris_tpu._scripts` (console scripts ``xmris-tpu-torch-test``
/ ``-docs-api`` / ``-test-gen`` / ``-docs`` / ``-bench``).  The API
reference is generated from the port's docstrings with no external tooling,
the docs pages convert to notebooks as plain JSON, the tests run through
pytest, and the benchmark is ``chip_smoke.py``, which drives the port on the
card and prints the headline ms/grid and voxels/s line.  Default outputs go
to ``docs/api_torch/`` and ``tests/autogen_notebooks_torch/``, beside the
JAX package's own.
"""

from __future__ import annotations

import importlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

# The docs-page code-block convention, shared with tests/test_docs.py (the
# docs-as-tests harness) so the published notebooks and the executed tests
# can never disagree about which blocks are executable: fenced ``python``
# blocks run; a preceding HTML comment containing ``no-test`` opts out.
DOC_PYTHON_BLOCK_RE = re.compile(
    r"(<!--[^>]*no-test[^>]*-->\s*)?```python\n(.*?)```", re.DOTALL
)

# The JAX package's list with its kernel modules' counterparts:
# ``dft_pallas`` is ``dft_cuda``, and ``lm_pallas`` is split into the three
# LM wrapper modules.
_API_MODULES = [
    "xmris_tpu_torch",
    "xmris_tpu_torch.core.config",
    "xmris_tpu_torch.core.array",
    "xmris_tpu_torch.core.accessor",
    "xmris_tpu_torch.core.validation",
    "xmris_tpu_torch.ops.fourier",
    "xmris_tpu_torch.ops.fid",
    "xmris_tpu_torch.ops.phasing",
    "xmris_tpu_torch.ops.baseline",
    "xmris_tpu_torch.ops.optim",
    "xmris_tpu_torch.ops.utils",
    "xmris_tpu_torch.ops.kernels.dft",
    "xmris_tpu_torch.ops.kernels.dft_cuda",
    "xmris_tpu_torch.ops.kernels.lm_cuda",
    "xmris_tpu_torch.ops.kernels.lm_jac_cuda",
    "xmris_tpu_torch.ops.kernels.lm_loop_cuda",
    "xmris_tpu_torch.models.lineshapes",
    "xmris_tpu_torch.fitting.simulation",
    "xmris_tpu_torch.fitting.prior",
    "xmris_tpu_torch.fitting.lm",
    "xmris_tpu_torch.fitting.amares",
    "xmris_tpu_torch.parallel.mesh",
    "xmris_tpu_torch.parallel.pipeline",
    "xmris_tpu_torch.parallel.planar_pipeline",
    "xmris_tpu_torch.recon.kspace",
    "xmris_tpu_torch.recon.sense",
    "xmris_tpu_torch.vendor.bruker",
    "xmris_tpu_torch.visualization.plot",
    "xmris_tpu_torch.visualization.widget",
    "xmris_tpu_torch.interop.xarray",
    "xmris_tpu_torch.interop.io",
    "xmris_tpu_torch.runtime.cli",
    "xmris_tpu_torch.runtime.config",
    "xmris_tpu_torch.runtime.profiling",
]


def _doc_for(obj) -> str:
    return inspect.getdoc(obj) or "*(undocumented)*"


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def build_api_docs(out_dir: str | Path | None = None) -> Path:
    """Generate a markdown API reference from live docstrings."""
    out_dir = Path(out_dir or REPO_ROOT / "docs" / "api_torch")
    out_dir.mkdir(parents=True, exist_ok=True)

    index_lines = ["# API Reference", ""]
    for mod_name in _API_MODULES:
        mod = importlib.import_module(mod_name)
        lines = [f"# `{mod_name}`", "", _doc_for(mod), ""]
        public = [
            (name, obj)
            for name, obj in vars(mod).items()
            if not name.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and getattr(obj, "__module__", None) == mod_name
        ]
        for name, obj in public:
            kind = "class" if inspect.isclass(obj) else "function"
            lines += [f"## `{name}{_signature(obj)}`", "", f"*{kind}*", "",
                      _doc_for(obj), ""]
            if inspect.isclass(obj):
                for mname, meth in vars(obj).items():
                    if mname.startswith("_") or not callable(meth):
                        continue
                    lines += [f"### `{name}.{mname}{_signature(meth)}`", "",
                              _doc_for(meth), ""]
        page = out_dir / (mod_name.replace(".", "_") + ".md")
        page.write_text("\n".join(lines))
        index_lines.append(f"- [`{mod_name}`]({page.name})")

    index = out_dir / "index.md"
    index.write_text("\n".join(index_lines) + "\n")
    print(f"API reference written to {out_dir} ({len(_API_MODULES)} modules)")
    return out_dir


def markdown_to_notebook(md_path: str | Path) -> dict:
    """Convert a MyST-style markdown page to a Jupyter notebook dict.

    Fenced ``python`` blocks become code cells, everything between them
    markdown cells.  Blocks preceded by an HTML comment containing
    ``no-test`` become markdown (they document samples requiring local
    scanner exports).
    """
    text = Path(md_path).read_text()
    cells = []

    def md_cell(chunk: str):
        chunk = chunk.strip("\n")
        if chunk:
            cells.append({"cell_type": "markdown", "metadata": {},
                          "source": chunk.splitlines(keepends=True)})

    pos = 0
    for m in DOC_PYTHON_BLOCK_RE.finditer(text):
        md_cell(text[pos : m.start()])
        code = m.group(2)
        if m.group(1):  # no-test: keep as fenced markdown, don't execute
            md_cell(f"```python\n{code}```")
        else:
            cells.append({"cell_type": "code", "execution_count": None,
                          "metadata": {}, "outputs": [],
                          "source": code.splitlines(keepends=True)})
        pos = m.end()
    md_cell(text[pos:])

    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def generate_test_notebooks(out_dir: str | Path | None = None) -> Path:
    """Convert every docs page to an executable ``.ipynb``; the directory
    structure under ``docs/`` is kept so notebook names stay unique."""
    out_dir = Path(out_dir or REPO_ROOT / "tests" / "autogen_notebooks_torch")
    count = 0
    for md in sorted((REPO_ROOT / "docs").glob("**/*.md")):
        rel = md.relative_to(REPO_ROOT / "docs")
        dest = (out_dir / rel).with_suffix(".ipynb")
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(json.dumps(markdown_to_notebook(md), indent=1))
        count += 1
    print(f"{count} notebooks written to {out_dir}")
    return out_dir


def build_docs() -> None:
    """Build the full documentation set: regenerate the API reference and
    the notebook mirrors of every page."""
    build_api_docs()
    generate_test_notebooks()


def run_tests(extra_args: list[str] | None = None) -> int:
    """Run the port's tests (``tests/test_torch_*.py``)."""
    files = sorted(str(p.relative_to(REPO_ROOT))
                   for p in (REPO_ROOT / "tests").glob("test_torch_*.py"))
    cmd = [sys.executable, "-m", "pytest", *files, "-q"]
    cmd += extra_args if extra_args is not None else sys.argv[1:]
    return subprocess.call(cmd, cwd=REPO_ROOT)


def run_bench() -> int:
    """Run ``chip_smoke.py`` on the card: every kernel against its plain
    version, the main paths, and the ms/grid and voxels/s line."""
    return subprocess.call([sys.executable, str(REPO_ROOT / "chip_smoke.py")],
                           cwd=REPO_ROOT)


def main() -> None:  # pragma: no cover - thin CLI
    """Dispatch: python -m xmris_tpu_torch._scripts
    <docs-api|docs|test-gen|test|bench>."""
    cmd = sys.argv[1] if len(sys.argv) > 1 else "test"
    if cmd == "docs-api":
        build_api_docs()
    elif cmd == "docs":
        build_docs()
    elif cmd == "test-gen":
        generate_test_notebooks()
    elif cmd == "test":
        sys.exit(run_tests(sys.argv[2:]))
    elif cmd == "bench":
        sys.exit(run_bench())
    else:
        print(__doc__)
        sys.exit(2)


if __name__ == "__main__":  # pragma: no cover
    main()
