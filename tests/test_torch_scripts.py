"""The port's console entry points (``xmris_tpu_torch._scripts``).

``tests/test_runtime.py::TestScripts`` run on the port, the docs-to-notebook
conversion held to the JAX package's page by page, the default output
directories (``docs/api_torch/``, ``tests/autogen_notebooks_torch/``, both
beside the JAX package's own), and the commands that ``run_tests`` and
``run_bench`` start.
"""

import json
import sys
from pathlib import Path

import pytest

from xmris_tpu import _scripts as jscripts

from xmris_tpu_torch import _scripts

ROOT = Path(__file__).resolve().parents[1]


class TestScripts:
    def test_api_docs_generation(self, tmp_path):
        out = _scripts.build_api_docs(tmp_path / "api")
        index = (out / "index.md").read_text()
        assert "xmris_tpu_torch.ops.fourier" in index
        fourier = (out / "xmris_tpu_torch_ops_fourier.md").read_text()
        assert "fftshift" in fourier
        assert "Port of :mod:`xmris_tpu.ops.fourier`" in fourier
        widget = (out / "xmris_tpu_torch_visualization_widget.md").read_text()
        assert "Interactive widget layer" in widget

    def test_notebook_generation(self, tmp_path):
        out = _scripts.generate_test_notebooks(tmp_path / "nb")
        notebooks = sorted(out.glob("**/*.ipynb"))
        assert len(notebooks) > 25  # full docs catalog converted

        qs = next(p for p in notebooks if p.name == "quickstart.ipynb")
        nb = json.loads(qs.read_text())
        assert nb["nbformat"] == 4
        code_cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
        assert code_cells
        src = "".join("".join(c["source"]) for c in code_cells)
        assert "import xmris_tpu" in src

        pm = next(p for p in notebooks if p.name == "phase.ipynb")
        nb = json.loads(pm.read_text())
        first = "".join(
            next(c for c in nb["cells"] if c["cell_type"] == "code")["source"])
        ns: dict = {}
        exec(compile(first, "phase.ipynb", "exec"), ns)  # noqa: S102


def test_every_page_converts_as_the_reference_converts_it():
    pages = sorted((ROOT / "docs").glob("**/*.md"))
    assert pages
    assert _scripts.DOC_PYTHON_BLOCK_RE.pattern == jscripts.DOC_PYTHON_BLOCK_RE.pattern
    for md in pages:
        assert _scripts.markdown_to_notebook(md) == jscripts.markdown_to_notebook(md), md


def test_api_modules_are_the_references_counterparts():
    ref = {m.replace("xmris_tpu", "xmris_tpu_torch", 1)
           for m in jscripts._API_MODULES}
    kernels = {"xmris_tpu_torch.ops.kernels.dft_pallas",
               "xmris_tpu_torch.ops.kernels.lm_pallas"}
    ours = set(_scripts._API_MODULES)
    assert ours - ref == {"xmris_tpu_torch.ops.kernels.dft_cuda",
                          "xmris_tpu_torch.ops.kernels.lm_cuda",
                          "xmris_tpu_torch.ops.kernels.lm_jac_cuda",
                          "xmris_tpu_torch.ops.kernels.lm_loop_cuda"}
    assert ref - ours == kernels


def test_default_outputs_sit_beside_the_references(tmp_path, monkeypatch, capsys):
    (tmp_path / "docs" / "notebooks").mkdir(parents=True)
    (tmp_path / "docs" / "notebooks" / "p.md").write_text(
        "# P\n\n```python\nx = 1\n```\n")
    monkeypatch.setattr(_scripts, "REPO_ROOT", tmp_path)
    monkeypatch.setattr(_scripts, "_API_MODULES", ["xmris_tpu_torch.ops.fid"])
    _scripts.build_docs()
    assert (tmp_path / "docs" / "api_torch" / "xmris_tpu_torch_ops_fid.md").exists()
    nb = tmp_path / "tests" / "autogen_notebooks_torch" / "notebooks" / "p.ipynb"
    assert json.loads(nb.read_text())["cells"][1]["source"] == ["x = 1\n"]
    # The API pages are docs pages too, as in the JAX package's build.
    assert "3 notebooks written" in capsys.readouterr().out
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "docs/api_torch/" in ignored
    assert "tests/autogen_notebooks_torch/" in ignored


def test_run_tests_and_run_bench_commands(monkeypatch):
    calls = []
    monkeypatch.setattr(_scripts.subprocess, "call",
                        lambda cmd, cwd: calls.append((cmd, cwd)) or 0)
    assert _scripts.run_tests(["-k", "scripts"]) == 0
    cmd, cwd = calls[-1]
    files = [c for c in cmd if c.startswith("tests/")]
    assert cwd == ROOT and cmd[:3] == [sys.executable, "-m", "pytest"]
    assert files == sorted(str(p.relative_to(ROOT))
                           for p in (ROOT / "tests").glob("test_torch_*.py"))
    assert "tests/test_torch_scripts.py" in files and cmd[-2:] == ["-k", "scripts"]
    assert _scripts.run_bench() == 0
    assert calls[-1] == ([sys.executable, str(ROOT / "chip_smoke.py")], ROOT)


@pytest.mark.parametrize("argv,code", [(["bench"], 0), (["test", "-q"], 0),
                                       (["bogus"], 2)])
def test_main_dispatches(monkeypatch, capsys, argv, code):
    monkeypatch.setattr(_scripts.subprocess, "call", lambda cmd, cwd: 0)
    monkeypatch.setattr(sys, "argv", ["xmris_tpu_torch._scripts", *argv])
    with pytest.raises(SystemExit) as exc:
        _scripts.main()
    assert exc.value.code == code
