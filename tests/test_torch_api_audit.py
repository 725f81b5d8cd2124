"""API-surface audit of the PyTorch port against the JAX package.

AST-parses ``xmris_tpu``'s sources (the reference of the port) and holds
``xmris_tpu_torch`` to them:

1. every name in the ``__all__`` of the reference's top level, ``ops``,
   ``recon``, ``core``, ``fitting``, ``models``, ``vendor``,
   ``processing``, ``parallel``, ``runtime`` and ``utils`` exists at the
   same place in the port, and each function
   keeps every reference parameter name (the port may add its own, such
   as ``device``);
2. the port's top-level ``__all__`` is the reference's without the names
   whose modules are not ported yet, each listed with its ROADMAP.md queue
   1 item, and each of those raises ``NotImplementedError`` citing it;
3. every accessor and mixin class of ``core/accessor.py`` exists with the
   same methods and parameter names, and the carrier classes keep every
   public method (``.jax`` is ``.tensor`` in the port).
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

import xmris_tpu_torch

REF = Path(__file__).resolve().parents[1] / "xmris_tpu"

# Reference names whose modules wait for a ROADMAP.md queue 1 item.
PENDING = {
    "visualization": 13,
    "WaterfallConfig": 13,
    "CarpetConfig": 13,
    "PlotTrajectoryConfig": 13,
    "PlotQCGridConfig": 13,
}
# Carrier members renamed by design: the payload accessor.
CARRIER_RENAMED = {"jax": "tensor"}

PACKAGES = ["", "ops", "recon", "core", "fitting", "models", "vendor",
            "processing", "parallel", "runtime", "utils"]


def _init_path(sub):
    return REF / (f"{sub}/__init__.py" if sub else "__init__.py")


def _literal_all(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(el) for el in node.value.elts]
    raise AssertionError(f"{path} has no literal __all__")


def _params(fn):
    a = fn.args
    return [arg.arg for arg in a.posonlyargs + a.args + a.kwonlyargs
            if arg.arg not in ("self", "cls")]


def _module_functions(module_path):
    tree = ast.parse(module_path.read_text())
    return {n.name: _params(n) for n in tree.body if isinstance(n, ast.FunctionDef)}


def _ref_sources(sub):
    """name -> the reference module file its ``__init__`` imports it from."""
    tree = ast.parse(_init_path(sub).read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("xmris_tpu"):
            rel = node.module.split(".")[1:]
            path = REF.joinpath(*rel)
            path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
            for alias in node.names:
                out.setdefault(alias.asname or alias.name, path)
    return out


def _audit_cases():
    for sub in PACKAGES:
        sources = _ref_sources(sub)
        for name in _literal_all(_init_path(sub)):
            yield sub, name, sources.get(name)


@pytest.mark.parametrize("sub,name,source", list(_audit_cases()),
                         ids=lambda v: str(v) if not isinstance(v, Path) else "")
def test_reference_public_name_exists_with_its_parameters(sub, name, source):
    mod = importlib.import_module("xmris_tpu_torch" + (f".{sub}" if sub else ""))
    if not sub and name in PENDING:
        with pytest.raises(NotImplementedError, match=f"item {PENDING[name]}"):
            getattr(mod, name)
        return
    ours = getattr(mod, name)
    if source is None or inspect.ismodule(ours) or isinstance(ours, type) \
            or not callable(ours):
        return
    ref_params = _module_functions(source).get(name)
    if ref_params is None:  # re-exported through a package __init__
        return
    lost = [p for p in ref_params if p not in inspect.signature(ours).parameters]
    assert lost == [], f"{sub or 'top level'}.{name}: missing params {lost}"


def test_lazy_top_level_functions_keep_their_parameters():
    import xmris_tpu_torch as xt

    ref = _module_functions(REF / "fitting" / "amares.py")["fit_amares"]
    ours = inspect.signature(xt.fit_amares).parameters
    assert [p for p in ref if p not in ours] == []


def test_top_level_all_is_the_references_less_the_pending_names():
    ref_all = _literal_all(_init_path(""))
    assert set(PENDING) <= set(ref_all)
    assert sorted(xmris_tpu_torch.__all__) == sorted(
        n for n in ref_all if n not in PENDING)
    assert xmris_tpu_torch._PENDING == PENDING
    for sub in PACKAGES[1:]:
        mod = importlib.import_module(f"xmris_tpu_torch.{sub}")
        assert sorted(mod.__all__) == sorted(_literal_all(_init_path(sub))), sub


def _ref_classes(path):
    tree = ast.parse(path.read_text())
    classes = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes[node.name] = {
                item.name: _params(item) for item in node.body
                if isinstance(item, ast.FunctionDef)
                and (not item.name.startswith("_") or item.name == "_repr_html_")}
    return classes


@pytest.mark.parametrize("module,path", [
    ("xmris_tpu_torch.core.accessor", REF / "core" / "accessor.py"),
    ("xmris_tpu_torch.core.array", REF / "core" / "array.py"),
])
def test_classes_keep_their_methods_and_parameters(module, path):
    mod = importlib.import_module(module)
    problems = []
    for cls_name, methods in _ref_classes(path).items():
        ours_cls = getattr(mod, cls_name, None)
        if ours_cls is None:
            problems.append(f"class {cls_name} absent")
            continue
        for m_name, ref_params in methods.items():
            ours = getattr(ours_cls, CARRIER_RENAMED.get(m_name, m_name), None)
            if ours is None:
                problems.append(f"{cls_name}.{m_name} absent")
                continue
            if not callable(ours) or isinstance(ours, property):
                continue
            lost = [p for p in ref_params
                    if p not in inspect.signature(ours).parameters]
            if lost:
                problems.append(f"{cls_name}.{m_name}: missing params {lost}")
    assert problems == [], "\n".join(problems)


def test_accessor_methods_reachable_from_an_instance():
    import numpy as np

    from xmris_tpu_torch import XmrArray

    da = XmrArray(np.ones(8, complex), dims=("time",), coords={"time": np.arange(8.0)})
    ref = _ref_classes(REF / "core" / "accessor.py")
    wanted = sorted(m for cls in ("XmrisSpectrumCoordsMixin", "XmrisFourierMixin",
                                  "XmrisProcessingMixin", "XmrisPhasingMixin",
                                  "XmrisAccessor") for m in ref[cls])
    assert [m for m in wanted if not hasattr(da.xmr, m)] == []
