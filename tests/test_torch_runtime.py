"""The port's runtime layer (``xmris_tpu_torch.runtime``, ``.utils``) against
the JAX package's, and the thread safety the voxel mesh needs: the launch
counters and the kernel build are taken from several threads at once.
"""

import dataclasses
import json
import logging
import sys
import threading

import numpy as np
import pytest
import torch

from xmris_tpu.runtime.config import RuntimeConfig as RefRuntimeConfig
from xmris_tpu.runtime.config import matching_dtypes as ref_matching_dtypes

import xmris_tpu_torch
from xmris_tpu_torch import utils
from xmris_tpu_torch.ops.kernels import _build, _counters
from xmris_tpu_torch.runtime import (
    RuntimeConfig,
    Timings,
    config,
    default_complex_dtype,
    default_float_dtype,
    stage_timer,
    trace,
)
from xmris_tpu_torch.runtime.config import matching_dtypes
from xmris_tpu_torch.runtime.logging import get_logger, set_log_level


def test_stage_timer_records_and_reports():
    t = Timings()
    with stage_timer(t, "fft"):
        torch.fft.fft(torch.ones(128, dtype=torch.complex128))
    with stage_timer(t, "fft"):
        pass
    assert t.stages["fft"] > 0 and t.total() == t.stages["fft"]
    report = t.report()
    assert "fft" in report and "TOTAL" in report


def test_stage_timer_waits_for_what_it_is_given():
    """Tensors' devices are synchronized (none on the CPU) and objects with
    ``block_until_ready`` (the labeled carrier) wait through it."""
    calls = []

    class Carrier:
        def block_until_ready(self):
            calls.append("waited")
            return self

    t = Timings()
    with stage_timer(t, "mul", torch.ones(4) * 2, Carrier(), "not an array"):
        pass
    assert calls == ["waited"] and t.stages["mul"] > 0


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32,
                                   np.float64])
def test_matching_dtypes_match_the_reference(dtype):
    assert matching_dtypes(dtype) == ref_matching_dtypes(dtype)
    as_torch = torch.from_numpy(np.zeros(1, dtype)).dtype
    assert matching_dtypes(as_torch) == ref_matching_dtypes(dtype)


def test_runtime_config_defaults_and_preferred_float(monkeypatch):
    assert config.preferred_float == RefRuntimeConfig().preferred_float
    assert config.x64_enabled
    # No interpret_pallas counterpart: the tensors' device picks the plain
    # versions, and a field the class lacks raises instead of doing nothing.
    assert [f.name for f in dataclasses.fields(RuntimeConfig)] == ["preferred_float"]
    with pytest.raises(AttributeError):
        config.interpret_pallas = True
    assert (default_float_dtype(), default_complex_dtype()) == (
        np.dtype(np.float32), np.dtype(np.complex64))
    # The reference needs jax_enable_x64 for float64; PyTorch always has it.
    monkeypatch.setattr(config, "preferred_float", "float64")
    assert (default_float_dtype(), default_complex_dtype()) == (
        np.dtype(np.float64), np.dtype(np.complex128))
    assert RuntimeConfig(preferred_float="float64").preferred_float == "float64"


def test_logging_namespace_and_levels():
    assert get_logger().name == "xmris_tpu_torch"
    assert get_logger("xmris_tpu_torch.fit").parent is get_logger()
    logger = get_logger()
    before = (logger.level, list(logger.handlers))
    try:
        set_log_level("info", verbose=False)
        assert logger.level == logging.INFO and len(logger.handlers) == 1
        set_log_level(logging.ERROR, verbose=False)
        assert logger.level == logging.ERROR and len(logger.handlers) == 1
    finally:
        logger.setLevel(before[0])
        logger.handlers[:] = before[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "tr") as log_dir:
        torch.ones(64).cumsum(0)
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)


def test_utils_re_exports_the_runtime_layer():
    assert utils.stage_timer is stage_timer and utils.config is config
    assert utils.get_logger is get_logger
    assert xmris_tpu_torch.runtime.RuntimeConfig is RuntimeConfig


def test_launch_counters_are_exact_from_eight_threads():
    """Eight threads, each counting 2000 launches and plain calls, with a
    short switch interval: the totals lose nothing."""
    _counters.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _counters.launched("spectrum")
                _counters.plain_called("acme_polish")

        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    counts = _counters.snapshot()
    assert counts["launches"]["spectrum"] == 16000
    assert counts["plain_calls"]["acme_polish"] == 16000
    _counters.reset()
    assert not any(_counters.snapshot()["launches"].values())


def test_kernel_libraries_build_once_from_eight_threads(monkeypatch):
    """Concurrent first calls of ``library()`` build and load once; every
    caller gets the same entries."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)
        _build._lib = object()
        return _build._lib

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_build_and_load", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(builds) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)
