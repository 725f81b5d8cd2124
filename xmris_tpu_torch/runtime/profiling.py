"""Per-stage timing and tracing (PyTorch port of
:mod:`xmris_tpu.runtime.profiling`).

``stage_timer`` records wall times per pipeline stage, synchronizing the
card first so that a stage's time includes its device work; ``trace``
records a ``torch.profiler`` trace (host and CUDA activity) as a Chrome
trace file, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class Timings:
    """Accumulated stage timings in seconds."""

    stages: dict[str, float] = field(default_factory=dict)

    def record(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> str:
        width = max((len(k) for k in self.stages), default=0)
        lines = [f"  {k:<{width}} : {v * 1e3:9.3f} ms" for k, v in self.stages.items()]
        lines.append(f"  {'TOTAL':<{width}} : {self.total() * 1e3:9.3f} ms")
        return "\n".join(lines)


def _wait_for(results) -> None:
    """Synchronize the device of every CUDA tensor in ``results`` (the
    reference's ``block_until_ready``); objects with a
    ``block_until_ready`` method (the labeled carrier) wait through it."""
    devices = set()
    for obj in results:
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda:
                devices.add(obj.device)
        elif hasattr(obj, "block_until_ready"):
            obj.block_until_ready()
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage_timer(timings: Timings, name: str, *sync_arrays):
    """Time a pipeline stage; before reading the clock, wait for the
    devices of the tensors given (``sync_arrays``)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _wait_for(sync_arrays)
        timings.record(name, time.perf_counter() - start)


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where a card is present) and write it as a Chrome trace,
    ``trace_<pid>_<ns>.json``, under ``log_dir`` (default: a directory in
    the system's temporary directory).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir if log_dir is not None
                   else Path(tempfile.gettempdir()) / "xmris_tpu_torch_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))
