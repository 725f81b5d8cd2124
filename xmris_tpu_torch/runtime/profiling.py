"""Per-stage timing and tracing (PyTorch port of
:mod:`xmris_tpu.runtime.profiling`).

``stage_timer`` records wall times per pipeline stage, synchronizing the
card first so that a stage's time includes its device work; ``trace``
records a ``torch.profiler`` trace (host and CUDA activity) as a Chrome
trace file, viewable in Perfetto or ``chrome://tracing``.

The program's own spans and counters (:func:`span`, :func:`spanned`,
:func:`count`, and the copy helpers :func:`to_host` and :func:`to_card` at
the request path's host/card boundary) record only while a
``torch.profiler`` session is active or inside :func:`recording`; otherwise
they cost a global read or two and never synchronize.  :func:`snapshot`
returns what they recorded.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# The recorder: spans and counters inside the program
# ---------------------------------------------------------------------------


class Recorder:
    """Per-name span totals and counters, shared by every thread.

    A span adds its host time, its self time (less the time its child spans
    cover on the same thread) and, where it ran on a CUDA stream, the card
    time between two events recorded at its edges; the events are read
    without blocking as later spans end, and the rest at :meth:`snapshot`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list] = {}  # device index -> spare event pairs
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: dict[str, list] = {}  # [calls, host_ns, self_ns, card_ms, card_calls]
            self._counters: dict[str, int] = {}
            self._pending: collections.deque = collections.deque()
            self._seq = 0

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def events(self):
        """``(device index, (start, end))``: timing events for the current
        CUDA stream, or None where CUDA is not in use or the stream is
        capturing a graph."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        dev = torch.cuda.current_device()
        with self._lock:
            spare = self._free.setdefault(dev, [])
            pair = spare.pop() if spare else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        return dev, pair

    def add_span(self, name: str, host_ns: int, self_ns: int, events) -> None:
        with self._lock:
            tot = self._spans.get(name)
            if tot is None:
                tot = self._spans[name] = [0, 0, 0, 0.0, 0]
            tot[0] += 1
            tot[1] += host_ns
            tot[2] += self_ns
            if events is not None:
                self._pending.append((tot, events))
            self._resolve(block=False)

    def _resolve(self, block: bool) -> None:
        """Add the card time of finished event pairs, in the order the
        spans ended; with ``block``, wait for every pair (under the lock)."""
        while self._pending:
            tot, (dev, (start, end)) = self._pending[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            tot[3] += start.elapsed_time(end)
            tot[4] += 1
            self._free.setdefault(dev, []).append((start, end))

    def snapshot(self) -> dict:
        """``{"spans": {name: {calls, host_ms, self_host_ms, card_ms}},
        "counters": {name: n}}``; ``card_ms`` is None for a span that never
        ran on a CUDA stream."""
        with self._lock:
            self._resolve(block=True)
            spans = {
                name: {"calls": calls, "host_ms": host / 1e6,
                       "self_host_ms": own / 1e6,
                       "card_ms": card if n_card else None}
                for name, (calls, host, own, card, n_card) in self._spans.items()
            }
            return {"spans": spans, "counters": dict(self._counters)}


RECORDER = Recorder()
_recording = 0  # open recording() blocks
_recording_lock = threading.Lock()
_state = threading.local()  # .stack: the thread's open spans


def _on() -> bool:
    return bool(_recording) or _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "seq", "child_ns", "t0", "events", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        self.seq = stack[-1].seq if stack else RECORDER.next_seq()
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name, str(self.seq))
            self.range.__enter__()
        self.events = RECORDER.events()
        if self.events is not None:
            self.events[1][0].record()
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1][1].record()
        stack = _state.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += host_ns
        if self.range is not None:
            self.range.__exit__(*exc)
        RECORDER.add_span(self.name, host_ns, host_ns - self.child_ns, self.events)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as span ``name`` while
    recording (a ``torch.profiler`` range too under a profiler, so that the
    span sits on the trace's timeline; the outermost span's sequence number
    is the range's ``args`` for it and every span nested in it); otherwise
    one shared no-op context."""
    return _Span(name) if _on() else _OFF


def spanned(name: str):
    """Decorate a function so that each call's body is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _on():
        RECORDER.count(name, n)


def to_host(t: torch.Tensor):
    """``t.cpu()``, or a Python number (a bool for a flag) for a 0-dim
    ``t``: a host read that waits for the card.  While recording it counts
    ``host.syncs`` and ``host.d2h_bytes`` and times the wait as span
    ``host.wait``."""
    if not _on():
        return t.item() if t.ndim == 0 else t.cpu()
    with _Span("host.wait"):
        out = t.item() if t.ndim == 0 else t.cpu()
    RECORDER.count("host.syncs", 1)
    RECORDER.count("host.d2h_bytes", t.numel() * t.element_size())
    return out


def to_card(a, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)``; while recording, the bytes
    of an array, or of a tensor from another device, count as
    ``host.h2d_bytes``."""
    out = torch.as_tensor(a, device=device)
    if _on() and (not isinstance(a, torch.Tensor) or a.device != out.device):
        RECORDER.count("host.h2d_bytes", out.numel() * out.element_size())
    return out


@contextlib.contextmanager
def recording():
    """Record spans and counters in the block, with or without a profiler;
    resets the recorder first and yields it."""
    global _recording
    RECORDER.reset()
    with _recording_lock:
        _recording += 1
    try:
        yield RECORDER
    finally:
        with _recording_lock:
            _recording -= 1


def snapshot() -> dict:
    """What the recorder holds (:meth:`Recorder.snapshot`)."""
    return RECORDER.snapshot()
