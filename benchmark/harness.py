"""The harness: finds a cell's files by name, runs its closed loop, reads
the traced run's spans, kernel events and profile, and judges the sampled
requests.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric lives in a file of its own (``configs/``, ``traffic/``,
``entries/``, ``metrics/``), found by the names in ``BENCHMARK.json`` and
in the cell's ``workloads/<cell>.json``; this module holds nothing of any
one cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import re
import statistics
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "xmris_tpu")


# ---------------------------------------------------------------------------
# Finding a cell's files
# ---------------------------------------------------------------------------


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict  # workloads/<name>.json
    config: dict  # the config's file
    mix: dict  # traffic/<traffic>.json
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, man: dict | None = None) -> Cell:
    """The cell ``name`` with its files, and the metrics it reports."""
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(entry["chips"]), wl, config, mix, e2e, per_layer)


def entry_module(cell: Cell):
    return importlib.import_module(f"benchmark.entries.{cell.workload['entry']}")


def metric_module(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`BANNED`,
    compared as whole names."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in BANNED})


# ---------------------------------------------------------------------------
# Trace instruments
# ---------------------------------------------------------------------------


def _resolve(target: str):
    mod_name, attr = target.split(":")
    return importlib.import_module(mod_name), attr


@contextlib.contextmanager
def patched(targets, make):
    """Replace each ``module:attr`` of ``targets`` by ``make(target, fn)``
    for the block."""
    saved = []
    try:
        for target in targets:
            mod, attr = _resolve(target)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, make(target, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


class Spans:
    """Synced spans: the card is synchronised before and after each call,
    and the host clock read between; seconds summed per target."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def make(self, target, fn):
        import torch

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[target] = (self.seconds.get(target, 0.0)
                                        + time.perf_counter() - t0)
        return wrapped


class KernelEvents:
    """The calls of the ``KernelSet`` slots that kernel metrics read.  In
    the profiled part (``part == "profiled"``) a slot whose metric names
    its kernel keeps the work of each call, counted from shapes alone, no
    operation on the card; the profile's records of that kernel give the
    time.  In the synced part (``part == "synced"``) every such slot has
    CUDA events around each call, kept with the call's work."""

    def __init__(self):
        self.calls: dict[str, list] = {}  # synced part: (event, event, work)
        self.work: dict[str, list] = {}  # profiled part: (bytes, operations)
        self.part = None

    def wrap(self, slot, fn, work, profiled=False):
        import torch

        def wrapped(*args, **kwargs):
            if self.part == "profiled" and profiled:
                out = fn(*args, **kwargs)
                self.work.setdefault(slot, []).append(work(args, kwargs, out))
                return out
            if self.part != "synced":
                return fn(*args, **kwargs)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.calls.setdefault(slot, []).append((a, b, work(args, kwargs, out)))
            return out
        return wrapped

    def totals(self, slot):
        """(least seconds the card could take, seconds measured) over the
        slot's calls in the synced part."""
        from benchmark import roofline

        least = measured = 0.0
        for a, b, (nbytes, flops) in self.calls.get(slot, ()):
            least += roofline.least_seconds(float(nbytes), float(flops))
            measured += a.elapsed_time(b) / 1e3
        return least, measured


@dataclasses.dataclass
class Trace:
    """What a traced run read, for the metric readers."""

    span_seconds: dict
    span_requests: int
    kernels: KernelEvents
    busy_s: float | None = None
    window_s: float | None = None
    device_kernels: int | None = None
    profile_requests: int = 0
    kernel_records: dict = dataclasses.field(default_factory=dict)

    def span_ms(self, targets):
        if not self.span_requests or not any(t in self.span_seconds for t in targets):
            return None
        return 1e3 * sum(self.span_seconds.get(t, 0.0) for t in targets) / self.span_requests

    def roofline_pct(self, slot, kernel=None):
        """The least time of the slot's calls over their measured time, in
        %.  With ``kernel``, a regular expression on the profile's kernel
        names: the profiled part's records of that kernel, one a call that
        launches (a call with no bytes launches none).  Where CUPTI lost a
        record or a few (at most one, or 1 % of the calls) the time of the
        rest stands for them at its mean; more lost, or more records than
        calls (the kernel launched from outside the slot), reads nothing.  Without
        ``kernel``: CUDA events around the synced part's calls, which take
        in the call's host work while the card waits."""
        from benchmark import roofline

        least, measured = self.kernels.totals(slot)
        bracket = 100.0 * least / measured if measured > 0 else None
        if kernel is None:
            return bracket
        pat = re.compile(kernel)
        hits = [v for name, v in self.kernel_records.items() if pat.search(name)]
        n = sum(h[0] for h in hits)
        seconds = sum(h[1] for h in hits)
        works = [w for w in self.kernels.work.get(slot, ()) if float(w[0]) > 0]
        least = sum(roofline.least_seconds(float(b), float(f)) for b, f in works)
        lost = len(works) - n
        pct = (100.0 * least * n / (len(works) * seconds)
               if works and 0 <= lost <= max(1, 0.01 * len(works)) and seconds > 0
               else None)
        print(f"kernel {slot}: {n} records of /{kernel}/ for {len(works)} calls, "
              f"{pct} % of the roofline; {bracket} % by events around the calls",
              file=sys.stderr)
        return pct

    def idle_pct(self):
        if not self.window_s or self.busy_s is None:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels_per_request(self):
        if not self.profile_requests or self.device_kernels is None:
            return None
        return self.device_kernels / self.profile_requests


def _union(intervals):
    total, end = 0, None
    out = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            out.append([s, e])
            end = e
        elif e > end:
            out[-1][1] = e
            end = e
    for s, e in out:
        total += e - s
    return total, out


def read_profile(prof):
    """Device busy seconds (the union of CUDA activity), the kernel count,
    ``{name: (records, seconds)}`` of the device operations, the top
    device operations by time, and the longest gaps between device
    activity, each labelled by the CUDA runtime call the host was in at
    its middle ("host" where it was in none: Python, numpy, the
    allocator).  The profile records CUDA activity only, so that its cost
    to the host stays small."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy_ns, merged = _union([(s, e) for s, e, _ in dev])
    kernels = sum(1 for _, _, n in dev if not n.startswith(("Memcpy", "Memset")))
    by_name: dict[str, list] = {}
    for s, e, n in dev:
        rec = by_name.setdefault(n, [0, 0])
        rec[0] += 1
        rec[1] += e - s
    top = sorted(((n, ns) for n, (_, ns) in by_name.items()), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    idle = []
    for s, e in gaps:
        mid = (s + e) // 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "host"
        idle.append([label[:120], (e - s) / 1e9])
    records = {n: (c, ns / 1e9) for n, (c, ns) in by_name.items()}
    return (busy_ns / 1e9, kernels, records, [[n[:120], v / 1e9] for n, v in top],
            idle)


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Loop:
    latencies: list
    grids: list = dataclasses.field(default_factory=list)  # pool index of each
    attempted: int = 0
    failed: int = 0
    completed_voxels: int = 0
    elapsed: float = 0.0


def closed_loop(entry, state, pool, seconds, first, voxels, keep, sync):
    """One request in flight, the next sent when the last one's result is
    back, cycling through the pool from grid ``first``.  ``keep(i, t_end,
    grid, out)`` may copy a request's outputs to the host for the check; the
    window's clock stops while it does, and a request's outputs are dropped
    before the next is sent, so that neither the copy's time nor the held
    outputs count as the program's."""
    loop = Loop([])
    i = first
    paused = 0.0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - t_start - paused >= seconds:
            break
        grid = pool[i % len(pool)]
        loop.attempted += 1
        try:
            out = entry.request(state, grid)
        except Exception as exc:  # a request that raises counts as failed
            print(f"request {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        loop.latencies.append(t1 - t0)
        loop.grids.append(i % len(pool))
        if out is None or entry.failed(out):
            loop.failed += 1
        else:
            loop.completed_voxels += voxels
            keep(i, t1 - t_start - paused, grid, out)
            paused += time.perf_counter() - t1
        out = None
        i += 1
    sync()
    loop.elapsed = time.perf_counter() - t_start - paused
    return loop


def per_grid_ms(loop):
    """Mean latency (ms) of each pool grid's requests, a diagnostic."""
    out = {}
    for g, v in zip(loop.grids, loop.latencies):
        out.setdefault(g, []).append(v)
    return {g: round(1e3 * sum(v) / len(v), 3) for g, v in sorted(out.items())}


def thirds_ms(loop):
    """Mean latency (ms) in each third of the window's requests, a
    diagnostic of drift."""
    n = len(loop.latencies)
    cuts = [0, n // 3, 2 * n // 3, n]
    return [round(1e3 * sum(loop.latencies[a:b]) / max(b - a, 1), 3)
            for a, b in zip(cuts, cuts[1:])]


def p95(values):
    """The 95th percentile of the window's request latencies (the
    ``statistics`` inclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def _map_tensors(obj, fn):
    """``obj`` (dicts, tuples, lists) with ``fn`` applied to each tensor."""
    import torch

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class Sampler:
    """Holds the outputs of requests drawn from the seed: the request in
    flight at each of ``n`` instants drawn uniformly from the window's
    5-90 % (a request that fails gives its instant to the next).  The
    outputs are copied to the host, so that the card's peak over the window
    is the program's; the pool grid a record names stays where it is."""

    def __init__(self, seed, n, seconds, entry):
        rng = np.random.default_rng([int(seed), 11])
        self.at = sorted(rng.uniform(0.05, 0.9, size=int(n)) * seconds)
        self.entry = entry
        self.kept = []

    def __call__(self, i, t_end, grid, out):
        while self.at and t_end >= self.at[0]:
            self.at.pop(0)
            if not self.kept or self.kept[-1][0] != i:
                rec = self.entry.record(grid, out)
                rest = {k: v for k, v in rec.items() if k != "inputs"}
                self.kept.append((i, {"inputs": rec["inputs"],
                                      **_map_tensors(rest, lambda t: t.cpu())}))

    def records(self):
        return [r for _, r in self.kept]


def on_inputs_device(rec):
    """``rec`` with its outputs moved back to the device of its inputs."""
    import torch

    dev = next(v.device for v in rec["inputs"].values() if isinstance(v, torch.Tensor))
    return _map_tensors(rec, lambda t: t.to(dev))


def judge_samples(cell, records, seed):
    """The comparison's numbers over the sampled requests, and ``correct``."""
    from benchmark.reference import check

    params = cell.workload["check"]
    nums = check.merge([check.judge(on_inputs_device(r), cell.config, params, seed, j)
                        for j, r in enumerate(records)])
    limits = params["limits"]
    missing = sorted(set(nums) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in workloads/{cell.name}.json")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = bool(records) and all(
        math.isfinite(v) and v <= limits[k] for k, v in nums.items())
    return correct, checks


def context(cell, device, kernels, pool):
    return types.SimpleNamespace(config=cell.config, mix=cell.mix, device=device,
                                 kernels=kernels, pool=pool)
