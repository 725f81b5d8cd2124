"""The benchmark of xmris_tpu_torch on one NVIDIA card: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds or loads the kernels, makes the
cell's pool of grids from the seed on the card, does the protocol's own
work and warms the cell's shapes with one request; then a closed loop (one
grid in flight, the next sent when the last one's result is back, cycling
through the pool) runs for ``--seconds``.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` splits the window into a profiled part
(CUDA activity: busy time, kernel records) and a part with synced spans
and kernel events, and prints its per-layer metrics.  Requests drawn from
the seed are then judged against the plain reference (``reference/``);
each number is printed beside its limit on standard error and under
``checks`` in the result, the last line of standard output.  Without a
card the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, roofline  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

PROFILE_SHARE = 0.25  # of a traced window, the profiled part
PROFILE_MAX_S = 10.0  # at most, so that reading its events stays short
PROFILE_SETTLE_S = 0.5  # between the profile's start and its first request


def _power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _kernel_metrics(cell):
    """{slot: work function} of the cell's kernel metrics."""
    out = {}
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        if mod.KIND == "kernel":
            out[mod.SLOT] = getattr(roofline, mod.WORK)
    return out


def _profiled_slots(cell):
    """The slots of the cell's kernel metrics that name their kernel
    (``KERNEL``), timed from the profile's records."""
    return {mod.SLOT for mod in map(harness.metric_module,
                                    (m["name"] for m in cell.per_layer))
            if mod.KIND == "kernel" and getattr(mod, "KERNEL", None)}


def _span_targets(cell):
    targets = []
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        if mod.KIND == "span":
            targets += [t for t in mod.WRAPS if t not in targets]
    return targets


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        kernels=None, t_start=T_START):
    """One run of ``cell``; returns the result's dict (``checks`` last).  On
    a CPU ``device`` it rehearses the control flow and reports no metric."""
    import torch

    from xmris_tpu_torch.ops import kernels as K

    on_card = torch.device(device).type == "cuda"
    trace = bool(trace) and on_card
    build_s = None
    if on_card:
        K._build.library()
        build_s = K._build.build_seconds or 0.0
    pool = generator.make_pool(cell.config, cell.mix, seed, device)
    entry = harness.entry_module(cell)
    base = kernels or K.DISPATCH
    events = harness.KernelEvents()
    slots = _kernel_metrics(cell) if trace else {}
    profiled = _profiled_slots(cell) if trace else set()
    kset = dataclasses.replace(base, **{s: events.wrap(s, getattr(base, s), w,
                                                       s in profiled)
                                        for s, w in slots.items()})
    state = entry.setup(harness.context(cell, device, kset, pool))
    entry.request(state, pool[0])
    _sync(device)
    voxels = math.prod(cell.config["grid"])
    setup_s = time.perf_counter() - t_start
    n_samples = int(cell.workload["check"]["sample_requests"])
    metrics, dev_extra, breakdown = {}, {}, None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if not trace:
        sampler = harness.Sampler(seed, n_samples, seconds, entry)
        loop = harness.closed_loop(entry, state, pool, seconds, 1, voxels, sampler,
                                   lambda: _sync(device))
        attempted, failed = loop.attempted, loop.failed
        print(f"ms per pool grid: {harness.per_grid_ms(loop)}; by thirds of the "
              f"window: {harness.thirds_ms(loop)}", file=sys.stderr)
        if on_card:
            metrics = {
                "setup_s": {"value": setup_s, "unit": "s"},
                "voxels_per_s": {"value": loop.completed_voxels / loop.elapsed,
                                 "unit": "voxels/s"},
                "grid_ms_p95": {"value": 1e3 * harness.p95(loop.latencies), "unit": "ms"},
                "peak_mem_gib": {"value": torch.cuda.max_memory_allocated() / 2**30,
                                 "unit": "GiB"},
            }
    else:
        from torch.profiler import ProfilerActivity, profile

        targets = _span_targets(cell)
        t_prof = min(PROFILE_SHARE * seconds, PROFILE_MAX_S)
        events.part = "profiled"
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # CUPTI now and then drops the first few kernels launched right
            # after the trace starts; let it settle before the first request.
            _sync(device)
            time.sleep(PROFILE_SETTLE_S)
            loop_a = harness.closed_loop(entry, state, pool, t_prof, 1, voxels,
                                         lambda *a: None, lambda: _sync(device))
        events.part = None
        busy_s, n_kernels, records, ops, gaps = harness.read_profile(prof)
        del prof
        spans = harness.Spans()
        sampler = harness.Sampler(seed, n_samples, seconds - t_prof, entry)
        events.part = "synced"
        with harness.patched(targets, spans.make):
            loop_b = harness.closed_loop(entry, state, pool, seconds - t_prof,
                                         1 + loop_a.attempted, voxels, sampler,
                                         lambda: _sync(device))
        events.part = None
        attempted = loop_a.attempted + loop_b.attempted
        failed = loop_a.failed + loop_b.failed
        tr = harness.Trace(spans.seconds, loop_b.attempted, events, busy_s,
                           loop_a.elapsed, n_kernels, loop_a.attempted, records)
        for m in cell.per_layer:
            value = harness.metric_module(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": busy_s, "window_s": loop_a.elapsed}
        breakdown = {"device_ops": ops, "idle_gaps": gaps}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del state
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = harness.judge_samples(cell, sampler.records(), seed)
    # Last, so that nothing the window or the comparison loaded escapes it.
    found = harness.banned_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: no result")
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu (rehearsal)",
        "count": 1 if on_card else 0,
        "memory_peak_bytes": int(peak),
        **dev_extra,
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["build_s"] = build_s
    result["power"] = _power_limit() if on_card else None
    result["checks"] = {k: {n: (v if math.isfinite(v) else 1e300) for n, v in c.items()}
                        for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("benchmark: torch is not installed", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import xmris_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the program is missing ({exc})", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    print(f"card: {result['power']}; nvcc {result['build_s']} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
