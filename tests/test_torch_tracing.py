"""The port's spans and counters (``runtime/profiling.py``): off by default,
on inside ``recording()`` or a ``torch.profiler`` session, exact under
threads, invisible in the outputs, and opened by the benchmark's cells
where its metric files read them."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.fitting import amares as tam
from xmris_tpu_torch.fitting import lm as tlm
from xmris_tpu_torch.fitting.lm import hashable_pmap
from xmris_tpu_torch.fitting.prior import prior_from_csv_text
from xmris_tpu_torch.ops import kernels as K
from xmris_tpu_torch.runtime import profiling as P

from _torch_parity import BENCH_PK_CSV, MHZ, bench_phantom

ROOT = Path(__file__).resolve().parents[1]


def _spans(snap, prefix=""):
    return {n: s for n, s in snap["spans"].items() if n.startswith(prefix)}


def test_off_span_is_one_shared_noop_and_records_nothing():
    before = P.snapshot()
    assert P.span("a") is P.span("b")
    with P.span("a"):
        P.count("c", 5)
        flag = P.to_host(torch.tensor(True))
        host = P.to_host(torch.arange(4))
        card = P.to_card(np.ones(3), "cpu")
    assert flag is True and torch.equal(host, torch.arange(4))
    assert torch.equal(card, torch.ones(3, dtype=torch.float64))
    assert P.snapshot() == before


def test_recording_nests_spans_times_self_and_counts():
    with P.recording() as rec:
        for _ in range(2):
            with P.span("outer"):
                time.sleep(0.01)
                with P.span("inner"):
                    time.sleep(0.02)
                P.count("c")
                P.count("c", 4)
        flag = P.to_host(torch.tensor([1.0, 2.0]).sum() > 2)
        value = P.to_host(torch.tensor(2.5, dtype=torch.float32))
        host = P.to_host(torch.zeros(3, 5))
        card = P.to_card(np.zeros((2, 4), np.float32), "cpu")
        again = P.to_card(card, "cpu")  # already there: no copy counted
    snap = rec.snapshot()
    assert rec is P.RECORDER and P.snapshot() == snap
    assert flag is True and value == 2.5 and isinstance(value, float)
    assert host.shape == (3, 5) and again is card
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["calls"] == inner["calls"] == 2
    assert inner["host_ms"] >= 40.0 and outer["host_ms"] >= 60.0
    assert inner["self_host_ms"] == inner["host_ms"]
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"], abs=1e-6)
    assert outer["card_ms"] is None  # no CUDA stream on the CPU
    assert snap["spans"]["host.wait"]["calls"] == 3
    assert snap["counters"] == {"c": 10, "host.syncs": 3,
                                "host.d2h_bytes": 1 + 4 + 60,
                                "host.h2d_bytes": 32}
    with P.recording() as rec:  # a new block starts from nothing
        pass
    assert rec.snapshot() == {"spans": {}, "counters": {}}


def test_recording_is_exact_from_eight_threads():
    n_threads, n_iter = 8, 300
    errors = []

    def work():
        try:
            for _ in range(n_iter):
                with P.span("t.outer"):
                    with P.span("t.inner"):
                        P.count("t.n")
                    P.count("t.n", 2)
        except Exception as exc:  # surfaced by the assertion below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    snap = rec.snapshot()
    total = n_threads * n_iter
    assert snap["counters"] == {"t.n": 3 * total}
    outer, inner = snap["spans"]["t.outer"], snap["spans"]["t.inner"]
    assert outer["calls"] == inner["calls"] == total
    # Each thread nests its own spans: the outer self time is what the
    # inner spans of the same thread leave.
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"], abs=1e-6)


def test_a_profiler_session_records_spans_as_ranges():
    from torch.profiler import ProfilerActivity, profile

    P.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("prof.outer"):
            with P.span("prof.inner"):
                torch.ones(8).sum()
            P.count("prof.n")
    snap = P.snapshot()
    assert set(_spans(snap, "prof.")) == {"prof.outer", "prof.inner"}
    assert snap["counters"] == {"prof.n": 1}
    names = [e.name for e in prof.events()]
    assert "prof.outer" in names and "prof.inner" in names
    with P.span("prof.after"):
        pass
    assert "prof.after" not in P.snapshot()["spans"]


def _grid_inputs(**phantom):
    pk = prior_from_csv_text(BENCH_PK_CSV, "bench")
    fids, t, _ = bench_phantom(**{"n_voxels": 8, **phantom})

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32))

    args = (f32(fids.real), f32(fids.imag), f32(t), f32(pk.init_free),
            f32(pk.lower), f32(pk.upper),
            torch.as_tensor(np.asarray(pk.kind, np.int32)))
    amp_slots, ls_plan = tam.seed_plan(pk)
    kw = dict(pmap_static=hashable_pmap(pk.pmap), mhz=MHZ, amp_slots=amp_slots,
              ls_plan=ls_plan, uniform_t_ok=True)
    return pk, fids, t, args, kw


def test_grid_fit_is_bit_identical_and_counts_its_trips():
    _, _, _, args, kw = _grid_inputs()
    off = tam.seeded_fit_grid_raw(*args, **kw)
    K.reset_counters()
    with P.recording() as rec:
        on = tam.seeded_fit_grid_raw(*args, **kw)
    trips = K.counters()["plain_calls"]["spd_solve_damped"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    snap = rec.snapshot()
    assert 0 < trips == snap["counters"]["lm.iterations"]
    assert snap["counters"]["host.syncs"] >= trips
    assert set(_spans(snap, "fit")) == {"fit", "fit.seed", "fit.lm", "fit.crlb"}
    assert snap["spans"]["fit.crlb"]["calls"] == snap["spans"]["fit"]["calls"] == 1
    assert snap["spans"]["fit"]["host_ms"] >= snap["spans"]["fit.lm"]["host_ms"]


def test_fit_amares_is_bit_identical_and_counts_its_trips(monkeypatch):
    # The bench's 1024-point FIDs: the grid then outweighs the fixed
    # per-call copies (time axis, bounds, seeds and maps) as on the card.
    pk, fids, t, _, _ = _grid_inputs(n_voxels=16, n_t=1024)
    da = XmrArray(torch.as_tensor(fids), dims=("voxel", "time"),
                  coords={"time": Coord("time", t.astype(np.float64))},
                  attrs={"MHz": MHZ})

    def fit():
        return tam.fit_amares(da, pk, engine="pallas", device="cpu",
                              return_curves=False)

    off = fit()
    planar = {"trips": 0}
    jacobian = tlm.eq6_jacobian_planar

    def counting(*a, **k):  # one call a trip of the planar (template) loop
        planar["trips"] += 1
        return jacobian(*a, **k)

    monkeypatch.setattr(tlm, "eq6_jacobian_planar", counting)
    K.reset_counters()
    with P.recording() as rec:
        on = fit()
    trips = K.counters()["plain_calls"]["spd_solve_damped"] + planar["trips"]
    for name in off.data_vars:
        np.testing.assert_array_equal(on[name].values, off[name].values)
    snap = rec.snapshot()
    assert planar["trips"] > 0 and trips == snap["counters"]["lm.iterations"]
    # Besides one read a trip, six: the template scan's index and SNR, the
    # template fit's optimum with its flag, the read that ends each of the
    # three LM loops (template, first and refinement pass), and the pack's
    # one read of x, the flags, the CRLB SDs and sigma^2.
    assert snap["counters"]["host.syncs"] - trips == 1 + 1 + 3 + 1
    # The tensor payload is split where it lies: without curves the grid
    # crosses neither way, and the call counts as resident.
    copies = (snap["counters"].get("host.d2h_bytes", 0)
              + snap["counters"].get("host.h2d_bytes", 0))
    assert copies < fids.nbytes / 4
    assert snap["counters"]["fit_amares.resident"] == 1
    assert list(_spans(snap, "fit_amares.")) == [
        "fit_amares.ingest", "fit_amares.seed", "fit_amares.fit",
        "fit_amares.crlb_model", "fit_amares.pack"]
    assert snap["spans"]["fit_amares"]["calls"] == 1


REHEARSE = r"""
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/benchmark/tests"]
from conftest import tiny_cell
from benchmark import harness
from benchmark import run as brun
from xmris_tpu_torch.runtime import profiling

tiny = tiny_cell({cell!r})
with profiling.recording() as rec:
    res = brun.run(tiny, 2**31 + 29, 1.0, False, device="cpu")
snap = rec.snapshot()
reads = {{}}
for m in tiny.per_layer:
    mod = harness.metric_module(m["name"])
    names = [getattr(mod, "SPAN", None), getattr(mod, "COUNTER", None),
             *getattr(mod, "COUNTERS", ())]
    if any(names):
        reads[m["name"]] = [n for n in names if n]
print(json.dumps({{"correct": res["correct"], "attempted": res["attempted"],
                  "spans": sorted(snap["spans"]), "counters": snap["counters"],
                  "reads": reads}}))
"""


def _manifest_cells():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _program_metrics(cell):
    """How many of the cell's per-layer metrics in ``BENCHMARK.json`` read
    the program's own spans and counters: a ``program_span`` or
    ``program_counter`` source, read from the recorder (``KIND``
    ``profile``; the ``span`` ones wrap program functions from outside)."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark import harness
    finally:
        sys.path.remove(str(ROOT))
    return sum(
        1 for m in harness.load_cell(cell).per_layer
        if m["source"] in ("program_span", "program_counter")
        and harness.metric_module(m["name"]).KIND == "profile")


@pytest.mark.parametrize("cell", _manifest_cells())
def test_each_cell_opens_what_its_new_metrics_read(cell):
    """The cell's tiny CPU rehearsal under ``recording()``, in a fresh
    interpreter (a run refuses a process that loaded the JAX package, as
    this one has), opens every span and counter its metric files read;
    the cells and their counts of such metrics are ``BENCHMARK.json``'s."""
    code = REHEARSE.format(root=str(ROOT), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["attempted"] >= 1
    assert len(got["reads"]) == _program_metrics(cell) > 0
    for metric, names in got["reads"].items():
        for name in names:
            assert name in got["spans"] or got["counters"].get(name, 0) > 0, (
                metric, name)
