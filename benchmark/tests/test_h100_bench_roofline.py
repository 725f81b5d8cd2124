"""The roofline counts: K1-K4 at the bench shapes give
``chip_smoke._bound``'s 0.120 ms (bytes), 0.099 ms (operations), 0.0049
and 0.0045 ms (bytes); the data-dependent K2 count drops the done and the
rejected voxels' work; K3/K4's operations grow as F^3; each kernel
metric's slot is called, with work to count, in every cell it lists; and
a metric that names its kernel finds that kernel's records alone and
reads them over the profiled calls' work."""

from __future__ import annotations

import dataclasses
import re

import pytest
import torch

from benchmark import harness, roofline
from benchmark import run as brun
from benchmark.traffic import generator

from conftest import tiny_cell


def _k2_args(b=16384, n=1024):
    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.lm import hashable_pmap, normal_eq_plan
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text

    pk = prior_from_csv_text(bi.PK_CSV, "bench")
    plan = normal_eq_plan(hashable_pmap(pk.pmap), pk.n_free, bi.MHZ, True)
    meta = dict(device="meta")
    return (torch.empty((b, 25), **meta), torch.empty((b, n), **meta),
            torch.empty((b, n), **meta), torch.empty((n,), **meta),
            torch.empty((b, pk.n_free), **meta), plan)


def test_k1_bound_at_bench_shape():
    xr = torch.empty((16384, 1024), device="meta")
    nbytes, flops = roofline.spectrum_work((xr, xr, 2048), {"with_maxmag": True})
    ms = 1e3 * roofline.least_seconds(nbytes, flops)
    assert abs(ms - 0.1202) < 5e-4
    assert nbytes / roofline.PEAK_BYTES_PER_S > flops / roofline.PEAK_FP32_FLOPS


def test_k2_bound_at_bench_shape():
    nbytes, flops = roofline.normal_equations_work(_k2_args(), {})
    ms = 1e3 * roofline.least_seconds(nbytes, flops)
    assert abs(ms - 0.0991) < 5e-4
    assert flops / roofline.PEAK_FP32_FLOPS > nbytes / roofline.PEAK_BYTES_PER_S


def test_k2_counts_only_live_and_kept_voxels():
    params, y_re, y_im, t, dxdu, plan = _k2_args(b=8, n=64)
    full_b, full_f = roofline.normal_equations_work(
        (params, y_re, y_im, t, dxdu, plan), {})
    mask = torch.tensor([True] * 4 + [False] * 4)
    prev = torch.tensor([2.0, 2.0, 0.5, 0.5] + [1.0] * 4)
    cost = torch.ones(8)
    nb, nf = roofline.normal_equations_work(
        (params, y_re, y_im, t, dxdu, plan), {"voxel_mask": mask, "cost_prev": prev},
        (cost, None, None))
    per_b, per_f = (full_b - 4 * 64) / 8, full_f / 8
    assert 2 * per_f < float(nf) < 4 * per_f
    assert 2 * per_b < float(nb) < 4 * per_b + 4 * 64


def _slab(b=16384, f=20):
    meta = dict(device="meta")
    return (torch.empty((f * f, b), **meta), torch.empty((b, f), **meta),
            torch.empty((b,), **meta))


@pytest.mark.parametrize("work, ms", [
    (lambda h, g, lam: roofline.spd_solve_work((h, g, lam), {}), 0.0049),
    (lambda h, g, lam: roofline.spd_inverse_work((h,), {"tikhonov": 1e-12}), 0.0045),
], ids=["K3", "K4"])
def test_k3_k4_bounds_at_bench_shape(work, ms):
    nbytes, flops = work(*_slab())
    got = 1e3 * roofline.least_seconds(nbytes, flops)
    assert abs(got - ms) < 0.02 * ms, got
    assert nbytes / roofline.PEAK_BYTES_PER_S > flops / roofline.PEAK_FP32_FLOPS


def test_k3_k4_operations_grow_as_f_cubed():
    """Doubling F multiplies K4's operations by 8 and K3's (with its
    2 F^2 of triangular solves) by 7-8; the bytes grow as F^2."""
    for f in (20, 48):
        _, k3 = roofline.spd_solve_work(_slab(64, f), {})
        _, k3_2 = roofline.spd_solve_work(_slab(64, 2 * f), {})
        _, k4 = roofline.spd_inverse_work(_slab(64, f)[:1], {})
        b4, k4_2 = roofline.spd_inverse_work(_slab(64, 2 * f)[:1], {})
        assert 7.0 < k3_2 / k3 < 8.0 and k4_2 / k4 == 8.0, f
        assert b4 / roofline.spd_inverse_work(_slab(64, f)[:1], {})[0] < 4.0
    _, at20 = roofline.spd_inverse_work(_slab(64, 20)[:1], {})
    _, at48 = roofline.spd_inverse_work(_slab(64, 48)[:1], {})
    assert at48 / at20 == pytest.approx((48 / 20) ** 3)


@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_each_kernel_metric_slot_is_called_in_its_cells(cell):
    """One request of the cell's tiny CPU rehearsal, with the kernels'
    plain versions, calls the slot of every kernel metric it lists, and
    the metric's work function counts bytes and operations from the
    calls' arguments (none in a K2 call whose voxels are all done)."""
    from xmris_tpu_torch.ops.kernels import PLAIN

    c = tiny_cell(cell)
    slots = brun._kernel_metrics(c)
    seen = {}

    def counted(slot, fn, work):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(slot, []).append(work(args, kwargs, out))
            return out
        return wrapped

    kset = dataclasses.replace(PLAIN, **{s: counted(s, getattr(PLAIN, s), w)
                                         for s, w in slots.items()})
    pool = generator.make_pool(c.config, c.mix, 2**31 + 83, "cpu")
    entry = harness.entry_module(c)
    entry.request(entry.setup(harness.context(c, "cpu", kset, pool)), pool[0])
    assert slots and set(seen) == set(slots), (sorted(seen), sorted(slots))
    for slot, works in seen.items():
        assert all(float(b) >= 0 and float(f) >= 0 for b, f in works), slot
        assert sum(float(b) for b, _ in works) > 0, slot
        assert sum(float(f) for _, f in works) > 0, slot


# The device records' names of K1, K3, K4 and of K6b in an H100 run's
# profile (NVIDIA H100 80GB HBM3; K6b from the k-space cell's labeled fit).
RECORDS = {
    "(anonymous namespace)::spectrum_fft_kernel(float const*, float const*, "
    "float const*, float2 const*, float*, float*, float*, int*, int, int, int, "
    "float, int, int)": "spectrum",
    "void (anonymous namespace)::spd_solve_damped_kernel<20, (anonymous "
    "namespace)::SlabTile<20, 16> >(float const*, float const*, float const*, "
    "float*, int, int)": "spd_solve_damped",
    "void (anonymous namespace)::spd_inverse_diag_kernel<20, (anonymous "
    "namespace)::SlabTile<20, 16> >(float const*, float*, int, int, float)":
        "spd_inverse_diag",
    "void (anonymous namespace)::spd_inverse_diag_kernel<20, (anonymous "
    "namespace)::Dense>(float const*, float*, int, int, float)": None,
    "void (anonymous namespace)::normal_eq_warp_kernel<5, 1, (anonymous "
    "namespace)::WarpConfig<true, 64, 2> >((anonymous namespace)::WarpArgs)": None,
}


@pytest.mark.parametrize("metric", [m["name"] for m in harness.manifest()["per_layer"]
                                    if m["name"].endswith("_roofline_pct")])
def test_a_kernel_metric_names_its_own_kernel_alone(metric):
    """A ``KERNEL`` pattern finds its slot's record and no other of K1-K4
    or of the dense twin (K6b); K2 names none and keeps the events."""
    mod = harness.metric_module(metric)
    kernel = getattr(mod, "KERNEL", None)
    if mod.SLOT == "normal_equations":
        assert kernel is None
        return
    hits = [slot for name, slot in RECORDS.items() if re.search(kernel, name)]
    assert hits == [mod.SLOT], (metric, hits)


def _trace(records, works):
    events = harness.KernelEvents()
    events.work = {"spd_solve_damped": list(works)}
    return harness.Trace({}, 1, events, kernel_records=records)


def test_the_kernel_roofline_reads_the_profiles_records():
    """The least time of the profiled calls over their kernel's record
    time; the dense twin's records do not count, a call with no voxels
    launches nothing, one record lost (or 1 % of the calls) stands at
    the others' mean, and more lost, or more records than calls, gives no
    reading."""
    mod = harness.metric_module("spd_solve_roofline_pct")
    slab = list(RECORDS)[1]
    dense = slab.replace("SlabTile<20, 16> ", "Dense")
    g = torch.empty((16384, 20), device="meta")
    h = torch.empty((400, 16384), device="meta")
    lam = torch.empty((16384,), device="meta")
    work = roofline.spd_solve_work((h, g, lam), {})
    empty = roofline.spd_solve_work((h[:, :0], g[:0], lam[:0]), {})
    least = roofline.least_seconds(*work)
    tr = _trace({slab: (3, 3 * 10 * least), dense: (5, 1.0)}, [work, empty, work, work])
    assert mod.read(tr) == pytest.approx(10.0)
    assert mod.read(_trace({slab: (99, 99 * 10 * least)}, [work] * 100)) == (
        pytest.approx(10.0))
    assert mod.read(_trace({slab: (98, 98 * 10 * least)}, [work] * 100)) is None
    assert mod.read(_trace({slab: (2, 2 * 10 * least)}, [work] * 3)) == (
        pytest.approx(10.0))
    assert mod.read(_trace({slab: (1, 1e-3)}, [work] * 3)) is None
    assert mod.read(_trace({slab: (4, 1e-3)}, [work] * 3)) is None
    assert mod.read(_trace({dense: (3, 1e-3)}, [work] * 3)) is None
    assert mod.read(_trace({}, [])) is None
