"""The roofline counts: K1 and K2 at the bench shapes give
``chip_smoke._bound``'s 0.120 ms (bytes) and 0.099 ms (operations); the
data-dependent K2 count drops the done and the rejected voxels' work."""

from __future__ import annotations

import torch

from benchmark import roofline


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
