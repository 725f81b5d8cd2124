"""The traffic generator: the benchmark's seeded copy of the bench
phantom equals ``bench_inputs`` at seed 0, and seeds give other grids."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import generator


@pytest.fixture(scope="module")
def config():
    return harness.load_cell("p31_grid.maps").config


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_seed0_is_bench_make_inputs_bit_for_bit(config):
    from xmris_tpu_torch import bench_inputs as bi

    fids, weight, freqs = bi.make_inputs()
    re, im = generator.fid_grid(config, 0, "cpu")
    assert np.array_equal(_bits(re.numpy()), _bits(fids.real))
    assert np.array_equal(_bits(im.numpy()), _bits(fids.imag))
    w, f = generator.spectral_constants(config)
    assert np.array_equal(w, weight) and np.array_equal(f, freqs)


def test_coil_maps_are_bench_maps():
    from xmris_tpu_torch import bench_inputs as bi

    config = harness.load_cell("p31_kspace.maps").config
    assert np.array_equal(generator.coil_maps(config), bi.unit_rss_coil_maps())


def test_pool_seeds_differ_and_repeat(config):
    small = dict(config, grid=[2, 2, 2])
    mix = {"pool": 2, "seed_stride": 16}
    a = generator.make_pool(small, mix, 2**31 + 5, "cpu")
    b = generator.make_pool(small, mix, 2**31 + 5, "cpu")
    c = generator.make_pool(small, mix, 2**31 + 6, "cpu")
    assert [g["seed"] for g in a] == [(2**31 + 5) * 16, (2**31 + 5) * 16 + 1]
    assert all(np.array_equal(x["re"].numpy(), y["re"].numpy()) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["re"].numpy(), a[1]["re"].numpy())
    assert not np.array_equal(a[0]["re"].numpy(), c[0]["re"].numpy())


def test_coil_kspace_inverts_to_the_grid():
    import torch

    config = dict(harness.load_cell("p31_kspace.maps").config, grid=[4, 4, 2])
    pool = generator.make_pool(config, {"pool": 1}, 3, "cpu")
    re, im = generator.fid_grid(config, 3 * 16, "cpu")
    from benchmark.reference import recon

    y_re, y_im = recon.recon(pool[0]["kspace"], pool[0]["maps"])
    scale = float(torch.sqrt(re.double() ** 2 + im.double() ** 2).max())
    assert float((y_re.reshape(re.shape) - re.double()).abs().max()) < 1e-5 * scale
    assert float((y_im.reshape(im.shape) - im.double()).abs().max()) < 1e-5 * scale
