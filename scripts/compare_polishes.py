#!/usr/bin/env python3
"""Per-voxel grid-search polishes of both packages on the bench grid, on
the CPU: each polish's ACME score against the gd polish's.

Usage, from the root of a checkout (JAX on the CPU, ~10 min for the three
polishes):

    JAX_PLATFORMS=cpu python3 scripts/compare_polishes.py [gd,bfgs,newton]

The bench phantom (``xmris_tpu_torch.bench_inputs.make_inputs()``, 16 384
voxels, 1024 -> 2048 points, lb = 5) goes through the port's plain K1 and
then, 1024 voxels at a time, through the port's ``_grid_phase_search`` and
the JAX package's (jitted) with each polish; every solution is scored in
float64 on the same spectra.  For each polish but gd it prints, for the
port, the reference and the port against the reference's gd: the median
and maximum score ratio to gd, the voxel of the maximum, the shares within
x1.001 and x1.02 and the count above x1.02.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def main(argv) -> int:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from xmris_tpu.ops import phasing as jph
    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.ops import phasing as tph
    from xmris_tpu_torch.ops.kernels import dft_cuda

    polishes = (argv[0] if argv else "gd,bfgs,newton").split(",")
    if "gd" not in polishes:
        polishes = ["gd"] + polishes
    fids, weight, freqs = bi.make_inputs()
    f = torch.tensor(freqs)
    x_range = float(f[-1] - f[0])
    window = torch.tensor(weight[:bi.N_TIME])
    searches = {
        p: jax.jit(lambda a, b, c, d, e, p=p: jph._grid_phase_search(
            a, b, c, x_range, d, e, 1, "acme", False, polish_optimizer=p))
        for p in polishes
    }
    port = {p: [] for p in polishes}
    ref = {p: [] for p in polishes}
    for s in range(0, fids.shape[0], 1024):
        rows = fids[s:s + 1024]
        sr, si = dft_cuda.spectrum(
            torch.tensor(np.ascontiguousarray(rows.real)),
            torch.tensor(np.ascontiguousarray(rows.imag)), bi.ZERO_FILL,
            window=window)
        ti = torch.argmax(sr * sr + si * si, 1)
        piv = f[ti]

        def score(p):
            d = tph._phased_real_planar(
                sr.double(), si.double(), f.double(), p[:, 0].double(),
                p[:, 1].double(), piv.double()[:, None], x_range)
            return tph.acme_score_raw(d).numpy()

        for pol in polishes:
            port[pol].append(score(tph._grid_phase_search(
                sr, si, f, x_range, piv, False, polish_optimizer=pol)))
            xs = searches[pol](*(jnp.asarray(a) for a in (
                sr.numpy(), si.numpy(), freqs, piv.numpy(), ti.numpy())))
            ref[pol].append(score(torch.tensor(np.asarray(xs))))
        print(f"voxels {s + len(rows)} / {fids.shape[0]}", flush=True)
    port = {k: np.concatenate(v) for k, v in port.items()}
    ref = {k: np.concatenate(v) for k, v in ref.items()}
    for pol in polishes[1:]:
        for name, r in (("port", port[pol] / port["gd"]),
                        ("reference", ref[pol] / ref["gd"]),
                        ("port / reference gd", port[pol] / ref["gd"])):
            print(f"{pol} {name}: median {np.median(r):.6f}, max "
                  f"{r.max():.6f} at voxel {int(r.argmax())}, share <= x1.001 "
                  f"{np.mean(r <= 1.001):.5f}, share <= x1.02 "
                  f"{np.mean(r <= 1.02):.5f}, {int(np.sum(r > 1.02))} above "
                  f"x1.02")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
