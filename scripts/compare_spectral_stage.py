#!/usr/bin/env python3
"""Hold the port's spectral stage at ``dft_variant=None`` bit for bit
against another checkout's.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/compare_spectral_stage.py OTHER_CHECKOUT

Each checkout (this one and OTHER_CHECKOUT, e.g. the parent commit unpacked
with ``git archive``) builds its own kernels into its own ``build/`` in a
fresh process and runs ``spectral_pipeline_planar_raw`` on the bench grid
(32x32x16 voxels, 1024 -> 2048, lb 5) at ``PipelineConfig`` defaults but
the grid search, with ``autophase`` "none", "single" (flat and stacked)
and "all".  Every spectrum and phase must be equal bit for bit; the script
prints one line per output and exits non-zero on any difference.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = (("none", "flat"), ("single", "flat"), ("single", "stacked"),
         ("all", "flat"))


def _dump(repo: str, out: str) -> None:
    """Run the spectral stage of the checkout ``repo`` and save its outputs."""
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.parallel.pipeline import PipelineConfig
    from xmris_tpu_torch.parallel.planar_pipeline import (
        spectral_pipeline_planar_raw,
    )

    dev = torch.device("cuda", 0)
    fids, weight, freqs = bi.make_inputs()
    re, im, w, f = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                    device=dev)
                    for a in (fids.real, fids.imag, weight, freqs))
    outs = {}
    for autophase, layout in CASES:
        cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase=autophase,
                             ap_optimizer="grid", spec_layout=layout)
        sr, si, (p0, p1, piv) = spectral_pipeline_planar_raw(re, im, w, f, cfg)
        tag = f"{autophase}/{layout}"
        outs.update({f"{tag} spec_re": sr, f"{tag} spec_im": si,
                     f"{tag} p0": p0, f"{tag} p1": p1, f"{tag} pivot": piv})
    torch.cuda.synchronize()
    torch.save({n: v.cpu() for n, v in outs.items()}, out)


def _same_bits(a, b) -> bool:
    """NaN at the same places and the float32 bits of every other entry."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--dump":
        _dump(argv[1], argv[2])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_spectral_stage: needs a CUDA device", file=sys.stderr)
        return 2
    other = str(Path(argv[0]).resolve())
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dumps = {}
        for label, repo in (("this", str(ROOT)), ("other", other)):
            out = str(Path(tmp) / f"{label}.pt")
            subprocess.run([sys.executable, __file__, "--dump", repo, out],
                           check=True, cwd=repo)
            dumps[label] = torch.load(out)
    failed = 0
    for name, val in dumps["this"].items():
        same = _same_bits(val, dumps["other"][name])
        print(f"{name}: {'bit for bit' if same else 'DIFFERS'}")
        failed += not same
    print(f"{len(dumps['this']) - failed} of {len(dumps['this'])} outputs "
          f"equal bit for bit to {other}'s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
