#!/usr/bin/env python3
"""Hold the port's LM and ACME polish kernels bit for bit against another
checkout's build.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/compare_kernel_builds.py OTHER_CHECKOUT

Each checkout (this one and OTHER_CHECKOUT, e.g. the parent commit unpacked
with ``git archive``) builds its own kernels from its own
``xmris_tpu_torch/ops/kernels/csrc`` into its own ``build/``, in a fresh
process that evaluates, on seeded bench inputs (16x16x16 voxels, the bench
prior, parameters within 20 % of its initial values):

* K2 (``lm_cuda.eq6_normal_equations``) with the factored and the direct
  basis, with and without a voxel mask (masked voxels are not compared),
  with the accept gate on both bases (``cost_prev`` just above the cost on
  even voxels, just below it on odd ones: the cost on every voxel, g and H
  on the improving ones), and on the bench prior with every g free (the
  t^2 rows) on both bases;
* K9 (``lm_cuda.eq6_normal_equations_v8``, the direct basis) with and
  without a voxel mask;
* K7 and K12 (``lm_jac_cuda.eq6_normal_equations_v3`` / ``_v5``);
* K8 (``lm_loop_cuda.lm_loop_v10``, 24 iterations);
* K3, K4 (with the 1e-12 ridge and without), K6a and K6b (``spd``) on K2's
  H of the bench prior (F = 20) and of the free-g prior (F = 25), in slab
  and in dense form, with three planted non-SPD voxels (H[0, 0] = -1) and
  ``lam = logspace(-5, -1)``;
* K5 (``acme_cuda.acme_polish``) on the voxels' spectra (NumPy's FFT of the
  windowed FIDs, zero-filled to 2048), each voxel's own peak as its pivot
  and random seed phases: one evaluation (score and gradient) and the
  40-step polish, p0 + p1 and p0 only.

Which pins cover which shared header: ``spd_factor.cuh`` (the warp factor
and substitutions) K3, K4, K6a, K6b (``spd.cu``) and K8 (``lm_v10.cu``);
``lm_v9_warp.cuh`` K2 (``lm_v9.cu``) and K9 (``lm_v8.cu``);
``lm_v9_eval.cuh`` K2, K9, K7 and K12 (``lm_jac.cu``) and K8;
``acme_eval.cuh`` K5 (``acme.cu``).

Only entry points both checkouts have are called.  Every output must be
equal bit for bit (NaN at the same places, the float32 bits of every other
entry the same); the script prints one line per output and exits non-zero
on any difference.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _dump(repo: str, out: str) -> None:
    """Evaluate the kernels of the checkout ``repo`` and save the outputs."""
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.lm import (
        external_to_internal,
        hashable_pmap,
        normal_eq_plan,
        slab_to_bff,
    )
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.bounds import expand_params_batched
    from xmris_tpu_torch.ops.kernels import (
        acme_cuda,
        lm_cuda,
        lm_jac_cuda,
        lm_loop_cuda,
        spd,
    )

    assert Path(lm_cuda.__file__).resolve().is_relative_to(Path(repo).resolve())
    dev = torch.device("cuda", 0)
    pk = prior_from_csv_text(bi.PK_CSV)
    ps = hashable_pmap(pk.pmap)
    fids, weight, freqs = bi.make_inputs((16, 16, 16))
    b, nf = fids.shape[0], pk.n_free
    rng = np.random.default_rng(0)
    x = np.clip(pk.init_free[None] * rng.uniform(0.8, 1.2, (b, nf)),
                pk.lower, pk.upper)
    u0 = external_to_internal(x, pk.lower, pk.upper, pk.kind)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    re, im, xs, u0 = f32(fids.real), f32(fids.imag), f32(x), f32(u0)
    lo, hi = f32(pk.lower), f32(pk.upper)
    kind = torch.as_tensor(pk.kind, device=dev)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    grids = expand_params_batched(xs, ps).contiguous()
    dxdu = f32(rng.uniform(0.5, 1.5, (b, nf)))
    mask = torch.arange(b, device=dev) % 3 != 0
    outs = {}
    for factored in (True, False):
        plan = normal_eq_plan(ps, nf, bi.MHZ, factored)
        for masked in (False, True):
            c, g, h = lm_cuda.eq6_normal_equations(
                grids, re, im, t, dxdu, plan,
                voxel_mask=mask if masked else None)
            keep = mask if masked else torch.ones_like(mask)
            tag = f"K2 factored={factored} masked={masked}"
            outs[f"{tag} cost"] = c[keep]
            outs[f"{tag} g"] = g[keep]
            outs[f"{tag} H"] = h[:, keep]
    factor = torch.where(torch.arange(b, device=dev) % 2 == 0, 1.01, 0.99)
    for factored in (True, False):
        plan = normal_eq_plan(ps, nf, bi.MHZ, factored)
        c, _, _ = lm_cuda.eq6_normal_equations(grids, re, im, t, dxdu, plan)
        c_prev = (c * factor).contiguous()
        c, g, h = lm_cuda.eq6_normal_equations(grids, re, im, t, dxdu, plan,
                                               cost_prev=c_prev)
        better = c < c_prev
        tag = f"K2 gated factored={factored}"
        outs[f"{tag} cost"] = c
        outs[f"{tag} g"] = g[better]
        outs[f"{tag} H"] = h[:, better]
    # The bench prior with every g free: Voigt rows, q_n = 2.
    pk_g = prior_from_csv_text(bi.PK_CSV.replace(
        "g,0,0,0,0,0", "g,0.1,0.1,0.1,0.1,0.1").replace(
        "g,fixed,fixed,fixed,fixed,fixed",
        'g,"(0, 1)","(0, 1)","(0, 1)","(0, 1)","(0, 1)"'))
    ps_g, nf_g = hashable_pmap(pk_g.pmap), pk_g.n_free
    x_g = np.clip(pk_g.init_free[None] * rng.uniform(0.8, 1.2, (b, nf_g)),
                  pk_g.lower, pk_g.upper)
    grids_g = expand_params_batched(f32(x_g), ps_g).contiguous()
    dxdu_g = f32(rng.uniform(0.5, 1.5, (b, nf_g)))
    for factored in (True, False):
        plan = normal_eq_plan(ps_g, nf_g, bi.MHZ, factored)
        res = lm_cuda.eq6_normal_equations(grids_g, re, im, t, dxdu_g, plan)
        for name, val in zip(("cost", "g", "H"), res):
            outs[f"K2 free g factored={factored} {name}"] = val
    lam = torch.logspace(-5, -1, b, device=dev)
    planted = torch.tensor([5, 777, b - 3], device=dev)
    for f_free, args in ((nf, (grids, re, im, t, dxdu)),
                         (nf_g, (grids_g, re, im, t, dxdu_g))):
        pss = ps if f_free == nf else ps_g
        _, g_s, h_s = lm_cuda.eq6_normal_equations(
            *args, normal_eq_plan(pss, f_free, bi.MHZ, True))
        h_s[0, planted] = -1.0  # H[0, 0] < 0: not SPD
        dense = slab_to_bff(h_s, f_free).contiguous()
        tag = f"F={f_free}"
        outs[f"K3 {tag}"] = spd.spd_solve_damped(h_s, g_s, lam)
        outs[f"K4 ridge 1e-12 {tag}"] = spd.spd_inverse_diag(h_s, 1e-12)
        outs[f"K4 no ridge {tag}"] = spd.spd_inverse_diag(h_s, 0.0)
        outs[f"K6a {tag}"] = spd.spd_solve_damped_dense(dense, g_s, lam)
        outs[f"K6b {tag}"] = spd.spd_inverse_diag_dense(dense)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    k, active = pk.n_peaks, plan.active
    for masked in (False, True):
        c, g, h = lm_cuda.eq6_normal_equations_v8(
            grids, re, im, t, k, bi.MHZ, active, validate=False,
            voxel_mask=mask if masked else None)
        keep = mask if masked else torch.ones_like(mask)
        for name, val in (("cost", c), ("g", g), ("H", h)):
            outs[f"K9 masked={masked} {name}"] = val[keep]
    for tag, res in (
        ("K7", lm_jac_cuda.eq6_normal_equations_v3(grids, re, im, t, k,
                                                   bi.MHZ)),
        ("K12", lm_jac_cuda.eq6_normal_equations_v5(grids, re, im, t, k,
                                                    bi.MHZ, active)),
    ):
        for name, val in zip(("cost", "g", "H"), res):
            outs[f"{tag} {name}"] = val
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    res = lm_loop_cuda.lm_loop_v10(u0, re, im, t, lo, hi, kind, plan, ps,
                                   max_iter=24)
    for name, val in zip(("u", "cost", "n_acc", "done", "H"), res):
        outs[f"K8 {name}"] = val
    spec = np.fft.fftshift(np.fft.fft(fids * weight[: bi.N_TIME], bi.ZERO_FILL,
                                      axis=1), axes=1)
    sr, si = f32(spec.real), f32(spec.imag)
    coords = f32(freqs)
    piv = coords[torch.as_tensor(np.argmax(np.abs(spec), axis=1), device=dev)]
    x_range = float(freqs[-1] - freqs[0])
    p_init = f32(np.stack([rng.uniform(-150, 150, b),
                           rng.uniform(-3000, 3000, b)], 1))
    for p0_only in (False, True):
        tag = "p0" if p0_only else "p0+p1"
        _, f, g = acme_cuda.acme_polish(sr, si, coords, piv, p_init, x_range,
                                        n_iter=0, p0_only=p0_only,
                                        with_grad=True)
        outs[f"K5 one evaluation {tag} score"] = f
        outs[f"K5 one evaluation {tag} gradient"] = g
        p, f = acme_cuda.acme_polish(sr, si, coords, piv, p_init, x_range,
                                     p0_only=p0_only)
        outs[f"K5 polish {tag} phases"] = p
        outs[f"K5 polish {tag} score"] = f
    torch.cuda.synchronize()
    torch.save({n: v.cpu() for n, v in outs.items()}, out)


def _same_bits(a, b) -> bool:
    """Equal bit for bit: for float32, NaN at the same places and the bits
    of every other entry (the sign of a zero included) the same."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
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
        print("compare_kernel_builds: needs a CUDA device", file=sys.stderr)
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
        ref = dumps["other"][name]
        same = _same_bits(val, ref)
        diff = "" if same else (
            f" ({int((val != ref).sum())} of {val.numel()} entries differ)"
            if val.shape == ref.shape else " (shapes differ)")
        print(f"{name}: {'bit for bit' if same else 'DIFFERS'}{diff}")
        if not same and val.shape == ref.shape:
            # The first differing entries, by index, with both values.
            for idx in (val != ref).nonzero()[:4].tolist():
                a, r = val[tuple(idx)].item(), ref[tuple(idx)].item()
                print(f"    at {idx}: {a!r} here, {r!r} there")
        failed += not same
    print(f"{len(dumps['this']) - failed} of {len(dumps['this'])} outputs "
          f"equal bit for bit to {other}'s build")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
