"""Fused end-to-end MRSI grid program: spectra + phases + fit + CRLB.

Port of :func:`xmris_tpu.parallel.process.process_grid_planar_raw`.  The
reference compiles the whole per-grid workload into one XLA program; here
it is one eager PyTorch call whose device work is the four hand-written
kernels (K1 spectrum, K2 normal equations, K3 damped SPD solve, K4 inverse
diagonal) plus tensor glue.  The spectral stage and the fit both read the
raw FIDs and do not depend on each other.

Everything is planar float32: complex FIDs travel as (real, imag) planes.
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.fitting.amares import seeded_fit_grid_raw
from xmris_tpu_torch.fitting.prior import PriorKnowledge
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import spectral_pipeline_planar_raw


def grid_inputs_from_numpy(fids, weight, freqs, t, x_template,
                           prior: PriorKnowledge, device):
    """The tensors of :func:`process_grid_planar_raw` from numpy state.

    ``fids`` (B, n_time) complex; ``weight``/``freqs`` (zero_fill_to,);
    ``t`` (n_time,); ``x_template`` (F,).  Returns ``(fids_re, fids_im,
    weight, freqs, t, x_template, lower, upper, kind)`` on ``device``, all
    float32 except ``kind`` (int32).
    """
    def f32(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=device
        )

    fids = np.asarray(fids)
    return (
        f32(fids.real), f32(fids.imag), f32(weight), f32(freqs), f32(t),
        f32(x_template), f32(prior.lower), f32(prior.upper),
        torch.as_tensor(np.asarray(prior.kind, np.int32), device=device),
    )


def process_grid_planar_raw(
    fids_re,
    fids_im,
    weight,
    freqs,
    t,
    x_template,
    lower,
    upper,
    kind,
    *,
    cfg: PipelineConfig,
    pmap_static,
    mhz: float,
    amp_slots: tuple,
    ls_plan: tuple,
    max_iter: int = 24,
    lam0: float = 1e-3,
    kernel_version: int = 9,
    plateau_streak: int = 3,
    uniform_t_ok: bool = False,
    spd_pallas: bool = True,
    kernels: KernelSet = DISPATCH,
):
    """One grid: spectral stage + seeded fit + CRLB.

    Inputs are the planar (B, n_time) FID planes, the spectral constants
    (``weight``, ``freqs``) and the fit's prior data (time axis ``t``, the
    template optimum ``x_template``, bound arrays, and the static seeding
    plan of :func:`xmris_tpu_torch.fitting.amares.seed_plan`).  The device
    is the planes' device.  ``kernels`` selects the kernel wrappers
    (default) or their plain versions.

    Returns ``(spec_re, spec_im, (p0, p1, pivot), x_free, cost, converged,
    crlb_sds)``.
    """
    spec_re, spec_im, phases = spectral_pipeline_planar_raw(
        fids_re, fids_im, weight, freqs, cfg, kernels=kernels
    )
    x_free, cost, converged, sds = seeded_fit_grid_raw(
        fids_re, fids_im, t, x_template, lower, upper, kind,
        pmap_static=pmap_static, mhz=mhz, amp_slots=amp_slots,
        ls_plan=ls_plan, max_iter=max_iter, lam0=lam0,
        kernel_version=kernel_version, plateau_streak=plateau_streak,
        uniform_t_ok=uniform_t_ok, spd_pallas=spd_pallas, kernels=kernels,
    )
    return spec_re, spec_im, phases, x_free, cost, converged, sds
