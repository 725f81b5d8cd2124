"""Fused end-to-end MRSI grid program: spectra + phases + fit + CRLB.

Port of :func:`xmris_tpu.parallel.process.process_grid_planar_raw`.  The
reference compiles the whole per-grid workload into one XLA program; here
it is one eager PyTorch call whose device work is the hand-written kernels
plus tensor glue: K1 spectrum (K5 fused ACME polish with
``autophase="all"`` and the grid search), then the fit that ``kernel_version`` selects — 9: K2
normal equations and K3 damped SPD solve per iteration, K4 CRLB diagonal;
10: the whole LM in one K8 launch; 1, 2, 3, 5, 6, 7 or 8: K14, K13, K7, K12,
K11, K10 or K9 with the dense K6a solve — with K6b's CRLB diagonal on the
dense paths.  The spectral stage
and the fit both read the raw FIDs and do not depend on each other.

Everything is planar float32: complex FIDs travel as (real, imag) planes.

:func:`process_grid_sharded` runs the same program with the voxel axis
split over a :class:`~xmris_tpu_torch.parallel.mesh.Mesh`, each shard on its
device (a host thread per distinct device); :func:`pinned_grid_program` binds the
program's keyword arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.fitting.amares import seeded_fit_grid_raw
from xmris_tpu_torch.fitting.prior import PriorKnowledge
from xmris_tpu_torch.ops.kernels import DISPATCH, KernelSet
from xmris_tpu_torch.parallel.mesh import GRID_AXIS, Mesh, map_shards
from xmris_tpu_torch.parallel.pipeline import PipelineConfig
from xmris_tpu_torch.parallel.planar_pipeline import (
    spectral_pipeline_planar_raw,
    spectral_pipeline_sharded,
)


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
    v_tile: int | None = None,
    interpret: bool = False,
    plateau_streak: int = 3,
    uniform_t_ok: bool = False,
    engine: str = "pallas",
    spd_pallas: bool = True,
    kernels: KernelSet = DISPATCH,
):
    """One grid: spectral stage + seeded fit + CRLB.

    Inputs are the planar (B, n_time) FID planes, the spectral constants
    (``weight``, ``freqs``) and the fit's prior data (time axis ``t``, the
    template optimum ``x_template``, bound arrays, and the static seeding
    plan of :func:`xmris_tpu_torch.fitting.amares.seed_plan`).  The device
    is the planes' device.  ``engine`` is the fit's
    (:func:`~xmris_tpu_torch.fitting.amares.seeded_fit_grid_raw`): ``"pallas"``
    runs the kernel LM, any other value the pure-tensor LM.  ``kernels``
    selects the kernel wrappers (default) or their plain versions.
    ``v_tile`` and ``interpret`` (TPU tiling, Pallas interpret mode) are
    accepted and have no counterpart: CPU tensors take the plain versions.

    Returns ``(spec_re, spec_im, (p0, p1, pivot), x_free, cost, converged,
    crlb_sds)``; the phases are 0-dim for ``cfg.autophase="single"`` and
    per voxel (B,) for ``"all"``.
    """
    del v_tile, interpret
    spec_re, spec_im, phases = spectral_pipeline_planar_raw(
        fids_re, fids_im, weight, freqs, cfg, kernels=kernels
    )
    x_free, cost, converged, sds = seeded_fit_grid_raw(
        fids_re, fids_im, t, x_template, lower, upper, kind,
        pmap_static=pmap_static, mhz=mhz, amp_slots=amp_slots,
        ls_plan=ls_plan, max_iter=max_iter, lam0=lam0,
        kernel_version=kernel_version, plateau_streak=plateau_streak,
        uniform_t_ok=uniform_t_ok, engine=engine, spd_pallas=spd_pallas,
        kernels=kernels,
    )
    return spec_re, spec_im, phases, x_free, cost, converged, sds


def pinned_grid_program(device=None, **static_kwargs):
    """:func:`process_grid_planar_raw` with its keyword arguments bound
    (reference ``pinned_grid_program``).

    ``static_kwargs`` are the program's keyword arguments (``cfg``,
    ``pmap_static``, ``mhz``, the seeding plans, the LM knobs); the
    returned callable takes the nine input tensors and, when ``device`` is
    given, moves them there first.  The reference pins its spectra's
    memory layout at the jit boundary of a TPU program; the port's planes
    are already row-major, so there is nothing to pin.
    """

    def run(fids_re, fids_im, weight, freqs, t, x_template, lower, upper,
            kind):
        arrays = (fids_re, fids_im, weight, freqs, t, x_template, lower,
                  upper, kind)
        if device is not None:
            arrays = tuple(a.to(device) for a in arrays)
        return process_grid_planar_raw(*arrays, **static_kwargs)

    return run


def process_grid_sharded(
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
    mesh: Mesh,
    axis_name: str = GRID_AXIS,
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
    engine: str = "pallas",
    spd_pallas: bool = True,
    kernels: KernelSet = DISPATCH,
):
    """:func:`process_grid_planar_raw` over a voxel mesh (reference
    ``process_grid_sharded``).

    The voxel axis of the FID planes splits over ``mesh``'s
    ``axis_name`` (the batch must divide by it); the other inputs go whole
    to every device.  The spectral stage runs sharded
    (:func:`~xmris_tpu_torch.parallel.planar_pipeline.spectral_pipeline_sharded`:
    K1 per shard, per voxel also its search, K5 with the grid search; for
    ``autophase="single"`` one pivot candidate per shard, the first
    maximum elected on the mesh's first device and the phase solved once
    there), then the seeded fit with its CRLBs on every shard (K2 and K3
    per LM iteration, K4), with no communication.  Each shard runs on its
    device, a host thread per distinct device
    (:func:`~xmris_tpu_torch.parallel.mesh.run_on_devices`).

    Returns the unsharded program's tuple, whole on the mesh's first
    device.  A shard that fails raises.
    """
    spec_re, spec_im, phases = spectral_pipeline_sharded(
        fids_re, fids_im, weight, freqs, cfg, mesh, axis_name, kernels)

    def fit_shard(re, im, t, x_template, lower, upper, kind):
        return seeded_fit_grid_raw(
            re, im, t, x_template, lower, upper, kind, pmap_static=pmap_static,
            mhz=mhz, amp_slots=amp_slots, ls_plan=ls_plan, max_iter=max_iter,
            lam0=lam0, kernel_version=kernel_version,
            plateau_streak=plateau_streak, uniform_t_ok=uniform_t_ok,
            engine=engine, spd_pallas=spd_pallas, kernels=kernels)

    x_free, cost, converged, sds = map_shards(
        fit_shard, mesh, (fids_re, fids_im),
        (t, x_template, lower, upper, kind), axis_name)
    return spec_re, spec_im, phases, x_free, cost, converged, sds
