"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

=====  =======================================  ===============================================
K1     ``dft_cuda.spectrum``                    ``dft_pallas.spectrum_pallas``
K2     ``lm_cuda.eq6_normal_equations``         ``lm_pallas.eq6_normal_equations_pallas_v9``
K3     ``spd.spd_solve_damped``                 ``spd.spd_solve_damped_pallas_slab``
K4     ``spd.spd_inverse_diag``                 ``spd.spd_inverse_diag_pallas_slab``
K5     ``acme_cuda.acme_polish``                ``acme_pallas.acme_polish_pallas``
K6a    ``spd.spd_solve_damped_dense``           ``spd.spd_solve_damped_pallas``
K6b    ``spd.spd_inverse_diag_dense``           ``spd.spd_inverse_diag_pallas``
K7     ``lm_jac_cuda.eq6_normal_equations_v3``  ``lm_pallas.eq6_normal_equations_pallas_v3``
K8     ``lm_loop_cuda.lm_loop_v10``             ``lm_pallas.lm_loop_pallas_v10``
K9     ``lm_cuda.eq6_normal_equations_v8``      ``lm_pallas.eq6_normal_equations_pallas_v8``
K10    ``lm_jac_cuda.eq6_normal_equations_v7``  ``lm_pallas.eq6_normal_equations_pallas_v7``
K11    ``lm_jac_cuda.eq6_normal_equations_v6``  ``lm_pallas.eq6_normal_equations_pallas_v6``
K12    ``lm_jac_cuda.eq6_normal_equations_v5``  ``lm_pallas.eq6_normal_equations_pallas_v5``
K13    ``lm_jac_cuda.eq6_normal_equations_v2``  ``lm_pallas.eq6_normal_equations_pallas_v2``
K14    ``lm_jac_cuda.eq6_normal_equations_v1``  ``lm_pallas.eq6_normal_equations_pallas``
K5s    ``acme_cuda.acme_search``                none: ``phasing._grid_phase_search`` on one row
=====  =======================================  ===============================================

``dft.py`` (the matmul DFT, ``dft_planar`` and its variants) is no kernel:
the reference computes it as XLA matmuls outside any Pallas kernel, so the
port computes it with ``torch.matmul``.

K13 and K14 launch K7's kernel (the same function), K11 and K10 K12's
with a voxel mask (K10 on the block-factored basis), K9 K2's evaluation
with an identity fold; each under its own counter.  K5s ports no TPU
kernel: it runs the single-pivot grid search, scan and polish, that the
reference leaves to XLA, in one launch (K5's evaluation and step).

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors.  Code on the main paths takes its kernels from a
:class:`KernelSet`: :data:`DISPATCH` (the wrappers, the default) or
:data:`PLAIN` (the plain versions on any device, which is how the card
checks the kernel path against the plain one).

:data:`PATHS` names the kernels each entry point launches on the card, by
counter name: a run of that path launches every one of them (and only the
plain versions that the caller asked for).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from xmris_tpu_torch.ops.kernels import (
    acme_cuda,
    dft_cuda,
    lm_cuda,
    lm_jac_cuda,
    lm_loop_cuda,
    spd,
)
from xmris_tpu_torch.ops.kernels.dft import (
    dft_planar,
    fft_ortho_planar,
    ifft_ortho_planar,
    plan_dft,
)
from xmris_tpu_torch.ops.kernels._counters import (
    LAUNCHES,
    PLAIN_CALLS,
    reset as reset_counters,
    snapshot as counters,
)


@dataclasses.dataclass(frozen=True)
class KernelSet:
    spectrum: Callable
    normal_equations: Callable
    spd_solve_damped: Callable
    spd_inverse_diag: Callable
    acme_polish: Callable
    spd_inverse_diag_dense: Callable
    spd_solve_damped_dense: Callable
    normal_equations_v3: Callable
    normal_equations_v5: Callable
    lm_loop_v10: Callable
    normal_equations_v8: Callable
    normal_equations_v7: Callable
    normal_equations_v6: Callable
    normal_equations_v2: Callable
    normal_equations_v1: Callable
    acme_search: Callable


DISPATCH = KernelSet(
    spectrum=dft_cuda.spectrum,
    normal_equations=lm_cuda.eq6_normal_equations,
    spd_solve_damped=spd.spd_solve_damped,
    spd_inverse_diag=spd.spd_inverse_diag,
    acme_polish=acme_cuda.acme_polish,
    spd_inverse_diag_dense=spd.spd_inverse_diag_dense,
    spd_solve_damped_dense=spd.spd_solve_damped_dense,
    normal_equations_v3=lm_jac_cuda.eq6_normal_equations_v3,
    normal_equations_v5=lm_jac_cuda.eq6_normal_equations_v5,
    lm_loop_v10=lm_loop_cuda.lm_loop_v10,
    normal_equations_v8=lm_cuda.eq6_normal_equations_v8,
    normal_equations_v7=lm_jac_cuda.eq6_normal_equations_v7,
    normal_equations_v6=lm_jac_cuda.eq6_normal_equations_v6,
    normal_equations_v2=lm_jac_cuda.eq6_normal_equations_v2,
    normal_equations_v1=lm_jac_cuda.eq6_normal_equations_v1,
    acme_search=acme_cuda.acme_search,
)

PLAIN = KernelSet(
    spectrum=dft_cuda.spectrum_plain,
    normal_equations=lm_cuda.eq6_normal_equations_plain,
    spd_solve_damped=spd.spd_solve_damped_plain,
    spd_inverse_diag=spd.spd_inverse_diag_plain,
    acme_polish=acme_cuda.acme_polish_plain,
    spd_inverse_diag_dense=spd.spd_inverse_diag_dense_plain,
    spd_solve_damped_dense=spd.spd_solve_damped_dense_plain,
    normal_equations_v3=lm_jac_cuda.eq6_normal_equations_v3_plain,
    normal_equations_v5=lm_jac_cuda.eq6_normal_equations_v5_plain,
    lm_loop_v10=lm_loop_cuda.lm_loop_v10_plain,
    normal_equations_v8=lm_cuda.eq6_normal_equations_v8_plain,
    normal_equations_v7=lm_jac_cuda.eq6_normal_equations_v7_plain,
    normal_equations_v6=lm_jac_cuda.eq6_normal_equations_v6_plain,
    normal_equations_v2=lm_jac_cuda.eq6_normal_equations_v2_plain,
    normal_equations_v1=lm_jac_cuda.eq6_normal_equations_v1_plain,
    acme_search=acme_cuda.acme_search_plain,
)

_FIT = ("eq6_normal_eq_v9", "spd_solve_damped", "spd_inverse_diag")
# The non-slab LM's step and its dense CRLB (kernel_version 1-3 and 5-8).
_DENSE = ("spd_solve_damped_dense", "spd_inverse_diag_dense")

# Entry point on the card -> the kernels it launches (counter names).
PATHS = {
    # process_grid_planar_raw, autophase="single" with the grid search (the
    # gd polish on one row: K5s)
    "grid_single_pivot": ("spectrum", "acme_search") + _FIT,
    # process_grid_planar_raw, autophase="single" with DE on the pivot row
    # (the PipelineConfig default)
    "grid_single_pivot_de": ("spectrum",) + _FIT,
    # process_grid_planar_raw, autophase="all" with the grid search
    "grid_per_voxel": ("spectrum", "acme_polish") + _FIT,
    # process_grid_planar_raw, autophase="all" with one DE per voxel (its
    # polish is autograd, not K5)
    "grid_per_voxel_de": ("spectrum",) + _FIT,
    # fitting.amares.seeded_fit_grid_raw (v9, slab; free g included)
    "seeded_fit": _FIT,
    # fitting.amares.fit_amares, engine="pallas"
    "fit_amares": ("eq6_normal_eq_v9", "spd_solve_damped",
                   "spd_inverse_diag_dense"),
    # process_grid_planar_raw, autophase="single" with the grid search, with
    # a matmul dft_variant ("fused", "einsum", "flat", "block", "full"): no K1
    "grid_single_pivot_dft": ("acme_search",) + _FIT,
    # process_grid_planar_raw, autophase="single" with the grid search,
    # kernel_version=10, 3, 5 and (the bench's Lorentzian prior, n_t % 128
    # == 0) 8, 6, 7, 2, 1
    "grid_single_pivot_v10": ("spectrum", "acme_search", "lm_loop_v10",
                              "spd_inverse_diag_dense"),
    **{f"grid_single_pivot_v{v}": ("spectrum", "acme_search",
                                   f"eq6_normal_eq_v{v}") + _DENSE
       for v in (3, 5, 8, 6, 7, 2, 1)},
    # fit_amares(kernel_version=10), fit_amares(kernel_version=8)
    "fit_amares_v10": ("lm_loop_v10", "spd_inverse_diag_dense"),
    "fit_amares_v8": ("eq6_normal_eq_v8",) + _DENSE,
    # parallel.pipeline.mrsi_pipeline, the single pivot with the grid search
    "mrsi_pipeline": ("spectrum", "acme_search"),
    # mrsi_pipeline, the single pivot with DE, or autophase="none"
    "mrsi_pipeline_de": ("spectrum",),
    # mrsi_pipeline with a matmul dft_variant and the single-pivot grid
    # search
    "mrsi_pipeline_dft": ("acme_search",),
    # mrsi_pipeline, autophase="all" with the grid search and the "auto" or
    # "fused" polish
    "mrsi_pipeline_per_voxel": ("spectrum", "acme_polish"),
    # ops.baseline.baseline_als / als_baseline_batched: plain torch
    "baseline_als": (),
    # recon.kspace / recon.sense: torch.fft and plain torch sums
    "recon": (),
}

__all__ = [
    "DISPATCH", "KernelSet", "LAUNCHES", "PATHS", "PLAIN", "PLAIN_CALLS",
    "counters", "dft_planar", "fft_ortho_planar", "ifft_ortho_planar",
    "plan_dft", "reset_counters",
]
