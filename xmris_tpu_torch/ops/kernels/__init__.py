"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

=====  ==============================  =====================================
K1     ``dft_cuda.spectrum``           ``dft_pallas.spectrum_pallas``
K2     ``lm_cuda.eq6_normal_equations``  ``lm_pallas.eq6_normal_equations_pallas_v9``
K3     ``spd.spd_solve_damped``        ``spd.spd_solve_damped_pallas_slab``
K4     ``spd.spd_inverse_diag``        ``spd.spd_inverse_diag_pallas_slab``
=====  ==============================  =====================================

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors.  Code on the main path takes its kernels from a
:class:`KernelSet`: :data:`DISPATCH` (the wrappers, the default) or
:data:`PLAIN` (the plain versions on any device, which is how the card
checks the kernel path against the plain one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from xmris_tpu_torch.ops.kernels import dft_cuda, lm_cuda, spd
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


DISPATCH = KernelSet(
    spectrum=dft_cuda.spectrum,
    normal_equations=lm_cuda.eq6_normal_equations,
    spd_solve_damped=spd.spd_solve_damped,
    spd_inverse_diag=spd.spd_inverse_diag,
)

PLAIN = KernelSet(
    spectrum=dft_cuda.spectrum_plain,
    normal_equations=lm_cuda.eq6_normal_equations_plain,
    spd_solve_damped=spd.spd_solve_damped_plain,
    spd_inverse_diag=spd.spd_inverse_diag_plain,
)

__all__ = [
    "DISPATCH", "KernelSet", "LAUNCHES", "PLAIN", "PLAIN_CALLS", "counters",
    "reset_counters",
]
