"""Global runtime configuration: precision and kernel defaults (PyTorch
port of :mod:`xmris_tpu.runtime.config`).

New arrays are float32/complex64 unless the input says otherwise, and every
op keeps the precision of its input (complex128 CPU parity runs stay in
double).  :data:`config` is the only mutable state of the package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_DOUBLE = (np.dtype(np.float64), np.dtype(np.complex128))


@dataclass(slots=True)
class RuntimeConfig:
    """Framework-wide runtime knobs.

    Attributes
    ----------
    preferred_float : str
        Default real dtype of newly created arrays when the input gives no
        preference: ``"float32"`` (the card's) or ``"float64"``.  The
        reference honours ``"float64"`` only under ``jax_enable_x64``;
        PyTorch always has double precision (:attr:`x64_enabled` is True),
        so here ``"float64"`` alone makes :func:`default_float_dtype`
        float64.

    The reference's ``interpret_pallas`` has no counterpart field: a
    wrapper picks its kernel's plain PyTorch version only for tensors that
    lie on the CPU, and launches its kernel (or raises) on a CUDA tensor.
    A caller asks for the plain versions on the card with ``kernels=PLAIN``
    (:mod:`xmris_tpu_torch.ops.kernels`).  The class has slots, so setting
    a field it does not have (``config.interpret_pallas = True``) raises
    ``AttributeError`` instead of changing nothing.
    """

    preferred_float: str = "float32"

    @property
    def x64_enabled(self) -> bool:
        return True


config = RuntimeConfig()


def default_float_dtype() -> np.dtype:
    if config.preferred_float == "float64" and config.x64_enabled:
        return np.dtype(np.float64)
    return np.dtype(np.float32)


def default_complex_dtype() -> np.dtype:
    return (np.dtype(np.complex128) if default_float_dtype() == np.float64
            else np.dtype(np.complex64))


def matching_dtypes(dtype) -> tuple[np.dtype, np.dtype]:
    """(real, complex) numpy dtypes at the precision of ``dtype`` (a numpy
    or torch dtype)."""
    if isinstance(dtype, torch.dtype):
        double = dtype in (torch.float64, torch.complex128)
    else:
        double = np.dtype(dtype) in _DOUBLE
    if double:
        return np.dtype(np.float64), np.dtype(np.complex128)
    return np.dtype(np.float32), np.dtype(np.complex64)
