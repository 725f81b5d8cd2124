"""Default dtypes and dtype matching (PyTorch port).

Port of the dtype half of :mod:`xmris_tpu.runtime.config`: new arrays are
float32/complex64 unless the input says otherwise, and every op keeps the
precision of its input (complex128 CPU parity runs stay in double).
"""

from __future__ import annotations

import numpy as np
import torch

_DOUBLE = (np.dtype(np.float64), np.dtype(np.complex128))


def default_float_dtype() -> np.dtype:
    return np.dtype(np.float32)


def default_complex_dtype() -> np.dtype:
    return np.dtype(np.complex64)


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
