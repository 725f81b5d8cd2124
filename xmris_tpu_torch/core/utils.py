"""Small core helpers: dimension bouncer, metadata-rich coordinates, and
the split of a complex payload into device planes.

Port of ``xmris_tpu.core.utils``, with the same error text (missing dims,
available dims, a copy-pasteable ``rename`` fix).
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import Coord, XmrArray
from xmris_tpu_torch.core.config import XmrTerm
from xmris_tpu_torch.runtime.profiling import to_card


def _dim_error(method_name: str, missing: list[str], available) -> str:
    """The actionable dim-mismatch message (reference ``core/utils.py:14-20``)."""
    fix = f"    >>> obj = obj.rename({{{missing[0]!r}: 'correct_name'}})"
    return (
        f"Method '{method_name}' attempted to operate on missing "
        f"dimension(s): {missing}.\n"
        f"Available dimensions are: {list(available)}.\n\n"
        f"To fix this, either pass the correct `dim` string argument to the "
        f"function, or rename your data's axes:\n" + fix
    )


def check_dims(da: XmrArray, dims: str | list[str], method_name: str) -> None:
    """Validate that required dimensions exist, with an actionable error."""
    wanted = (dims,) if isinstance(dims, str) else tuple(dims)
    present = set(da.dims)
    missing = [d for d in wanted if d not in present]
    if missing:
        raise ValueError(_dim_error(method_name, missing, da.dims))


# Private alias kept for parity with reference call sites (`_check_dims`).
_check_dims = check_dims


def as_coord(term: XmrTerm, dim: str, data: np.ndarray) -> Coord:
    """Build a :class:`Coord` carrying unit/long_name metadata from a term.

    Equivalent of the reference's ``as_variable`` (``core/utils.py:24-33``)
    for the native carrier.
    """
    meta = {"long_name": term.long_name}
    if term.unit:
        meta["units"] = term.unit
    return Coord(dim, np.asarray(data), meta)


def complex_planes(data, device):
    """Contiguous (real, imag) planes of a complex numpy array or tensor on
    ``device``, from ONE host-to-device copy of the complex payload
    (float32 planes for complex64, float64 for complex128); a real payload
    gives itself and zeros."""
    if not isinstance(data, torch.Tensor):
        data = np.ascontiguousarray(data)
    z = to_card(data, device)
    if not z.is_complex():
        return z.contiguous(), torch.zeros_like(z)
    return z.real.contiguous(), z.imag.contiguous()


def card_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is no
    card raises (entry points run on the card unless the caller passes
    ``device="cpu"``, and never fall back to the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the card: no CUDA device is available (pass "
            "device='cpu' to run on the host)")
    return dev
