"""Dimension auto-resolution for 1-D-spectra-vs-series plots (port of
:mod:`xmris_tpu.visualization.plot._input_parsing`).

It keeps that module's fix of the upstream ``parse_input_dims_timeseries``,
which dereferences ``DIMS.averages``/``DIMS.repetitions`` — names
that don't exist in the vocabulary (it defines singular ``average``) — and
AttributeErrors on the >=3-dim auto-detect path.  Here the secondary-axis
preference list covers the vocabulary term plus the plural spellings used by
the Bruker loader.
"""

from __future__ import annotations

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.core.config import DIMS

_STACK_PREFERENCE = (DIMS.average, "averages", "repetitions")


def parse_input_dims_timeseries(
    da: XmrArray,
    user_x_dim: str | None = None,
    user_stack_dim: str | None = None,
) -> tuple[str, str]:
    """Resolve (x_dim, stack_dim) for a stacked-1D-spectra plot.

    Prefers ``chemical_shift`` then ``frequency`` for the x-axis; for the
    stacking axis prefers averaging/repetition dimensions, then the first
    remaining dimension.
    """
    dims = list(da.dims)

    if user_x_dim:
        if user_x_dim not in dims:
            raise ValueError(
                f"Requested x-axis dimension '{user_x_dim}' not found in DataArray."
            )
        x_dim = user_x_dim
    elif DIMS.chemical_shift in dims:
        x_dim = DIMS.chemical_shift
    elif DIMS.frequency in dims:
        x_dim = DIMS.frequency
    else:
        raise ValueError(
            "Could not automatically resolve x-axis dimension. DataArray must "
            "contain 'chemical_shift' or 'frequency', or `x_dim` must be "
            "explicitly provided."
        )

    remaining = [d for d in dims if d != x_dim]

    if user_stack_dim:
        if user_stack_dim not in dims:
            raise ValueError(
                f"Requested stacking dimension '{user_stack_dim}' not found in "
                f"DataArray."
            )
        stack_dim = user_stack_dim
    elif not remaining:
        raise ValueError(
            f"DataArray only has one dimension ('{x_dim}'). Ridge/Contour plots "
            f"require at least two dimensions."
        )
    elif len(remaining) == 1:
        stack_dim = remaining[0]
    else:
        stack_dim = next(
            (d for d in _STACK_PREFERENCE if d in remaining), remaining[0]
        )

    return str(x_dim), str(stack_dim)
