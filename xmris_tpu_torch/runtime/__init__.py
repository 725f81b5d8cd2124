"""Runtime configuration of the PyTorch port (default dtypes).

``RuntimeConfig``, ``config`` and the profiling helpers of the reference's
runtime layer wait for ROADMAP.md queue 1, item 12.
"""

from xmris_tpu_torch.runtime.config import (
    default_complex_dtype,
    default_float_dtype,
    matching_dtypes,
)

__all__ = ["default_complex_dtype", "default_float_dtype", "matching_dtypes"]
