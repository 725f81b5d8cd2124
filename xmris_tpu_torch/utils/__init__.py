"""Cross-cutting utilities: profiling, logging, runtime configuration
(PyTorch port of :mod:`xmris_tpu.utils`, a re-export of the runtime
layer).
"""

from xmris_tpu_torch.runtime.config import (
    RuntimeConfig,
    config,
    default_complex_dtype,
    default_float_dtype,
    matching_dtypes,
)
from xmris_tpu_torch.runtime.logging import get_logger, set_log_level
from xmris_tpu_torch.runtime.profiling import Timings, stage_timer, trace

__all__ = [
    "RuntimeConfig",
    "Timings",
    "config",
    "default_complex_dtype",
    "default_float_dtype",
    "get_logger",
    "matching_dtypes",
    "set_log_level",
    "stage_timer",
    "trace",
]
