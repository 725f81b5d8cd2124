"""device_idle_pct: the share of the profiled window in which no kernel or
copy ran on the card, from the union of the ``torch.profiler`` CUDA
activity intervals (layer: the device).  Wraps nothing."""

KIND = "profile"


def read(trace):
    return trace.idle_pct()
