"""kernels_per_grid: the device kernels launched per request in the
profiled window (``torch.profiler`` CUDA kernel events, copies and memsets
left out), which counts the eager torch glue around the hand-written
kernels (layer: host dispatch).  Wraps nothing."""

KIND = "profile"


def read(trace):
    return trace.kernels_per_request()
