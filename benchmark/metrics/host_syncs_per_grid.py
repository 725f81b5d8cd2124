"""host_syncs_per_grid: host reads that wait for the card per request, the
program's counter ``host.syncs`` (``runtime/profiling.py::to_host``) over
the traced run's profiled part (layer: host dispatch)."""

KIND = "profile"
COUNTER = "host.syncs"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    n = snapshot()["counters"].get(COUNTER)
    if not trace.profile_requests or n is None:
        return None
    return n / trace.profile_requests
