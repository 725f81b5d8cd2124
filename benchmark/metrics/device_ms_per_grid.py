"""device_ms_per_grid: the card's busy time per request in the profiled
window, the union of the ``torch.profiler`` CUDA activity over the
requests profiled (layer: the device).  It does not follow the host's
speed, which sets the end-to-end times of host-bound cells.  Wraps
nothing."""

KIND = "profile"


def read(trace):
    if not trace.profile_requests or trace.busy_s is None:
        return None
    return 1e3 * trace.busy_s / trace.profile_requests
