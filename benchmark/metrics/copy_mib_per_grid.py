"""copy_mib_per_grid: MiB copied between host and card per request, the
program's counters ``host.d2h_bytes`` and ``host.h2d_bytes``
(``runtime/profiling.py::to_host`` / ``to_card``) summed, over the traced
run's profiled part (layer: host dispatch)."""

KIND = "profile"
COUNTERS = ("host.d2h_bytes", "host.h2d_bytes")


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = [n for c, n in snapshot()["counters"].items() if c in COUNTERS]
    if not trace.profile_requests or not got:
        return None
    return sum(got) / 2**20 / trace.profile_requests
