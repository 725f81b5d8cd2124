"""host_wait_ms: host ms per request blocked in the program's host reads
(``runtime/profiling.py::to_host``: the LM's done mask, ``fit_amares``'s
and ``mrsi_pipeline``'s copies to the host), the span ``host.wait`` over
the traced run's profiled part (layer: host dispatch)."""

KIND = "profile"
SPAN = "host.wait"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["host_ms"] is None:
        return None
    return got["host_ms"] / trace.profile_requests
