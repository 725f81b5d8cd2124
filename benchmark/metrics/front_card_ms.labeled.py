"""front_card_ms.labeled: card ms per request in the labeled front-end, from
the program's span ``front`` around ``parallel/pipeline.py::
mrsi_pipeline``: CUDA events at the span's edges, no sync, over the traced
run's profiled part (layer: labeled front-end).  The synced twin from
outside is ``front_ms.labeled``."""

KIND = "profile"
SPAN = "front"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
