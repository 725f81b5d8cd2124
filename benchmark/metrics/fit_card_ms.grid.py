"""fit_card_ms.grid: card ms per request in the seeded fit of the fused grid
program (seeding, LM, CRLB), from the program's span ``fit`` around
``fitting/amares.py::seeded_fit_grid_raw``: CUDA events at the span's
edges, no sync, over the traced run's profiled part (layer: fit).  The
synced twin from outside is ``fit_ms.grid``."""

KIND = "profile"
SPAN = "fit"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
