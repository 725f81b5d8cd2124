"""lm_card_ms.k12: card ms per request in the grid fit's LM at K = 12,
F = 48 (K2's wide build + K3's wide factor a trip, and the host read of
the done mask), from the program's span ``fit.lm`` in
``fitting/amares.py::seeded_fit_grid_raw``: CUDA events at the span's
edges, no sync, over the traced run's profiled part (layer: fit)."""

KIND = "profile"
SPAN = "fit.lm"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
