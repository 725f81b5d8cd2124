"""crlb_card_ms.k12: card ms per request in the grid fit's CRLB at K = 12,
F = 48 (K4's wide factor on the LM's slab Hessian and the SD scaling), from
the program's span ``fit.crlb`` in ``fitting/amares.py::seeded_fit_grid_raw``:
CUDA events at the span's edges, no sync, over the traced run's profiled
part (layer: fit).  A program without the span reads nothing."""

KIND = "profile"
SPAN = "fit.crlb"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
