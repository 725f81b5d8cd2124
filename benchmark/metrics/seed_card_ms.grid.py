"""seed_card_ms.grid: card ms per request in the grid fit's seeding
(amplitude rescaling, the shared-basis LS seed, the bound transform), from
the program's span ``fit.seed`` around ``seed_grid`` in
``fitting/amares.py::seeded_fit_grid_raw``: CUDA events at the span's
edges, no sync, over the traced run's profiled part (layer: fit)."""

KIND = "profile"
SPAN = "fit.seed"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
