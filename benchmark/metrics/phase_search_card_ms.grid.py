"""phase_search_card_ms.grid: card ms per request in the single-pivot phase
search (the grid search's graph replay and its polish), from the program's
span ``spectral.phase_search`` in ``parallel/planar_pipeline.py::
_autophase_single_planar``: CUDA events at the span's edges, no sync, over
the traced run's profiled part (layer: spectral stage)."""

KIND = "profile"
SPAN = "spectral.phase_search"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
