"""spectral_card_ms.grid: card ms per request in the spectral stage of the
fused grid program (K1, the pivot search), from the program's span
``spectral`` around ``parallel/planar_pipeline.py::
spectral_pipeline_planar_raw``: CUDA events at the span's edges, no sync,
over the traced run's profiled part (layer: spectral stage).  The synced
twin from outside is ``spectral_ms.grid``."""

KIND = "profile"
SPAN = "spectral"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
