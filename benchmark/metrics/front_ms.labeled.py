"""front_ms.labeled: ms per request in the labeled front-end, a synced
span around ``parallel/pipeline.py::mrsi_pipeline`` (layer: labeled
front-end)."""

KIND = "span"
WRAPS = ("xmris_tpu_torch.parallel.pipeline:mrsi_pipeline",)


def read(trace):
    return trace.span_ms(WRAPS)
