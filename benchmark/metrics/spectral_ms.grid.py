"""spectral_ms.grid: ms per request in the spectral stage of the fused
grid program, a synced span around
``parallel/planar_pipeline.py::spectral_pipeline_planar_raw`` as
``process_grid_planar_raw`` calls it (layer: spectral stage)."""

KIND = "span"
WRAPS = ("xmris_tpu_torch.parallel.process:spectral_pipeline_planar_raw",)


def read(trace):
    return trace.span_ms(WRAPS)
