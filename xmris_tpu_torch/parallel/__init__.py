"""The fused per-grid program and the labeled front-end (PyTorch port)."""

from xmris_tpu_torch.parallel.pipeline import PipelineConfig, mrsi_pipeline

__all__ = ["PipelineConfig", "mrsi_pipeline"]
