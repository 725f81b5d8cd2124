"""Scale-out layer: device meshes, the fused per-grid program and the
labeled front-end, sharded over a voxel mesh (PyTorch port of
:mod:`xmris_tpu.parallel`)."""

from xmris_tpu_torch.parallel.fit import lm_fit_batched_pallas_sharded
from xmris_tpu_torch.parallel.mesh import (
    GRID_AXIS,
    make_mesh,
    replicated,
    shard_voxels,
    voxel_sharding,
)
from xmris_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    mrsi_pipeline,
    spectral_pipeline_raw,
)
from xmris_tpu_torch.parallel.process import (
    pinned_grid_program,
    process_grid_planar_raw,
)

__all__ = [
    "GRID_AXIS",
    "PipelineConfig",
    "lm_fit_batched_pallas_sharded",
    "make_mesh",
    "mrsi_pipeline",
    "pinned_grid_program",
    "process_grid_planar_raw",
    "replicated",
    "shard_voxels",
    "spectral_pipeline_raw",
    "voxel_sharding",
]
