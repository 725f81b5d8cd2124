"""xmris_tpu_torch: the PyTorch/CUDA port of xmris_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``xmris_tpu``, with the same
module paths.  It imports torch and numpy, never jax; its hand-written CUDA
kernels (``ops/kernels/csrc``) build on first use on a machine with nvcc
and an sm_90 card, and every kernel has a plain PyTorch twin that runs on
CPU tensors.

The ported slice is the fused per-grid program
:func:`xmris_tpu_torch.parallel.process.process_grid_planar_raw`.
"""

__version__ = "0.1.0"
