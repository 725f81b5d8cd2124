"""The kernel LM sharded over a voxel mesh (PyTorch port).

Port of :mod:`xmris_tpu.parallel.fit`.  Each shard of the voxel batch runs
:func:`~xmris_tpu_torch.fitting.lm.lm_fit_batched_pallas` on its device in
a host thread per distinct device (:func:`~xmris_tpu_torch.parallel.mesh.map_shards`),
with no communication between shards, and each shard's loop exits as soon
as *its* voxels converge.  Converged voxels stop updating, so the loop
lengths of the shards cannot change any voxel's solution: with kernels
that work voxel by voxel (K2, K3, K6a, K8, K9) the result equals the
single launch's.
"""

from __future__ import annotations

from xmris_tpu_torch.fitting.lm import (
    _t_is_uniform,
    check_kernel_version,
    lm_fit_batched_pallas,
)
from xmris_tpu_torch.ops.kernels import DISPATCH
from xmris_tpu_torch.parallel.mesh import GRID_AXIS, Mesh, map_shards


def lm_fit_batched_pallas_sharded(
    fids_re,
    fids_im,
    t,
    u0,
    lower,
    upper,
    kind,
    pmap_static,
    mhz: float,
    mesh: Mesh,
    axis_name: str = GRID_AXIS,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
    v_tile: int | None = None,
    interpret: bool = False,
    kernel_version: int = 9,
    return_hessian: bool = False,
    *,
    kernels=DISPATCH,
):
    """The kernel LM with the voxel axis split over ``mesh``.

    ``fids_re``/``fids_im``/``u0`` split on their leading (voxel) axis,
    which must divide by the mesh axis; ``t``/``lower``/``upper``/``kind``
    go whole to every device; a (F,) ``u0`` is broadcast to every voxel.
    Semantics are :func:`~xmris_tpu_torch.fitting.lm.lm_fit_batched_pallas`'s,
    and the result is whole on the mesh's first device: the
    :class:`~xmris_tpu_torch.fitting.lm.LMResult`, or with
    ``return_hessian=True`` ``(LMResult, h_ext)`` with the (B, F, F)
    Gauss-Newton Hessian.  ``return_hessian="slab"`` raises ``ValueError``
    (per-shard slabs do not concatenate into one).  The uniformity of
    ``t``, which selects v9's factored basis and which v7 requires, is
    checked once, before any shard starts.  ``v_tile`` and ``interpret``
    (TPU tiling, Pallas interpret mode) are accepted and have no
    counterpart: CPU tensors take the kernels' plain versions.
    """
    del v_tile, interpret
    if not isinstance(return_hessian, bool):
        raise ValueError(
            "lm_fit_batched_pallas_sharded supports return_hessian="
            "True/False only (the slab layout does not concatenate "
            "across shards); use crlb_from_hessian on the (B, F, F) "
            "Hessian instead")
    check_kernel_version(kernel_version)
    if u0.ndim == 1:
        u0 = u0[None, :].expand(fids_re.shape[0], u0.shape[0])
    t_uniform = _t_is_uniform(t)
    if kernel_version == 7 and fids_re.shape[-1] % 128 == 0 and not t_uniform:
        raise ValueError(
            "kernel_version=7 requires a uniformly sampled time axis; "
            "got non-uniform spacing. Use kernel_version=6/8 instead.")

    def per_shard(re, im, u, t, lower, upper, kind):
        return lm_fit_batched_pallas(
            re, im, t, u, lower, upper, kind, pmap_static, mhz,
            max_iter=max_iter, lam0=lam0, ftol=ftol,
            kernel_version=kernel_version, return_hessian=return_hessian,
            require_uniform_t=t_uniform, kernels=kernels)

    return map_shards(per_shard, mesh, (fids_re, fids_im, u0),
                      (t, lower, upper, kind), axis_name)
