"""Device meshes and voxel sharding: the port's scale-out substrate.

Port of :mod:`xmris_tpu.parallel.mesh`.  The reference shards the voxel
axis over a ``jax.sharding.Mesh`` and runs each shard under
``shard_map``, from one Python process.  The port keeps that shape: one
process drives a 1-D :class:`Mesh` of ``torch.device`` entries, each shard
runs on its device, each distinct device in a host thread of its own
(:func:`run_on_devices`), and the results come back as whole tensors on
the mesh's first device.  The
only communication the math needs, the single-pivot autophase election,
is a copy of one small candidate per shard onto that device.

A mesh may name one device more than once: ``Mesh([torch.device("cpu")] *
8)`` is the counterpart of the reference tests' eight virtual CPU devices,
and ``Mesh([torch.device("cuda", 0)] * 4)`` splits a grid into four
shards on one card (they share its stream and run one after another).
:func:`make_mesh` never repeats a CUDA device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

GRID_AXIS = "grid"

# A host thread per shard in :func:`run_on_devices` instead of one per
# distinct device: the variant that ``scripts/ablate_mesh_threads.py``
# measures against the shipped runner.  Off everywhere else.
THREAD_PER_SHARD = False


class Mesh:
    """An n-D array of ``torch.device`` entries with one name per axis
    (the reference's ``jax.sharding.Mesh``).

    ``devices`` is any nesting of devices or device strings; ``.devices``
    is the object array, ``.shape`` maps each axis name to its size,
    ``.size`` is the number of entries and ``.axis_names`` the names.
    """

    def __init__(self, devices, axis_names=(GRID_AXIS,)):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"Mesh of shape {self.devices.shape} needs {self.devices.ndim} "
                f"axis names, got {self.axis_names}.")
        if self.devices.size == 0:
            raise ValueError("A Mesh needs at least one device.")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name: str = GRID_AXIS) -> list[torch.device]:
        """The devices along ``axis_name`` (index 0 on every other axis), in
        mesh order: where the shards of that axis go."""
        if axis_name not in self.axis_names:
            raise ValueError(f"Mesh has axes {self.axis_names}, not {axis_name!r}.")
        ax = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[ax] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()!r}, axis_names={self.axis_names!r})"


@dataclass(frozen=True)
class Sharding:
    """Where a tensor's axes go on a mesh (the reference's
    ``NamedSharding``): ``spec[i]`` names the mesh axis that splits axis
    ``i``, or is None where that axis is whole on every device; an empty
    ``spec`` replicates."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(n_devices: int | None = None, axis_name: str = GRID_AXIS,
              device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of a kind.

    ``device="cuda"`` takes CUDA devices 0 .. n-1 (all of them for
    ``None``) and raises ``ValueError`` past ``torch.cuda.device_count()``,
    as the reference does past ``jax.devices()``; ``"cpu"`` takes
    ``n_devices`` entries of the CPU device (one for ``None``).  The voxel
    axis of every sharded entry point splits over this axis.
    """
    kind = torch.device(device).type
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}.")
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), (axis_name,))
    if kind != "cuda":
        raise ValueError(f"make_mesh: device must be 'cuda' or 'cpu', got {device!r}.")
    available = torch.cuda.device_count()
    n = available if n_devices is None else n_devices
    if n > available or n == 0:
        raise ValueError(
            f"Requested {n if n_devices is not None else 'all'} devices but only "
            f"{available} available.")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


def voxel_sharding(mesh: Mesh, ndim: int, axis_name: str = GRID_AXIS) -> Sharding:
    """Split the leading (voxel) axis over ``axis_name``, the rest whole."""
    return Sharding(mesh, (axis_name,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_voxels(array, mesh: Mesh, axis_name: str = GRID_AXIS) -> list:
    """The (batch, ...) ``array`` split on its batch axis over ``axis_name``:
    one tensor per device, on that device, in mesh order.  The batch must
    divide by the axis size (pad with :func:`pad_to_multiple` first)."""
    devices = mesh.axis_devices(axis_name)
    array = torch.as_tensor(array)
    n = len(devices)
    if array.shape[0] % n:
        raise ValueError(
            f"Voxel batch ({array.shape[0]}) must divide by the mesh axis "
            f"({n}); pad with pad_to_multiple first.")
    return [part.to(dev) for part, dev in zip(array.chunk(n), devices)]


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def edge_pad_rows(array, n_rows: int):
    """Edge-repeat a (B, ...) tensor's leading axis up to ``n_rows``.

    The shard divisibility padding: pad voxels are copies of the last
    row, so per-voxel work on them is valid (the caller trims their
    results).  Returns ``array`` itself when it is already that long.
    """
    short = n_rows - array.shape[0]
    if short <= 0:
        return array
    return torch.cat([array, array[-1:].expand(short, *array.shape[1:])])


def run_on_devices(fn, devices, per_shard_args):
    """``[fn(*args) for args in per_shard_args]``, shard ``i`` on
    ``devices[i]`` (under ``torch.cuda.device`` for a CUDA device).

    Shards on one device run one after another: they share its stream,
    and on one H100 a host thread per shard measured 3.3x slower than
    the shards in turn at 4 shards of the bench grid
    (``scripts/ablate_mesh_threads.py``).  Each distinct device gets a host
    thread of its own, so that shards on different cards overlap their
    host loops (the LM syncs once an iteration); a mesh of one distinct
    device runs on the calling thread.  Every thread is joined, and the
    first shard that raised re-raises here: a failed shard fails the call.
    With :data:`THREAD_PER_SHARD` set, every shard gets a thread of its own
    (the ablation's runner).
    """
    groups: dict = {}
    for i, dev in enumerate(devices):
        groups.setdefault(i if THREAD_PER_SHARD else dev, (dev, []))[1].append(i)
    results = [None] * len(devices)

    def run_group(dev, shards):
        for i in shards:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    results[i] = fn(*per_shard_args[i])
            else:
                results[i] = fn(*per_shard_args[i])

    if len(groups) == 1:
        run_group(*next(iter(groups.values())))
        return results
    errors = []

    def work(dev, shards):
        try:
            run_group(dev, shards)
        except BaseException as exc:  # re-raised on the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=work, args=item, daemon=True)
               for item in groups.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results


def gather(parts, device):
    """Concatenate per-shard results on their leading axis onto ``device``:
    tensors, and tuples / named tuples of them (``None`` stays None)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    fields = [gather([p[i] for p in parts], device) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def map_shards(fn, mesh: Mesh, sharded, replicated_args=(),
               axis_name: str = GRID_AXIS):
    """Run ``fn(*shards, *replicated_args)`` once per device along
    ``axis_name`` (the reference's ``shard_map`` with voxel-sharded and
    replicated inputs): every tensor of ``sharded`` is split on its
    leading axis (:func:`shard_voxels`), every tensor of
    ``replicated_args`` copied whole to each device (anything else passes
    as is).  Returns the shards' results gathered on the mesh's first
    device (:func:`gather`)."""
    devices = mesh.axis_devices(axis_name)
    split = [shard_voxels(a, mesh, axis_name) for a in sharded]
    per_shard = []
    for i, dev in enumerate(devices):
        rep = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in replicated_args)
        per_shard.append(tuple(s[i] for s in split) + rep)
    return gather(run_on_devices(fn, devices, per_shard), devices[0])
