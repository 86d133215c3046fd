"""Device meshes (PyTorch port of the JAX package's ``parallel/mesh.py``).

A ``Mesh`` names the axes of an array of devices, as ``jax.sharding.Mesh``
does.  The serving engine is single-controller, like the JAX one: one
process drives every device of the mesh, so a mesh is only placement, not
a process group.  Devices may repeat: a ``seq`` axis of four shards on one
card (``cuda:0`` four times) or on the CPU (``"cpu"`` four times) runs the
same code as four cards.  ``shard`` and ``unshard`` stand in for
``shard_map``'s in and out specs: they split a tensor into the blocks a
``PartitionSpec`` gives, each on its device, and put them back together;
both are differentiable, so gradients flow back to the whole tensor.
``maybe_init_distributed`` starts a ``torch.distributed`` process group
where the environment configures one, as the JAX package's starts
``jax.distributed``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard", "unshard", "maybe_init_distributed", "AXIS_DATA",
           "AXIS_MODEL", "AXIS_CONTEXT"]

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"


def maybe_init_distributed() -> bool:
    """Start ``torch.distributed`` when the environment configures a
    process group (the JAX package's ``maybe_init_distributed``, which
    starts ``jax.distributed``): NCCL where CUDA is available, else gloo.
    ``COORDINATOR_ADDRESS`` (``host:port``, the JAX variable) with
    ``WORLD_SIZE`` and ``RANK`` (1 and 0 where unset), or torchrun's
    ``MASTER_ADDR`` and its companions (``env://``).  Call once at program
    start in every process.  Returns True when a process group is up
    (already, or now), False when nothing is configured."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator and not os.environ.get("MASTER_ADDR"):
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(os.environ.get("WORLD_SIZE", "1")),
                                rank=int(os.environ.get("RANK", "0")))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one axis per
    name in ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, *axes: str):
        """The devices along ``axes`` as nested lists, the first axis
        outermost, at index 0 of every other axis; an axis the mesh lacks
        counts as size 1."""
        arr = self.devices[tuple(slice(None) if a in axes else 0 for a in self.axis_names)]
        names = [a for a in self.axis_names if a in axes]
        arr = np.transpose(arr, [names.index(a) for a in axes if a in names])
        for i, a in enumerate(axes):
            if a not in names:
                arr = np.expand_dims(arr, i)
        return arr.tolist()


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = (AXIS_DATA, AXIS_MODEL),
              devices=None) -> Mesh:
    """Build a mesh over ``devices`` (every CUDA card when None).

    ``shape=None`` puts all devices on the first axis.  Axis sizes must
    multiply to the device count.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ in rank")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def _split_axes(spec) -> Tuple[Tuple[str, int], ...]:
    """The (axis, tensor dim) pairs of a spec, in spec order."""
    return tuple((a, dim) for dim, a in enumerate(spec) if a is not None)


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]):
    """The blocks of ``x`` under ``spec`` (one mesh axis or None a dim of
    ``x``, as a ``PartitionSpec``): nested lists indexed by the spec's axes
    in spec order, each block on its device (index 0 of the axes the spec
    leaves out; an axis the mesh lacks counts as size 1).  Each split dim
    must divide by its axis size."""
    axes = _split_axes(spec)

    def split(t, level, devs):
        if level == len(axes):
            return t.to(devs)
        axis, dim = axes[level]
        if t.shape[dim] % len(devs):
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by the "
                             f"{axis!r} axis size {len(devs)}")
        return [split(p, level + 1, d) for p, d in zip(t.chunk(len(devs), dim), devs)]

    return split(x, 0, mesh.grid(*(a for a, _ in axes)))


def unshard(blocks, spec: Sequence[Optional[str]], device) -> torch.Tensor:
    """The tensor whose ``shard`` under ``spec`` is ``blocks``, on ``device``."""
    axes = _split_axes(spec)

    def join(b, level):
        if level == len(axes):
            return b.to(device)
        return torch.cat([join(p, level + 1) for p in b], dim=axes[level][1])

    return join(blocks, 0)
