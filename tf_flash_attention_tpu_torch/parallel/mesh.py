"""Device meshes (PyTorch port of the JAX package's ``parallel/mesh.py``).

A ``Mesh`` names the axes of an array of devices, as ``jax.sharding.Mesh``
does, in one of two modes.

Single-controller (no process group, or a ``devices`` list whose length
is not the world size): one process drives every device of the mesh.
Devices may repeat: a ``seq`` axis of four shards on one card (``cuda:0``
four times) or on the CPU (``"cpu"`` four times) runs the same code as four
cards.  ``shard`` and ``unshard`` stand in for ``shard_map``'s in and out
specs: they split a tensor into the blocks a ``PartitionSpec`` gives, each
on its device, and put them back together; both are differentiable, so
gradients flow back to the whole tensor.

Over a process group (``jax.distributed``'s multi-controller mode): with
``torch.distributed`` up, ``make_mesh`` covers ``world_size`` slots, one a
rank in rank order, and every process runs the same program on its own
slot's shards.  ``Mesh.ranks`` holds each slot's rank (as a JAX device
carries its ``process_index``); ownership goes by rank, never by device,
since ranks may share a card.  ``coords`` gives the caller's slot,
``axis`` the caller's view of an axis (its size, the caller's index and
the ``torch.distributed`` subgroup of the caller's line, made once by
``make_mesh`` for every line of every axis) for ``collectives.py``;
``shard`` returns the caller's block only, and ``unshard`` gathers; both
are differentiable there too (the gradient of a block is gathered into the
whole tensor's, and that of the gathered whole is the caller's block of
it), so the training steps and the attention callables run unchanged in
form with one block a process.
``maybe_init_distributed`` starts the process group where the environment
configures one, as the JAX package's starts ``jax.distributed``, and binds
the process to its card (``cuda:{LOCAL_RANK}``), as ``jax.distributed``
gives a process its own local devices; ``make_mesh`` over an NCCL group
runs one collective and one point-to-point exchange on every subgroup the
caller belongs to, so that each communicator exists before a CUDA graph
captures its first collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard", "unshard", "maybe_init_distributed", "AXIS_DATA",
           "AXIS_MODEL", "AXIS_CONTEXT"]

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"


#: how long a process group's rank waits on the others (at the start, and
#: in a collective) before it fails: a hung collective ends the run
DIST_TIMEOUT = datetime.timedelta(minutes=5)


def maybe_init_distributed() -> bool:
    """Start ``torch.distributed`` when the environment configures a
    process group (the JAX package's ``maybe_init_distributed``, which
    starts ``jax.distributed``): NCCL where CUDA is available, else gloo.
    ``COORDINATOR_ADDRESS`` (``host:port``, the JAX variable) with
    ``WORLD_SIZE`` and ``RANK`` (1 and 0 where unset), or torchrun's
    ``MASTER_ADDR`` and its companions (``env://``).  Where CUDA is
    available the process is bound to its card first (``_local_device``:
    ``cuda:{LOCAL_RANK}``, made the current device and the group's
    ``device_id``), so that NCCL, the object collectives and every kernel
    launch find it; on the CPU the device is left alone.  The group fails
    a rank that waits longer than ``DIST_TIMEOUT``.  Call once at program
    start in every process.  Returns True when a process group is up
    (already, or now), False when nothing is configured."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator and not os.environ.get("MASTER_ADDR"):
        return False
    rank = int(os.environ.get("RANK", "0"))
    cuda = torch.cuda.is_available()
    kw = dict(backend="nccl" if cuda else "gloo", timeout=DIST_TIMEOUT)
    if cuda:
        kw["device_id"] = _local_device(rank)
        torch.cuda.set_device(kw["device_id"])
    if coordinator:
        dist.init_process_group(init_method=f"tcp://{coordinator}",
                                world_size=int(os.environ.get("WORLD_SIZE", "1")), rank=rank, **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one axis per
    name in ``axis_names``.  Over a process group, ``ranks`` holds the rank
    of each slot (the same shape) and ``groups`` the caller's line of each
    axis as a subgroup; both are None and empty in a single-controller
    mesh."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: Optional[np.ndarray] = None
    groups: Dict[str, object] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def process_group(self) -> bool:
        """Whether the mesh spans processes, one a slot."""
        return self.ranks is not None

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

    def local_grid(self, *axes: str):
        """``grid`` as the caller drives it: all of it single-controller;
        over a process group the caller's device alone, nested as deep."""
        if not self.process_group:
            return self.grid(*axes)
        out = self.device
        for _ in axes:
            out = [out]
        return out

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The index along every axis of ``rank``'s slot (the caller's by
        default); every index is 0 in a single-controller mesh."""
        if self.ranks is None:
            return {a: 0 for a in self.axis_names}
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank()
        at = np.argwhere(self.ranks == rank)
        if not len(at):
            raise ValueError(f"rank {rank} holds no slot of the mesh")
        return {a: int(i) for a, i in zip(self.axis_names, at[0])}

    @property
    def device(self) -> torch.device:
        """The caller's device: its slot's over a process group, the first
        slot's in a single-controller mesh."""
        c = self.coords()
        return self.devices[tuple(c[a] for a in self.axis_names)]

    def local_devices(self):
        """The devices the caller drives: all of them, or its slot's."""
        return [self.device] if self.process_group else list(self.devices.flat)

    def axis(self, name: str):
        """``name`` as the caller sees it (``collectives.Axis``): its size,
        the caller's index along it and its line's subgroup (0 and None in a
        single-controller mesh; an axis the mesh lacks is size 1)."""
        from .collectives import Axis
        size = int(self.shape.get(name, 1))
        if self.ranks is None or name not in self.axis_names:
            return Axis(size)
        return Axis(size, self.coords()[name], self.groups[name])

    def capture_refusal(self) -> Optional[str]:
        """Why the caller's steps on this mesh cannot be captured as CUDA
        graphs (a gloo group on a CUDA device), or None."""
        from .collectives import capture_refusal
        return capture_refusal([self.axis(a) for a in self.axis_names], self.device)


def _world_size() -> Optional[int]:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else None


def _local_device(rank: Optional[int] = None) -> torch.device:
    """This process's device over a process group: ``cuda:{LOCAL_RANK}``
    where CUDA is present (LOCAL_RANK defaulting to the rank, the group's
    when None, modulo the visible cards), else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    if local is None and rank is None:
        import torch.distributed as dist
        rank = dist.get_rank()
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def _warm_up(groups, device) -> None:
    """One ``all_reduce`` and one ring exchange (``batch_isend_irecv``, every
    rank of the group taking part, as NCCL wants of a group's first
    point-to-point call) on each of the caller's ``groups``, in axis order,
    on ``device``: NCCL makes a subgroup's communicator at its first call,
    which must not come inside a CUDA graph's capture."""
    import torch.distributed as dist

    for group in groups:
        x = torch.zeros(1, device=device)
        dist.all_reduce(x, group=group)
        n = dist.get_world_size(group)
        if n > 1:
            me = dist.get_group_rank(group, dist.get_rank())
            y = torch.empty_like(x)
            peer = lambda i: dist.get_global_rank(group, i % n)
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer(me + 1), group),
                                               dist.P2POp(dist.irecv, y, peer(me - 1), group)]):
                req.wait()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _process_mesh(shape, axis_names, devices, world: int) -> Mesh:
    """A mesh of ``world`` slots, rank k at flat index k, with one subgroup
    for every line of every axis (every rank makes every group, in one
    order, as ``new_group`` requires)."""
    import torch.distributed as dist

    if devices is None:
        devices = [None] * world
        dist.all_gather_object(devices, str(_local_device()))
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ in rank")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the {world} ranks")
    ranks = np.arange(world).reshape(tuple(shape))
    me, groups = dist.get_rank(), {}
    for i, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines.tolist():
            group = dist.new_group(line)
            if me in line:
                groups[name] = group
    if dist.get_backend() == "nccl":
        _warm_up([groups[name] for name in axis_names], devices[me])
    arr = np.empty(world, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names), ranks, groups)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = (AXIS_DATA, AXIS_MODEL),
              devices=None) -> Mesh:
    """Build a mesh over ``devices`` (every CUDA card when None).

    ``shape=None`` puts all devices on the first axis.  Axis sizes must
    multiply to the device count.  With ``torch.distributed`` up and
    ``devices`` None or of the world's length, the mesh spans the
    processes: one slot a rank, each slot's device ``devices[rank]`` or,
    when None, the rank's own (``cuda:{LOCAL_RANK}``, else the CPU); this
    is a collective call (it makes the axes' subgroups), so every rank
    calls it with the same shape and axes.
    """
    world = _world_size()
    if world is not None and (devices is None or len(devices) == world):
        return _process_mesh(shape, axis_names, devices, world)
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
    must divide by its axis size.  Over a process group: the caller's own
    block, on its device, whose gradient is gathered into ``x``'s on every
    rank (``x`` is the same on every rank, as JAX's global arrays)."""
    axes = _split_axes(spec)
    for axis, dim in axes:
        n = int(mesh.shape.get(axis, 1))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by the "
                             f"{axis!r} axis size {n}")
    if mesh.process_group:
        from .collectives import piece
        for axis, dim in axes:
            x = piece(x, mesh.axis(axis), dim)
        return x.to(mesh.device)

    def split(t, level, devs):
        if level == len(axes):
            return t.to(devs)
        return [split(p, level + 1, d) for p, d in zip(t.chunk(len(devs), axes[level][1]), devs)]

    return split(x, 0, mesh.grid(*(a for a, _ in axes)))


def unshard(blocks, spec: Sequence[Optional[str]], device, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """The tensor whose ``shard`` under ``spec`` is ``blocks``, on ``device``.
    Over a process group (``mesh`` one), ``blocks`` is the caller's block
    and every rank gathers the whole; the gradient of the block is the
    caller's block of the whole's gradient (the same on every rank)."""
    axes = _split_axes(spec)
    if mesh is not None and mesh.process_group:
        from .collectives import all_gather_invariant
        x = blocks
        for axis, dim in reversed(axes):
            x = torch.cat(all_gather_invariant(x, mesh.axis(axis)), dim=dim)
        return x.to(device)

    def join(b, level):
        if level == len(axes):
            return b.to(device)
        return torch.cat([join(p, level + 1) for p in b], dim=axes[level][1])

    return join(blocks, 0)
