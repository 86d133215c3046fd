"""Collectives over a mesh axis: ``psum``, ``pmax``, ``all_gather``,
``ppermute``, ``all_to_all`` and the differentiable pairs of training.

The port's counterparts of ``jax.lax.psum``/``pmax``/``all_gather``/
``ppermute``/``all_to_all`` inside ``shard_map``, in two forms that one
call site serves:

- in process (a mesh without a process group, ``Axis.group`` None): the
  caller holds every shard's part along the axis, in shard order, and the
  result is formed on the first part's device: the sum adds the parts one
  after another in shard order, the maximum stacks them;
- over a process group (one process a mesh slot, ``Mesh.axis`` of a
  process-group mesh): the caller holds its own part only, and the axis's
  ``torch.distributed`` subgroup (the ranks along the caller's line of the
  axis, in axis order) carries the rest.  ``all_gather`` gathers the parts
  in shard order; ``psum`` gathers them and adds them in shard order as the
  in-process form does, so a sum over processes is bit-equal to the same
  sum in one process (a ring ``all_reduce`` would add in another order);
  ``pmax`` is an ``all_reduce(MAX)``, exact in any order; ``ppermute`` is
point-to-point (``batch_isend_irecv``) and ``all_to_all`` an
``all_to_all_single``.

Over a process group the collectives are differentiable, each with JAX's
transpose, and so are the training pairs that only a process group needs
(in process, where one autograd graph spans every shard, ``.to`` does it):

- ``psum``: the backward is the identity (a sum that every rank holds, so
  its gradient is the same on every rank: a row-parallel output);
- ``pvary``: identity forward, ``psum`` backward (a value every rank holds
  going into work that differs by rank: a column-parallel input);
- ``all_gather``: the backward sums the gradients in shard order and keeps
  the caller's piece (a reduce-scatter: sequence parallelism), and
  ``all_gather_invariant`` (JAX's name) keeps the caller's piece only (a
  gathered value that every rank then uses alike), and ``piece`` (the
  caller's piece of a value every rank holds) is its transpose;
- ``psum_scatter``: the caller's piece of the sum, its backward an
  ``all_gather``;
- ``ppermute``: the backward sends the gradients back (the inverse
  permutation); ``all_to_all``: the inverse ``all_to_all``.

Every rank of a line gets the same result.  On NCCL the collectives are
device work that a CUDA graph captures (the communicator must have run
once eagerly: a compiled step's first call does).  Gloo carries CPU
tensors; a CUDA tensor on a gloo group is staged through the host
explicitly (copied out, gathered or reduced on the host, copied back), which
synchronises with the device and so cannot be captured:
``capture_refusal`` names such an axis.  ``CALLS`` counts the calls of each
collective in its process-group form, a backward's under its forward's
name (a graph's replay adds none).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence

import torch

__all__ = ["Axis", "LOCAL", "psum", "pmax", "all_gather", "all_gather_invariant", "piece", "pvary",
           "psum_scatter", "ppermute", "all_to_all", "psum_gradients", "capture_refusal",
           "CALLS"]

#: process-group calls a collective: {"psum": n, "pmax": n, "all_gather": n, ...}
CALLS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis as one process sees it: its ``size``, the ``index`` of
    the process's first shard along it (0 in process, where every shard is
    local) and its line's process ``group`` (None in process)."""

    size: int = 1
    index: int = 0
    group: Optional[object] = None


#: an in-process axis; its size is the number of parts a call passes
LOCAL = Axis()


def _backend(group) -> str:
    import torch.distributed as dist
    return dist.get_backend(group)


def _staged(x: torch.Tensor, axis: Axis) -> bool:
    """Whether ``x`` goes through the host: a CUDA tensor on a gloo group."""
    return x.device.type == "cuda" and _backend(axis.group) == "gloo"


def _raw(x: torch.Tensor, host: bool) -> torch.Tensor:
    """``x``'s bytes as a flat uint8 tensor (gloo carries any dtype so), on
    the host where ``host``."""
    x = x.detach().contiguous()
    return (x.cpu() if host else x).reshape(-1).view(torch.uint8)


def _cooked(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return raw.view(like.dtype).reshape(like.shape).to(like.device)


def _gathered(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``'s group, in rank order, on ``x``'s
    device.  Gloo gathers raw bytes on the host (any dtype)."""
    import torch.distributed as dist

    x = x.detach().contiguous()
    if _backend(axis.group) == "gloo":
        raw = _raw(x, True)
        out = [torch.empty_like(raw) for _ in range(axis.size)]
        dist.all_gather(out, raw, group=axis.group)
        return [_cooked(t, x) for t in out]
    out = torch.empty((axis.size, *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return list(out.unbind(0))


def _exchanged(pieces: Sequence[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """``pieces[k]`` sent to rank ``k`` of ``axis``'s group, and what every
    rank sent the caller, in rank order (``all_to_all_single``; the pieces
    share a shape and dtype)."""
    import torch.distributed as dist

    like = pieces[0]
    host = _backend(axis.group) == "gloo"
    src = torch.stack([_raw(p, host) for p in pieces])
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    return [_cooked(t, like) for t in out.unbind(0)]


def _sent(x: torch.Tensor, axis: Axis, perm) -> Optional[torch.Tensor]:
    """``x`` sent along the pairs ``(src, dst)`` of ``perm`` that name the
    caller (indices along ``axis``), and what the caller receives, None
    where no pair ends at it.  Only the pairs' ranks take part."""
    import torch.distributed as dist

    me, host = axis.index, _staged(x, axis)
    ops, got, out = [], None, None
    for src, dst in perm:
        if src == me and dst == me:
            got = x.detach().clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, _raw(x, host),
                                  dist.get_global_rank(axis.group, dst), axis.group))
        elif dst == me:
            out = torch.empty_like(_raw(x, host))
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(axis.group, src),
                                  axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _cooked(out, x) if out is not None else got


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts added one after another in shard order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _one(parts: Sequence[torch.Tensor], axis: Axis) -> torch.Tensor:
    if len(parts) != 1:
        raise ValueError(f"{len(parts)} parts on a process-group axis: a rank passes its own")
    return parts[0]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        CALLS["psum"] += 1
        return _sum(_gathered(x, axis))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        CALLS["psum"] += 1
        return _sum(_gathered(g, ctx.axis)), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, invariant):
        CALLS["all_gather"] += 1
        ctx.axis, ctx.invariant = axis, invariant
        return tuple(_gathered(x, axis))

    @staticmethod
    def backward(ctx, *gs):
        axis = ctx.axis
        if ctx.invariant:
            return gs[axis.index], None, None
        CALLS["psum_scatter"] += 1
        return _sum(_exchanged(gs, axis)), None, None


class _Piece(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.chunk(axis.size, dim)[axis.index]

    @staticmethod
    def backward(ctx, g):
        CALLS["all_gather"] += 1
        return torch.cat(_gathered(g, ctx.axis), ctx.dim), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        CALLS["psum_scatter"] += 1
        ctx.axis, ctx.dim = axis, dim
        return _sum(_exchanged(x.chunk(axis.size, dim), axis))

    @staticmethod
    def backward(ctx, g):
        CALLS["all_gather"] += 1
        return torch.cat(_gathered(g, ctx.axis), ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        CALLS["ppermute"] += 1
        ctx.axis, ctx.perm = axis, perm
        got = _sent(x, axis, perm)
        return torch.zeros_like(x) if got is None else got

    @staticmethod
    def backward(ctx, g):
        CALLS["ppermute"] += 1
        got = _sent(g, ctx.axis, tuple((dst, src) for src, dst in ctx.perm))
        return (torch.zeros_like(g) if got is None else got), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        CALLS["all_to_all"] += 1
        ctx.axis, ctx.dims = axis, (split_axis, concat_axis)
        return torch.cat(_exchanged(x.chunk(axis.size, split_axis), axis), concat_axis)

    @staticmethod
    def backward(ctx, g):
        CALLS["all_to_all"] += 1
        split_axis, concat_axis = ctx.dims
        return (torch.cat(_exchanged(g.chunk(ctx.axis.size, concat_axis), ctx.axis), split_axis),
                None, None, None)


def all_gather(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> List[torch.Tensor]:
    """Every shard's part along ``axis`` in shard order, each on the device
    of the caller's first part: in process ``parts`` are all of them; over a
    process group ``parts`` is the caller's own one, and the gradient of
    the caller's part is the sum over the ranks of their gradients of its
    piece (a reduce-scatter, JAX's transpose)."""
    if axis.group is None:
        dev = parts[0].device
        return [p.to(dev) for p in parts]
    return list(_AllGather.apply(_one(parts, axis), axis, False))


def all_gather_invariant(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """``all_gather`` of the caller's ``x`` over a process group whose
    result every rank then uses alike (a whole output that each rank
    holds): the gradient of ``x`` is the caller's piece of the result's
    gradient, which is the same on every rank (JAX's
    ``all_gather_invariant``).  In process: ``[x]``."""
    if axis.group is None:
        return [x]
    return list(_AllGather.apply(x, axis, True))


def piece(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The caller's piece (its index along ``axis`` of ``axis.size`` equal
    pieces of ``dim``) of ``x``, which every rank holds alike; backward,
    the pieces' gradients gathered (``shard_map``'s in-spec, whose gradient
    is the whole array's: the transpose of ``all_gather_invariant``).  In
    process: ``x``."""
    return x if axis.group is None else _Piece.apply(x, axis, dim)


def psum(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> torch.Tensor:
    """The sum over ``axis`` of the shards' parts, added in shard order on
    the device of the caller's first part (one part is returned as it is).
    Over a process group the result's gradient passes to the caller's part
    as it is: every rank holds the sum and the same gradient of it."""
    if axis.group is not None:
        return _PSum.apply(_one(parts, axis), axis)
    return _sum(all_gather(parts))


def pvary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, which every rank of ``axis`` holds alike, going into work that
    differs by rank: the identity forward, a ``psum`` of the gradients
    backward (Megatron's column-parallel input).  In process: ``x``."""
    return x if axis.group is None else _PVary.apply(x, axis)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The caller's piece (its index along ``axis`` of ``axis.size`` equal
    pieces of ``dim``) of the sum over the ranks of ``x``, added in shard
    order; backward, the gradients' ``all_gather`` (sequence
    parallelism's reduce-scatter).  In process: ``x``."""
    if axis.group is None:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axis.size} ranks")
    return _PSumScatter.apply(x, axis, dim)


def ppermute(parts: Sequence[torch.Tensor], axis: Axis = LOCAL, perm=()) -> List[torch.Tensor]:
    """JAX's ``ppermute``: shard ``dst`` receives shard ``src``'s part for
    every ``(src, dst)`` of ``perm``, zeros where no pair ends at it.  In
    process ``parts`` are every shard's and each arrives on its new slot's
    device; over a process group ``parts`` is the caller's own, sent point
    to point (only the ranks a pair names take part; a pair from the caller
    to itself is a copy), and its gradient is sent back along the inverse
    permutation."""
    perm = tuple((int(a), int(b)) for a, b in perm)
    if axis.group is not None:
        return [_PPermute.apply(_one(parts, axis), axis, perm)]
    src = {b: a for a, b in perm}
    return [parts[src[i]].to(x.device) if i in src else torch.zeros_like(x)
            for i, x in enumerate(parts)]


def all_to_all(parts: Sequence[torch.Tensor], axis: Axis = LOCAL, split_axis: int = 0,
               concat_axis: int = 0) -> List[torch.Tensor]:
    """JAX's tiled ``all_to_all``: shard ``j`` receives piece ``j`` (along
    ``split_axis``) of every shard's part, concatenated in shard order along
    ``concat_axis``, on its own device.  In process ``parts`` are every
    shard's; over a process group the caller's own, and the backward is the
    inverse ``all_to_all``."""
    if axis.group is not None:
        return [_AllToAll.apply(_one(parts, axis), axis, split_axis, concat_axis)]
    pieces = [x.chunk(len(parts), split_axis) for x in parts]
    return [torch.cat([p[j].to(dst.device) for p in pieces], concat_axis)
            for j, dst in enumerate(parts)]


def pmax(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> torch.Tensor:
    """The elementwise maximum over ``axis`` of the shards' parts, on the
    device of the caller's first part."""
    if axis.group is None:
        return torch.stack(all_gather(parts)).amax(dim=0)
    import torch.distributed as dist

    CALLS["pmax"] += 1
    x = _one(parts, axis)
    out = x.detach().cpu() if _staged(x, axis) else x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out.to(x.device)


@torch.no_grad()
def psum_gradients(params: Sequence[torch.Tensor], axes: Sequence[Axis]) -> None:
    """Each of ``params``' gradients (zeros where None) summed over every
    one of ``axes`` in turn, in shard order, in place: one ``psum`` an axis
    of all of them at once, so that every rank issues the same collectives
    in the same order whatever order its backward ran in."""
    if not params or not axes:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    for axis in axes:
        flat = psum([flat], axis)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        if p.grad is None:
            p.grad = g.view_as(p).clone()
        else:
            p.grad.copy_(g.view_as(p))


def capture_refusal(axes: Sequence[Axis], device) -> Optional[str]:
    """Why a CUDA graph on ``device`` cannot capture collectives over
    ``axes``, or None where it can (no process group, the CPU, or NCCL)."""
    if torch.device(device).type != "cuda":
        return None
    for axis in axes:
        if axis.group is not None and _backend(axis.group) != "nccl":
            return (f"a {_backend(axis.group)} process group stages its collectives through "
                    f"the host, which a CUDA graph cannot capture: run this rank's steps "
                    f"eagerly (each compiled step set back to its _*_impl, a callable's "
                    f".eager), or start the group on NCCL")
    return None
