"""Collectives over a mesh axis: ``psum``, ``pmax`` and ``all_gather``.

The port's counterparts of ``jax.lax.psum``/``pmax``/``all_gather`` inside
``shard_map``, in two forms that one call site serves:

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
  ``pmax`` is an ``all_reduce(MAX)``, exact in any order.

Every rank of a line gets the same result.  On NCCL the collectives are
device work that a CUDA graph captures (the communicator must have run
once eagerly: a compiled step's first call does).  Gloo carries CPU
tensors; a CUDA tensor on a gloo group is staged through the host
explicitly (copied out, gathered or reduced on the host, copied back), which
synchronises with the device and so cannot be captured:
``capture_refusal`` names such an axis.  ``CALLS`` counts the calls of each
collective in its process-group form (a graph's replay adds none).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence

import torch

__all__ = ["Axis", "LOCAL", "psum", "pmax", "all_gather", "capture_refusal", "CALLS"]

#: process-group calls a collective: {"psum": n, "pmax": n, "all_gather": n}
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


def _gathered(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``'s group, in rank order, on ``x``'s
    device.  Gloo gathers raw bytes on the host (any dtype)."""
    import torch.distributed as dist

    x = x.contiguous()
    if _backend(axis.group) == "gloo":
        host = x.detach().cpu()
        raw = host.reshape(-1).view(torch.uint8)
        out = [torch.empty_like(raw) for _ in range(axis.size)]
        dist.all_gather(out, raw, group=axis.group)
        return [t.view(x.dtype).reshape(x.shape).to(x.device) for t in out]
    out = torch.empty((axis.size, *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return list(out.unbind(0))


def _one(parts: Sequence[torch.Tensor], axis: Axis) -> torch.Tensor:
    if len(parts) != 1:
        raise ValueError(f"{len(parts)} parts on a process-group axis: a rank passes its own")
    return parts[0]


def all_gather(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> List[torch.Tensor]:
    """Every shard's part along ``axis`` in shard order, each on the device
    of the caller's first part: in process ``parts`` are all of them; over a
    process group ``parts`` is the caller's own one."""
    if axis.group is None:
        dev = parts[0].device
        return [p.to(dev) for p in parts]
    CALLS["all_gather"] += 1
    return _gathered(_one(parts, axis), axis)


def psum(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> torch.Tensor:
    """The sum over ``axis`` of the shards' parts, added in shard order on
    the device of the caller's first part (one part is returned as it is)."""
    if axis.group is not None:
        CALLS["psum"] += 1
        parts = _gathered(_one(parts, axis), axis)
    else:
        parts = all_gather(parts)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(parts: Sequence[torch.Tensor], axis: Axis = LOCAL) -> torch.Tensor:
    """The elementwise maximum over ``axis`` of the shards' parts, on the
    device of the caller's first part."""
    if axis.group is None:
        return torch.stack(all_gather(parts)).amax(dim=0)
    import torch.distributed as dist

    CALLS["pmax"] += 1
    x = _one(parts, axis)
    out = x.detach().cpu() if x.device.type == "cuda" and _backend(axis.group) == "gloo" \
        else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out.to(x.device)


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
