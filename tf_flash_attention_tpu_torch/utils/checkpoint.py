"""Checkpoint / resume of training state (PyTorch port).

Counterpart of the JAX package's ``utils/checkpoint.py``, with its names
and layout: ``save_checkpoint`` writes a pytree under
``directory/step_<n>``, ``latest_step`` finds the newest step and
``restore_checkpoint`` reads one back.  The JAX package writes with Orbax;
the port writes one file a step with ``torch.save`` and reads it with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.

The state is any pytree of dicts, lists and tuples whose leaves are
tensors, numpy arrays and Python scalars, such as ``{"params":
model.state_dict(), "opt_state": optimizer.state_dict(), "step": n}``.
Tensors are written from the CPU, bit for bit; numpy arrays travel as
tensors and come back as numpy arrays (a numpy scalar as a 0-d array).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "state.pt"


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _encode(x, path, numpy_paths):
    """``x`` with tensors on the CPU and numpy leaves as tensors, their paths
    (tuples of keys and indices) appended to ``numpy_paths``."""
    if isinstance(x, dict):
        return {k: _encode(v, path + (k,), numpy_paths) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v, path + (i,), numpy_paths) for i, v in enumerate(x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        numpy_paths.append(path)
        return torch.from_numpy(np.array(x))
    return x


def _decode(x, path, numpy_paths):
    """The inverse of ``_encode``: the tensors at ``numpy_paths`` back to
    numpy arrays (a numpy scalar comes back as a 0-d array)."""
    if path in numpy_paths:
        return x.numpy()
    if isinstance(x, dict):
        return {k: _decode(v, path + (k,), numpy_paths) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v, path + (i,), numpy_paths) for i, v in enumerate(x))
    return x


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` (any pytree) under ``directory/step_<n>``; an existing
    step is overwritten (Orbax's ``force=True``): the new one is written in
    a temporary directory beside it and renamed into place."""
    path = _step_path(directory, step)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    numpy_paths = []
    payload = {"state": _encode(state, (), numpy_paths), "numpy_paths": numpy_paths}
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=parent)
    try:
        torch.save(payload, os.path.join(tmp, _FILE))
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".old_step_{step}.", dir=parent)
            os.replace(path, os.path.join(old, "step"))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_", 1)[1]) for name in os.listdir(directory)
             if name.startswith("step_") and name.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def _place(x, target):
    """``x`` with each tensor leaf on the device and in the dtype of the
    matching ``target`` leaf (numpy leaves in its dtype); where the target
    has no matching leaf (a key it lacks, a None) the leaf stays as
    loaded."""
    if target is None:
        return x
    if isinstance(x, dict):
        if not isinstance(target, dict):
            raise ValueError(f"target {type(target).__name__} where the checkpoint has a dict")
        return {k: _place(v, target.get(k)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if not isinstance(target, (list, tuple)) or len(target) != len(x):
            raise ValueError(f"target {type(target).__name__} does not match the checkpoint's "
                             f"{type(x).__name__} of {len(x)}")
        return type(x)(_place(v, t) for v, t in zip(x, target))
    if isinstance(x, torch.Tensor) and isinstance(target, torch.Tensor):
        return x.to(device=target.device, dtype=target.dtype)
    if isinstance(x, np.ndarray) and isinstance(target, (np.ndarray, np.generic)):
        return x.astype(target.dtype, copy=False)
    return x


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       target: Any = None) -> Any:
    """Restore the pytree saved at ``step`` (default: the latest); raises
    ``FileNotFoundError`` when there is none.

    ``target``, a pytree of the same structure (e.g. the freshly initialised
    state), places the restored tensors: each takes the device and dtype of
    the matching target leaf.  Without a target, tensors load onto the CPU.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    file = os.path.join(_step_path(directory, step), _FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint at step {step} under {directory}")
    payload = torch.load(file, map_location="cpu", weights_only=True)
    state = _decode(payload["state"], (), set(map(tuple, payload["numpy_paths"])))
    return _place(state, target)
