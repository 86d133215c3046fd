"""The port's checkpointing (``utils/checkpoint.py``) on the CPU: a round
trip is bit-equal, ``latest_step`` and ``FileNotFoundError`` behave as the
JAX package's, a ``target`` places each tensor, and a resumed run of AdamW
steps is bit-equal to an unbroken one.  (Resumed steps against JAX's
unbroken optax steps: ``test_torch_train.py``.)"""

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                                           save_checkpoint)

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = ttf.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_head=8,
                      d_ff=64, max_seq=64, dtype=torch.float32)


def _state(seed):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "params": {"w": torch.from_numpy(f32), "b": torch.from_numpy(f32[0]).to(torch.bfloat16),
                   "e4m3": torch.from_numpy(f32).to(torch.float8_e4m3fn)},
        "ids": torch.from_numpy(rng.integers(-9, 9, (4,))),
        "moments": [torch.from_numpy(f32[1:]), (torch.tensor(2.0), 0.9, 0.999)],
        "numpy": rng.standard_normal((2, 2)),
        "step": 3, "lr": 1e-3, "name": "adamw", "none": None, "flag": True,
    }


def _assert_bit_equal(got, want, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bit_equal(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert (got.dtype, got.shape, got.device) == (want.dtype, want.shape, want.device), path
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), path
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8),
                                                           want.view(np.uint8)), path
    else:
        assert got == want, path


def test_round_trip_is_bit_equal(tmp_path):
    assert latest_step(tmp_path / "absent") is None
    assert latest_step(tmp_path) is None
    first, second = _state(0), _state(1)
    path = save_checkpoint(str(tmp_path), 3, first)
    assert path == str(tmp_path / "step_3")
    save_checkpoint(str(tmp_path), 7, second)
    assert latest_step(str(tmp_path)) == 7
    _assert_bit_equal(restore_checkpoint(str(tmp_path)), second)
    _assert_bit_equal(restore_checkpoint(str(tmp_path), step=3), first)
    # overwriting a step replaces it whole, and leaves no temporary directory
    save_checkpoint(str(tmp_path), 3, second)
    _assert_bit_equal(restore_checkpoint(str(tmp_path), step=3), second)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_7"]


def test_missing_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path))
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), step=2)


def test_target_places_each_tensor(tmp_path):
    """Each restored tensor takes the device and dtype of its target leaf;
    where the target has no leaf, it loads on the CPU as saved."""
    state = _state(2)
    save_checkpoint(str(tmp_path), 0, state)
    target = {"params": {"w": torch.zeros((3, 5), dtype=torch.float64),
                         "b": torch.empty(5, device="meta")},
              "numpy": np.zeros((2, 2), np.float32),
              "moments": [None, (torch.zeros((), dtype=torch.float16), 0.0, 0.0)]}
    got = restore_checkpoint(str(tmp_path), target=target)
    assert got["params"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  state["params"]["w"].numpy().astype(np.float64))
    assert got["params"]["b"].device.type == "meta" and got["params"]["b"].dtype == torch.float32
    _assert_bit_equal(got["params"]["e4m3"], state["params"]["e4m3"])
    assert got["numpy"].dtype == np.float32
    assert got["moments"][1][0].dtype == torch.float16 and got["step"] == 3
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), target={"moments": [None]})


def _adamw(model):
    # optax.adamw's defaults
    return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def test_resumed_run_is_bit_equal_to_an_unbroken_one(tmp_path):
    """2 AdamW steps, a checkpoint of (params, opt_state, step), a fresh
    model and optimizer restored through ``target``, 2 more steps: the
    losses and the weights equal 4 unbroken steps bit for bit."""
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, CFG.vocab, (2, 33)))
    model = ttf.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    opt = _adamw(model)
    unbroken = [float(ttf.train_step(CFG, model, tokens, optimizer=opt)) for _ in range(4)]

    run = ttf.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    opt = _adamw(run)
    losses = [float(ttf.train_step(CFG, run, tokens, optimizer=opt)) for _ in range(2)]
    save_checkpoint(str(tmp_path), 2, {"params": run.state_dict(),
                                       "opt_state": opt.state_dict(), "step": 2})
    fresh = ttf.init_params(CFG, torch.Generator().manual_seed(9), "cpu")
    fresh_opt = _adamw(fresh)
    state = restore_checkpoint(str(tmp_path), target={"params": fresh.state_dict(),
                                                      "opt_state": fresh_opt.state_dict(),
                                                      "step": 0})
    assert state["step"] == 2
    fresh.load_state_dict(state["params"])
    fresh_opt.load_state_dict(state["opt_state"])
    losses += [float(ttf.train_step(CFG, fresh, tokens, optimizer=fresh_opt)) for _ in range(2)]
    assert losses == unbroken
    for (name, got), want in zip(fresh.state_dict().items(), model.state_dict().values()):
        assert torch.equal(got, want), name
