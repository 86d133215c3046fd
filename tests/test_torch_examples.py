"""The port's examples (``examples/torch_*.py``) on the CPU: each
``main(device="cpu")`` runs its JAX counterpart's configuration and
returns the JAX example's shapes and invariants."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_basic_usage(capsys):
    out = _example("basic_usage").main(device="cpu")
    assert out["local_1d"] == (8, 16, 1024)
    assert out["causal_1d"] == ((8, 16, 1024), (8, 1024), torch.float32, (8, 1024),
                                torch.float32)
    assert out["local_2d"] == (2, 4, 16, 32, 32)
    assert out["grad"] == (8, 32, 1024)
    assert out["mha"] == (2, 8, 1024, 128)
    printed = capsys.readouterr().out
    assert "local_1d: (8, 16, 1024)" in printed and "mha (GQA): (2, 8, 1024, 128)" in printed


def test_serving_demo(capsys):
    out = _example("serving_demo").main(device="cpu")
    prompts = [list(range(1, 129)) + [1, 2, 3], list(range(1, 129)) + [9, 8], [42] * 10,
               [5, 5], [13, 17, 19]]
    assert len(out["results"]) == 5
    for prompt, toks in zip(prompts, out["results"].values()):
        assert toks[:len(prompt)] == prompt and len(toks) == len(prompt) + 12
        assert all(0 <= t < 256 for t in toks)
    assert out["prefix_hits"] > 0 and out["prefix_pages"] >= 1
    assert out["spec_stats"]["proposed"] > 0
    assert "prefix cache:" in capsys.readouterr().out


def test_sliding_window_serving():
    out = _example("sliding_window_serving").main(device="cpu")
    toks, stats = out["tokens"], out["stats"]
    assert len(toks) == 700 and toks[:300] == [(7 * i + 3) % 256 for i in range(300)]
    # past the table's reach (6 pages of 32) on a window-bounded live set
    assert stats["pages_evicted"] > 0
    assert stats["pages_in_use_peak"] <= out["pages_cap"] * 2
    assert stats["prefill_chunks"] == 300 // 32 + 1


def test_train_demo():
    out = _example("train_demo").main(device="cpu")
    assert out["mesh"] == {"data": 2, "model": 4}
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    # random tokens over a 512-token vocabulary: the loss starts near ln 512
    assert abs(out["losses"][0] - np.log(512)) < 0.5
