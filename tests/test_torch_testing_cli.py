"""The port's reference-style harness (``testing.py``) against the JAX
package's, on the CPU."""

import numpy as np
import pytest

from tf_flash_attention_tpu import testing as jtesting
from tf_flash_attention_tpu_torch import testing


@pytest.mark.parametrize("seq_dims", [1, 2], ids=["1d", "2d"])
def test_list_matches_jax_line_for_line(capsys, seq_dims):
    jtesting.cmd_list(seq_dims)
    want = capsys.readouterr().out
    testing.cmd_list(seq_dims)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 1 + 16


def test_case_matrix_and_bounds_match_jax():
    assert {n: (type(r).__name__, vars(r), m) for n, (r, m) in testing._CASES.items()} == {
        n: (type(r).__name__, vars(r), m) for n, (r, m) in jtesting._CASES.items()}
    assert testing._SHAPES_1D == jtesting._SHAPES_1D
    assert testing._SHAPES_2D == jtesting._SHAPES_2D


def test_random_shapes_match_jax():
    """The same seed draws the same case shapes in both harnesses."""
    import torch
    for seq_dims in (1, 2):
        a = jtesting._gen_data(np.random.default_rng(3), seq_dims, np.float32)
        b = testing._gen_data(np.random.default_rng(3), seq_dims, torch.float32, "cpu")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("seq_dims,case", [(1, "CausalAttentionSyncModeScaleFront"),
                                           (2, "LocalStrideAndCausalAttentionSyncModeScaleEnd")],
                         ids=["1d", "2d"])
def test_single_case_verify(monkeypatch, capsys, seq_dims, case):
    monkeypatch.setenv("FA_DEVICE", "cpu")
    monkeypatch.setenv("TESTCASE", case)
    monkeypatch.setenv("FA_RUNS", "1")
    monkeypatch.setenv("FA_SEED", "7")
    rc = testing.main(["testing", "verify", f"{seq_dims}d"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines() == [f"Verifying {case} ({seq_dims}d)", "OK"]


def test_entry_points_default_to_the_card(monkeypatch):
    """Without FA_DEVICE the harness runs on the card; here, with none, it
    fails instead of falling back to the CPU."""
    import torch
    monkeypatch.delenv("FA_DEVICE", raising=False)
    assert testing._device().type == "cuda"
    assert testing._dtypes(torch.device("cuda")) == (torch.bfloat16, torch.float32)
    assert testing._dtypes(torch.device("cpu")) == (torch.float32,)
    if not torch.cuda.is_available():
        monkeypatch.setenv("TESTCASE", "FullAttentionSyncModeNoneFront")
        monkeypatch.setenv("FA_RUNS", "1")
        with pytest.raises((AssertionError, RuntimeError)):
            testing.cmd_verify(1)
        with pytest.raises((AssertionError, RuntimeError)):
            testing.cmd_benchmark(1)
