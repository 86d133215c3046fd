"""A cell added from new files only runs end to end on the CPU (past the
harness's look for a card), the control in the program's place comes out
not correct, and so does a run whose timed path is broken underneath."""

import json

import pytest
import torch

from conftest import add_tiny_cell, run_cell


@pytest.mark.parametrize("offline", [False, True])
def test_a_cell_added_from_new_files_runs(bench_copy, offline):
    cell = add_tiny_cell(bench_copy, offline=offline)
    out = run_cell(bench_copy, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    e2e = {"itl_p95_ms", "setup_s"} | (set() if offline else {"ttft_p95_ms"})
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checks" and out["checks"]["logit_gap"]["value"] <= 0.05
    assert out["readings"]["pages_in_use_peak"] > 0
    traced = run_cell(bench_copy, cell, trace=1)
    assert traced["correct"] is True
    assert traced["metrics"]["dummy_tokens.tiny"]["value"] > 0
    assert traced["metrics"]["decode_step_ms.tiny"]["value"] > 0
    assert "breakdown" in traced and "busy_s" in traced["device"]
    json.dumps(traced)


def test_the_longest_admitted_request_is_finished_and_compared(bench_copy):
    cell = add_tiny_cell(bench_copy, window=24)
    out = run_cell(bench_copy, cell, seconds=1.0)
    # the mix's longest request: 16 system tokens, 40 of prompt, 30 served
    assert out["correct"] is True
    assert out["readings"]["longest_context_compared"] > 24


@pytest.mark.parametrize("window", [None, 24])
def test_the_control_in_the_programs_place_is_not_correct(bench_copy, window):
    # the tiny cell's own limit, between its program's widest gaps (0.0,
    # 0.0033) and its control's (0.047, 0.041)
    cell = add_tiny_cell(bench_copy, window=window, limit=0.02)
    out = run_cell(bench_copy, cell, control=1)
    check = out["checks"]["logit_gap"]
    assert out["correct"] is False and check["value"] > check["limit"]
    assert out["failed"] > 0
    assert out["readings"]["program_logit_gap"] <= check["limit"]


def _token_altered(monkeypatch):
    from tf_flash_attention_tpu_torch.serving import engine
    impl = engine.DecodeEngine._decode_step_impl

    def broken(self, tokens, active):
        greedy, logits = impl(self, tokens, active)
        return (greedy + 1) % self.mcfg.vocab, logits
    monkeypatch.setattr(engine.DecodeEngine, "_decode_step_impl", broken)


def _state_unchanged(monkeypatch):
    from tf_flash_attention_tpu_torch.serving import engine
    monkeypatch.setattr(engine, "append_owned", lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    from tf_flash_attention_tpu_torch.serving import engine
    impl = engine.DecodeEngine._decode_step_impl

    def broken(self, tokens, active):
        greedy, logits = impl(self, tokens, active)
        half = tokens.shape[0] // 2
        return torch.cat([greedy[:half], tokens[half:]]), logits
    monkeypatch.setattr(engine.DecodeEngine, "_decode_step_impl", broken)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_the_batch])
def test_a_broken_timed_path_is_not_correct(bench_copy, monkeypatch, fault):
    cell = add_tiny_cell(bench_copy)
    fault(monkeypatch)
    out = run_cell(bench_copy, cell)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]

