"""The port's engine on an MoE model against the JAX engine, on the CPU.

A 2-layer model with 4 top-1 experts (float32, small widths) on an int8
cache, the JAX engine's kernels in interpret mode, the same numpy weights
and prompts: the chunked prefill over more than one chunk, the decode with
one slot idle throughout and one request retiring early (a decode step's
capacity is 1 at 3 slots, so the idle slot's row takes a queue place
ahead of the later slots, as in JAX), gamma-4 speculation on pattern
prompts (the S·gamma rows route as one sequence), and the bucketed
prefill.  Greedy tokens, ``stats``, ``spec_stats`` and free pages must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.serving import engine as teng

from _torch_parity import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                       d_ff=128, max_seq=256, n_experts=4, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                       d_ff=128, n_experts=4, dtype=torch.float32)
ECFG = dict(max_seqs=3, page_size=16, n_pages=32, max_pages_per_seq=8, prefill_chunk=32)
PATTERN = [5, 9, 5, 9, 5, 9, 5, 9, 5]   # material for the n-gram proposer


def _reqs():
    rng = np.random.default_rng(0)
    long_ = [int(t) for t in rng.integers(1, 64, 70)]             # three chunks of 32
    short = [int(t) for t in rng.integers(1, 64, 9)]
    # the short request retires early from slot 0, whose idle row then
    # routes ahead of slot 1's
    return [(short, 3), (long_, 12)]


CASES = {
    # two requests on three slots: slot 2 idle throughout
    "chunked": (dict(), _reqs()),
    "speculative": (dict(speculative_tokens=3, prefix_caching=False),
                    [(PATTERN, 12), ([1, 2, 3, 4, 5], 7)]),
    # prompts in both buckets, more requests than slots
    "bucketed": (dict(prefill_mode="bucketed", prefill_buckets=(32, 128)),
                 _reqs() + [([7, 8, 9] * 10, 6), ([3, 4], 5)]),
}


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_engine_matches_jax(params_np, case):
    extra, reqs = CASES[case]
    je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**ECFG, **extra, kv_quant_dtype=jnp.int8))
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                           teng.EngineConfig(**ECFG, **extra, kv_quant_dtype=torch.int8),
                           device="cpu")
    jr = [je.submit(p, max_new_tokens=n) for p, n in reqs]
    tr = [te.submit(p, max_new_tokens=n) for p, n in reqs]
    want, got = je.run(max_steps=100), te.run(max_steps=100)
    for a, b in zip(jr, tr):
        assert got[b] == want[a], (got[b], want[a])
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert te.allocator.free_pages == je.allocator.free_pages
    if case == "chunked":
        assert te.stats["prefill_chunks"] == 4      # 70 tokens in three chunks, 9 in one
    if case == "speculative":
        assert te.spec_stats["accepted"] > 0


def test_moe_idle_slot_row_moves_the_others(params_np):
    """Capacity couples a step's rows: the engine feeds an idle slot token
    0 (as JAX does); fed another token, the idle row routes elsewhere and
    the busy slots' tokens change, so the parity above rests on the idle
    row."""
    reqs = CASES["chunked"][1]
    outs = []
    for idle in (0, 33):
        te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                               teng.EngineConfig(**ECFG, kv_quant_dtype=torch.int8),
                               device="cpu")
        inner = te._decode_step

        def step(tokens, active, inner=inner, idle=idle):
            return inner(torch.where(active, tokens, idle), active)

        te._decode_step = step
        rids = [te.submit(p, max_new_tokens=n) for p, n in reqs]
        res = te.run(max_steps=100)
        outs.append([res[r] for r in rids])
    assert outs[0] != outs[1]
