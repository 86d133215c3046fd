"""Sliding-window serving in the port's engine against the JAX engine, on
the CPU: ``LocalRule`` models with lazy prompt paging, eviction behind the
window and rolled page tables, flat and with context parallelism (4
shards), with and without speculation, on unquantized, int8 and int4
caches.  Greedy tokens, ``stats``, ``spec_stats`` and every allocator's
free pages must equal the JAX engine's on the same numpy weights (float32
models at ``test_serving.py``'s sizes: no rounding order between the two
packages can flip a token)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
from tf_flash_attention_tpu_torch.serving import engine as teng

from _torch_parity import PAYLOADS, one_torch_thread

# many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
# pages of 8 tokens and 5 table slots: the table reaches 40 tokens
ECFG = dict(max_seqs=2, page_size=8, n_pages=16, max_pages_per_seq=5, prefill_chunk=8,
            prefix_caching=False)
PATTERN = [5, 9, 5, 9, 5, 9, 5, 9, 5]
# a 50-token prompt (longer than the table's reach: paged lazily, evicted
# while it prefills) and a short one generating past the reach
REQS = [([(i * 13 + 5) % 64 for i in range(50)], 12), ([7, 8, 9], 42)]


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


def _kv(kind):
    """(JAX, port) EngineConfig KV options: None unquantized, or a payload."""
    if kind is None:
        return dict(quantized_kv=False), dict(quantized_kv=False)
    jq, tq = PAYLOADS[kind]
    return dict(kv_quant_dtype=jq), dict(kv_quant_dtype=tq)


def _serve(engine, reqs, max_steps=200):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    out = engine.run(max_steps=max_steps)
    return [out[r] for r in rids]


def _pair(params_np, window, log2_stride, ecfg, kind=None, cp=1, jcfg=MCFG, tcfg=TCFG):
    """A JAX engine and a port engine on the same weights, window rule and
    engine config; ``cp`` > 1 shards both over 4 CPU devices."""
    jkv, tkv = _kv(kind)
    jm = dataclasses.replace(jcfg, rule=JLocalRule(window, log2_stride, True))
    tm = dataclasses.replace(tcfg, rule=LocalRule(window, log2_stride, True))
    jmesh = jmake_mesh((cp,), ("seq",), jax.devices()[:cp]) if cp > 1 else None
    je = jeng.DecodeEngine(jm, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**ecfg, **jkv), mesh=jmesh)
    place = (dict(mesh=make_mesh((cp,), ("seq",), ["cpu"] * cp)) if cp > 1
             else dict(device="cpu"))
    te = teng.DecodeEngine(tm, ttf.params_from_jax(tm, params_np, "cpu"),
                           teng.EngineConfig(**ecfg, **tkv), **place)
    return je, te


def _assert_same(je, te, reqs, max_steps=200):
    want, got = _serve(je, reqs, max_steps), _serve(te, reqs, max_steps)
    assert got == want
    assert [len(x) for x in got] == [len(p) + n for p, n in reqs]
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert [a.free_pages for a in te.allocators] == [a.free_pages for a in je.allocators]
    assert te._pages_cap == je._pages_cap and te.prefix_cache is None
    return got


# a window of 8 and a strided one of the same reach (4 positions of stride
# 2), on every cache kind: the first request pages its prompt lazily past
# the table, the second generates past it (both roll the table)
@pytest.mark.parametrize("kind", [None, "int8", "int4"], ids=["f32", "int8", "int4"])
@pytest.mark.parametrize("window,log2_stride", [(8, 0), (4, 1)], ids=["window8", "strided4x2"])
def test_window_engine_matches_jax(params_np, window, log2_stride, kind):
    je, te = _pair(params_np, window, log2_stride, ECFG, kind)
    got = _assert_same(je, te, REQS)
    reach = ECFG["page_size"] * ECFG["max_pages_per_seq"]
    assert all(len(x) > reach for x in got)
    assert te.stats["pages_evicted"] > 0
    assert te.stats["pages_in_use_peak"] <= te._pages_cap * ECFG["max_seqs"]
    assert te.allocator.free_pages == ECFG["n_pages"] - 1


@pytest.mark.parametrize("kind", [None, "int8"], ids=["f32", "int8"])
def test_window_engine_speculative_matches_jax(params_np, kind):
    """Two drafts a step on a pattern prompt (drafts accepted) and on a short
    prompt, generating past the table's reach."""
    je, te = _pair(params_np, 8, 0, dict(ECFG, speculative_tokens=2), kind)
    _assert_same(je, te, [(PATTERN, 40), ([1, 2, 3], 36)])
    assert te.spec_stats["accepted"] > 0 and te.stats["pages_evicted"] > 0


def test_window_engine_eviction_refunds_nothing(params_np):
    """``test_serving.py``'s eviction case, short: one slot, two long
    requests back to back; each holds at most the window's live pages, every
    page comes back, and the capped reservation is what retirement hands
    back (nothing was refunded early)."""
    ecfg = dict(ECFG, max_seqs=1, n_pages=10, max_pages_per_seq=5)
    je, te = _pair(params_np, 8, 0, ecfg)
    held = []
    step = te.step

    def watched():
        n = step()
        if te._slots[0] is not None:
            held.append(len(te.allocator.owned(0)))
        return n

    te.step = watched
    _assert_same(je, te, [([1, 2, 3, 4, 5, 6], 40), ([1, 2, 3, 4, 5, 6], 40)])
    assert max(held) <= -(-(8 - 1) // 8) + 2
    assert te.scheduler._budget == je.scheduler._budget == ecfg["n_pages"] - 1


# context parallelism over 4 shards: test_serving.py's CP window case (a
# window of 12 across shard boundaries, sequences inside the tables), and
# its rolling case (a 120-token prompt past every shard's table, pages
# evicted on every shard), with and without speculation
CP_WINDOW = dict(max_seqs=2, page_size=16, n_pages=8, max_pages_per_seq=4, prefill_chunk=16,
                 prefix_caching=False)
CP_ROLL = dict(max_seqs=1, page_size=8, n_pages=6, max_pages_per_seq=3, prefill_chunk=8,
               prefix_caching=False)


@pytest.mark.parametrize("spec", [0, 2], ids=["greedy", "speculative"])
def test_window_engine_cp_matches_jax(params_np, spec):
    je, te = _pair(params_np, 12, 0, dict(CP_WINDOW, speculative_tokens=spec), cp=4)
    assert te.cp == je.cp == 4
    _assert_same(je, te, [([(i * 7 + 1) % 64 for i in range(40)], 10), ([7, 8, 9], 10)])


def test_window_engine_cp_rolls_and_evicts(params_np):
    je, te = _pair(params_np, 12, 0, CP_ROLL, cp=4)
    _assert_same(je, te, [([(i * 13 + 5) % 64 for i in range(120)], 40)])
    assert te.stats["pages_evicted"] >= 15
    assert [a.free_pages for a in te.allocators] == [CP_ROLL["n_pages"] - 1] * 4


def test_window_engine_example_configuration():
    """``examples/sliding_window_serving.py``'s model and engine (window 64,
    pages of 32, 6 table slots, 15 usable pages, int4 cache) with its
    300-token prompt, 120 new tokens (past twice the table's reach of 192
    tokens; the example runs 400), in float32: the example's bf16 rounds
    matmuls in other orders in the two packages, which flips a greedy token
    within a few dozen steps."""
    jcfg = jtf.ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8, n_kv_heads=4,
                           d_head=64, d_ff=512, max_seq=4096, dtype=jnp.float32)
    tcfg = ttf.ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8, n_kv_heads=4,
                           d_head=64, d_ff=512, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    ecfg = dict(max_seqs=2, page_size=32, n_pages=16, max_pages_per_seq=6, prefill_chunk=32,
                prefix_caching=False)
    je, te = _pair(params, 64, 0, ecfg, "int4", jcfg=jcfg, tcfg=tcfg)
    prompt = [(7 * i + 3) % 256 for i in range(300)]
    got = _assert_same(je, te, [(prompt, 120)], max_steps=500)
    assert len(got[0]) > 2 * 6 * 32
    assert te.stats["pages_in_use_peak"] <= te._pages_cap * ecfg["max_seqs"]


def test_window_engine_causal_still_raises_past_the_table(params_np):
    """A causal sequence that outgrows max_pages_per_seq fails loudly; only
    window models roll the table (``test_serving.py``'s overflow case)."""
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                           teng.EngineConfig(**dict(ECFG, max_pages_per_seq=2)), device="cpu")
    te.submit([1, 2, 3, 4, 5, 6], max_new_tokens=20)
    with pytest.raises(RuntimeError, match="max_pages_per_seq"):
        te.run(max_steps=40)
