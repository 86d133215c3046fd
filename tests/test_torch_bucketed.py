"""The port engine's bucketed prefill (``prefill_mode="bucketed"``) against
the JAX engine's, on the CPU: the whole prompt padded to its bucket runs
through the training forward's attention and its K/V is written with
``write_prompt``; greedy tokens, ``stats`` and free pages equal the JAX
engine's on the same numpy weights, with two buckets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.serving import engine as teng

from _torch_parity import PAYLOADS

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
ECFG = dict(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4,
            prefill_mode="bucketed", prefill_buckets=(32, 128))


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


def _reqs():
    """Prompts in both buckets (one exactly a bucket, one across a page),
    more requests than slots."""
    rng = np.random.default_rng(0)
    return [([int(t) for t in rng.integers(1, 64, n)], m)
            for n, m in ((100, 8), (20, 6), (32, 5), (67, 8), (5, 7))]


@pytest.mark.parametrize("kind", [None, "int8"], ids=["f32", "int8"])
def test_bucketed_engine_matches_jax(params_np, kind):
    if kind is None:
        jkv = tkv = dict(quantized_kv=False)
    else:
        jkv, tkv = (dict(kv_quant_dtype=q) for q in PAYLOADS[kind])
    je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**ECFG, **jkv))
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                           teng.EngineConfig(**ECFG, **tkv), device="cpu")
    assert te.prefix_cache is None
    reqs = _reqs()
    jr = [je.submit(p, max_new_tokens=n) for p, n in reqs]
    tr = [te.submit(p, max_new_tokens=n) for p, n in reqs]
    want, got = je.run(), te.run()
    for a, b in zip(jr, tr):
        assert got[b] == want[a], (got[b], want[a])
    assert te.stats == je.stats and te.stats["prefill_chunks"] == 0
    assert te.allocator.free_pages == je.allocator.free_pages == ECFG["n_pages"] - 1


def test_bucketed_prefill_matches_jax_prefill_impl(params_np):
    """One prompt's last-token logits and every layer's K/V against the JAX
    ``_prefill_impl`` at the same bucket; the port's takes the prompt's
    length as a 0-d int32 tensor (the graph's device input) and returns
    ``(logits, k_0, v_0, k_1, v_1)``."""
    je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**ECFG, quantized_kv=False))
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                           teng.EngineConfig(**ECFG, quantized_kv=False), device="cpu")
    prompt = _reqs()[3][0]
    assert te._bucket_for(len(prompt)) == je._bucket_for(len(prompt)) == 128
    toks = prompt + [0] * (128 - len(prompt))
    want, want_kv = je._prefill[128](je.params, jnp.asarray(toks, jnp.int32), len(prompt))
    got, *got_kv = te._prefill_impl(torch.tensor(toks), torch.tensor(len(prompt),
                                                                     dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert len(got_kv) == 2 * len(want_kv)
    for k, v, (jk, jv) in zip(got_kv[0::2], got_kv[1::2], want_kv):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_bucketed_prompt_past_the_last_bucket_raises(params_np):
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                           teng.EngineConfig(**ECFG), device="cpu")
    te.submit(list(range(1, 64)) * 3, max_new_tokens=2)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        te.run()
