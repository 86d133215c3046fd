"""The port's serving engine and model pieces against the JAX package, on
the CPU, with ``test_serving.py``'s small model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.serving import engine as teng

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
ECFG = dict(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4, prefill_chunk=64)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


def test_params_from_jax_round_trips(params_np):
    model = ttf.params_from_jax(TCFG, params_np)
    np.testing.assert_array_equal(model.embed.numpy(), params_np["embed"])
    np.testing.assert_array_equal(model.final_norm.numpy(), params_np["final_norm"])
    for block, layer in zip(model.layers, params_np["layers"]):
        for name, value in layer.items():
            np.testing.assert_array_equal(getattr(block, name).numpy(), value, err_msg=name)


def test_params_cast_once_norms_stay_float32(params_np):
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    model = ttf.params_from_jax(cfg, params_np)
    assert model.embed.dtype == model.layers[0].wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.dtype == model.final_norm.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].w2.float().numpy(),
        np.asarray(jnp.asarray(params_np["layers"][1]["w2"]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_init_params_scales():
    cfg = dataclasses.replace(TCFG, vocab=512, d_model=256, d_ff=512)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    assert abs(float(model.layers[0].wq.std()) - 256 ** -0.5) < 3e-3
    assert abs(float(model.layers[0].w2.std()) - 512 ** -0.5) < 3e-3
    assert torch.equal(model.layers[0].ln2, torch.ones(256))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4, 16)).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 513], np.int32)
    np.testing.assert_allclose(
        teng._rope_at(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jeng._rope_at(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=0, atol=2e-5)   # cos/sin of angles up to ~500 rad, float32
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    np.testing.assert_allclose(
        ttf._rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jtf._rms_norm(jnp.asarray(x), jnp.asarray(scale))), rtol=1e-6, atol=1e-6)


def _prompts():
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, 64, 64)]       # one full page
    return [[int(t) for t in rng.integers(1, 64, 100)],       # longer than a chunk
            shared + [5, 6, 7], shared + [9]]


# greedy parity with the JAX engine: same weights, same prompts, same
# schedule; the two requests sharing a page hit the prefix cache
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_matches_jax_engine(params_np, quantized):
    prompts = _prompts()
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**ECFG, quantized_kv=quantized))
    jr = [je.submit(p, max_new_tokens=8) for p in prompts]
    want = je.run()
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np),
                           teng.EngineConfig(**ECFG, quantized_kv=quantized))
    tr = [te.submit(p, max_new_tokens=8) for p in prompts]
    got = te.run()
    for a, b in zip(jr, tr):
        assert got[b] == want[a], (got[b], want[a])
    assert te.stats == je.stats
    assert te.prefix_cache.hits == je.prefix_cache.hits >= 1
    assert te.allocator.free_pages == je.allocator.free_pages


def test_engine_eos_and_queueing(params_np):
    """More requests than slots queue; an EOS stops a request early."""
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np),
                           teng.EngineConfig(**dict(ECFG, max_seqs=2)))
    first = te.submit([1, 2, 3], max_new_tokens=4)
    rest = [te.submit([i + 1, i + 2], max_new_tokens=3) for i in range(3)]
    out = te.run()
    assert len(out[first]) == 3 + 4 and all(len(out[r]) == 2 + 3 for r in rest)
    eos = out[first][4]
    stop = 3 + out[first][3:].index(eos) + 1
    te2 = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np),
                            teng.EngineConfig(**ECFG))
    rid = te2.submit([1, 2, 3], max_new_tokens=8, eos_id=eos)
    assert te2.run()[rid] == out[first][:stop]
    assert te2.allocator.free_pages + len(te2.prefix_cache) == ECFG["n_pages"] - 1


def test_engine_sampled_request_runs(params_np):
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams
    te = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np),
                           teng.EngineConfig(**ECFG, seed=3))
    g = te.submit([1, 2, 3], max_new_tokens=5)
    s = te.submit([1, 2, 3], max_new_tokens=5,
                  sampling=SamplingParams(temperature=1.0, top_k=10))
    out = te.run()
    assert len(out[s]) == 8 and all(0 <= t < 64 for t in out[s])
    greedy_alone = teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np),
                                     teng.EngineConfig(**ECFG))
    r = greedy_alone.submit([1, 2, 3], max_new_tokens=5)
    assert out[g] == greedy_alone.run()[r]   # co-batching leaves greedy alone


@pytest.mark.parametrize("change", [
    dict(engine=dict(speculative_tokens=2)),
    dict(engine=dict(prefill_mode="bucketed")),
    dict(model=dict(rule=LocalRule(window_size=8, is_causal=True))),
    dict(mesh=object()),
], ids=["speculative", "bucketed", "local_rule", "mesh"])
def test_engine_unported_options_raise(params_np, change):
    cfg = dataclasses.replace(TCFG, **change.get("model", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.DecodeEngine(cfg, ttf.params_from_jax(cfg, params_np),
                          teng.EngineConfig(**ECFG, **change.get("engine", {})),
                          mesh=change.get("mesh"))


def test_moe_config_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataclasses.replace(TCFG, n_experts=4)
