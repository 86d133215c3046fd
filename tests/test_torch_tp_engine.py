"""Tensor-parallel serving in the port (heads sharded over a ``model``
mesh axis, alone and with a ``seq`` axis) against the JAX package, on the
CPU: the JAX side on its virtual CPU devices, the port on ``"cpu"``
repeated.  ``test_serving.py``'s small model and its TP and TP x CP
configurations; the dense greedy reference is the port's ``forward`` (on
the CPU the plain path, held to the JAX ``forward`` by
``test_torch_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu.serving.sharded_decode import sharded_paged_decode as jsharded
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
from tf_flash_attention_tpu_torch.serving import decode as tdec
from tf_flash_attention_tpu_torch.serving import engine as teng
from tf_flash_attention_tpu_torch.serving.seq_sharded_decode import create_seq_sharded_cache
from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                 sharded_paged_decode)

from _torch_parity import cache_cfgs, caches_from, random_state

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
# test_serving.py's TP configuration (test_engine_tensor_parallel_...)
TP_ECFG = dict(max_seqs=2, page_size=64, n_pages=32, max_pages_per_seq=4, quantized_kv=False,
               prefill_mode="chunked", prefill_chunk=8, prefix_caching=True)
# and its TP x CP one (test_engine_tp_x_cp_matches_dense_greedy)
TPCP_ECFG = dict(max_seqs=2, page_size=16, n_pages=8, max_pages_per_seq=4, quantized_kv=True,
                 prefill_mode="chunked", prefill_chunk=16, prefix_caching=False)
PATTERN = [5, 9, 5, 9, 5, 9, 5, 9, 5]


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(params_np):
    return ttf.params_from_jax(TCFG, params_np, "cpu")


def greedy_dense(model, prompt, n_new):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits = ttf.forward(TCFG, model, torch.tensor([toks]))
            toks.append(int(logits[0, -1].argmax()))
    return toks


def _serve(engine, reqs, max_steps=80):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    out = engine.run(max_steps=max_steps)
    return [out[r] for r in rids]


def _tp_mesh(shape, names):
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


# ---- the head-sharded decode (serving/sharded_decode.py) ----

@pytest.mark.parametrize("quantized", [False, "int8"], ids=["f32", "int8"])
def test_sharded_paged_decode_matches_jax(quantized):
    """tp = 4 over 8 KV heads (16 q heads): the port's shards against JAX's
    shard_map decode, and against the port's flat decode (the heads are
    independent; the CPU's batched float32 products may block a batch of 2
    heads apart from one of 8, a float32 ulp here and there)."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = cache_cfgs(quantized, n_kv=8, max_seqs=3)
    jc, tc = caches_from(random_state(tcfg, rng, [151, 64, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (3, 16, 32)).astype(np.float32)
    want = np.asarray(jsharded(jmake_mesh((1, 4), ("data", "model"), jax.devices()[:4]), jcfg,
                               interpret=True)(jnp.asarray(q), jc))
    mesh = _tp_mesh((4,), ("model",))
    shards = shard_cache_heads(tc, tcfg, mesh)
    assert [c.k_pages.shape[0] for c in shards] == [2] * 4
    got = sharded_paged_decode(mesh, tcfg)(torch.from_numpy(q), shards)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 if not quantized else 1e-3)
    flat = tdec.paged_decode_attention(torch.from_numpy(q), tc, tcfg)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0, atol=1e-7)


def test_sharded_paged_decode_rejects_what_jax_rejects():
    jcfg, tcfg = cache_cfgs("int8", n_kv=2)
    with pytest.raises(ValueError, match="not divisible"):
        jsharded(jmake_mesh((1, 4), ("data", "model"), jax.devices()[:4]), jcfg)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_paged_decode(_tp_mesh((4,), ("model",)), tcfg)


# ---- Megatron placement ----

def test_megatron_shards_match_jax_addressable_shards(params_np, model):
    """The port's shards of every parameter against the JAX TP engine's
    addressable shards (model axis 2): columns of wq/wk/wv/w1/w3, rows of
    wo/w2, the rest replicated; and the engine's own shards are those of
    its cast copy, which keeps no layer of its own (each device holds only
    its slices and what is replicated)."""
    je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**TP_ECFG),
                           mesh=jmake_mesh((1, 2), ("data", "model"), jax.devices()[:2]))
    shards = teng.megatron_shards(model, 2, ["cpu", "cpu"])

    def check(name, jleaf, tleaves):
        for s in jleaf.addressable_shards:
            axis = next((i for i, sl in enumerate(s.index) if sl != slice(None)), None)
            t = 0 if axis is None else s.index[axis].start // s.data.shape[axis]
            if axis is None:   # replicated: every port shard holds it whole
                for leaf in tleaves:
                    np.testing.assert_array_equal(leaf.numpy(), np.asarray(s.data), name)
            else:
                np.testing.assert_array_equal(tleaves[t].numpy(), np.asarray(s.data), name)

    check("embed", je.params["embed"], [s.embed for s in shards])
    check("final_norm", je.params["final_norm"], [s.final_norm for s in shards])
    for i, layer in enumerate(je.params["layers"]):
        for name, leaf in layer.items():
            check(f"{i}.{name}", leaf, [getattr(s.layers[i], name) for s in shards])
    assert shards[0].cfg.n_heads == 2 and shards[0].layers[0].w2.shape == (64, 64)
    te = teng.DecodeEngine(TCFG, model, teng.EngineConfig(**TP_ECFG),
                           mesh=_tp_mesh((1, 2), ("data", "model")))
    for got, want in zip(te._params, teng.megatron_shards(ttf.inference_weights(model, "cpu"), 2)):
        for a, b in zip(got.parameters(), want.parameters()):
            assert torch.equal(a, b)
    assert len(te.model.layers) == 0
    assert te._params[0].embed.data_ptr() == te.model.embed.data_ptr()
    # the slices own their storage: none is a view of a full weight
    assert all(w.untyped_storage().nbytes() == w.numel() * w.element_size()
               for s in te._params for w in s.layers.parameters())


# ---- the TP engine ----

def test_tp_engine_matches_jax_and_dense(params_np, model):
    """tp = 2 (test_serving.py's TP test, with two requests that share a
    page for the prefix cache): the JAX TP engine's tokens, stats, prefix
    hits and free pages, and the dense greedy tokens; then speculation."""
    jparams = jax.tree.map(jnp.asarray, params_np)
    jmesh = jmake_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    shared = [(i * 5 + 3) % 64 for i in range(64)]
    reqs = [([1, 2, 3, 4, 5], 6), ([7, 8, 9, 10, 11, 12, 13], 6), (shared + [5, 6, 7], 4),
            (shared + [9], 4)]
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**TP_ECFG), mesh=jmesh)
    want = _serve(je, reqs)
    te = teng.DecodeEngine(TCFG, model, teng.EngineConfig(**TP_ECFG),
                           mesh=_tp_mesh((1, 2), ("data", "model")))
    assert (te.tp, te.cp) == (2, 1) and len(te.shards) == 2
    assert te.shards[0][0].k_pages.shape[0] == te.shards[1][0].k_pages.shape[0] == 1
    got = _serve(te, reqs)
    assert got == want
    assert got[:2] == [greedy_dense(model, p, n) for p, n in reqs[:2]]
    assert te.stats == je.stats
    assert te.prefix_cache.hits == je.prefix_cache.hits >= 1
    assert te.allocator.free_pages == je.allocator.free_pages

    spec = dict(TP_ECFG, speculative_tokens=3)
    je2 = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**spec), mesh=jmesh)
    te2 = teng.DecodeEngine(TCFG, model, teng.EngineConfig(**spec),
                            mesh=_tp_mesh((1, 2), ("data", "model")))
    got2 = _serve(te2, [(PATTERN, 8)])
    assert got2 == _serve(je2, [(PATTERN, 8)]) == [greedy_dense(model, PATTERN, 8)]
    assert te2.spec_stats == je2.spec_stats and te2.spec_stats["accepted"] > 0
    assert te2.stats == je2.stats


@pytest.mark.parametrize("spec", [0, 2], ids=["greedy", "speculative"])
def test_tp_x_cp_engine_matches_jax_and_dense(params_np, model, spec):
    """model 2 x seq 4 (test_serving.py's TP x CP test): heads and pages
    sharded; the dense greedy tokens with and without speculation, and the
    JAX engine's tokens and stats without; every seq shard's pages come
    back, counted once."""
    reqs = ([([(i * 7 + 1) % 64 for i in range(40)], 10), ([7, 8, 9], 10)] if not spec
            else [([5, 9, 5, 9, 5, 9, 5], 8)])
    ecfg = dict(TPCP_ECFG, speculative_tokens=spec)
    te = teng.DecodeEngine(TCFG, model, teng.EngineConfig(**ecfg),
                           mesh=_tp_mesh((2, 4), ("model", "seq")))
    assert (te.tp, te.cp) == (2, 4) and len(te.allocators) == 4 and len(te.shards) == 8
    got = _serve(te, reqs)
    assert got == [greedy_dense(model, p, n) for p, n in reqs]
    if not spec:
        # the JAX engine under the same mesh (its speculative run is held to
        # the same dense tokens by test_serving.py)
        je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                               jeng.EngineConfig(**ecfg),
                               mesh=jmake_mesh((2, 4), ("model", "seq"), jax.devices()[:8]))
        assert got == _serve(je, reqs)
        assert te.stats == je.stats
    else:
        assert te.spec_stats["accepted"] > 0
    assert [a.free_pages for a in te.allocators] == [TPCP_ECFG["n_pages"] - 1] * 4
    assert all(int(c.lengths.abs().sum()) == 0 for shard in te.shards for c in shard)


def test_create_seq_sharded_cache_with_head_axis():
    """One cache a (seq shard, head shard) of n_kv / tp heads, as the JAX
    cache's head dim shards; the head shards of a seq shard share one page
    table on one device and keep lengths of their own."""
    from tf_flash_attention_tpu.serving.seq_sharded_decode import (
        create_seq_sharded_cache as jcreate)
    jcfg, tcfg = cache_cfgs("int8", n_kv=4)
    jc = jcreate(jcfg, jmake_mesh((2, 4), ("model", "seq"), jax.devices()[:8]), "seq",
                 head_axis="model")
    tc = create_seq_sharded_cache(tcfg, _tp_mesh((2, 4), ("model", "seq")), "seq",
                                  head_axis="model")
    assert len(tc) == 4 and all(len(row) == 2 for row in tc)
    shard = jc.k_pages.addressable_shards[0].data.shape        # (1, n_kv / tp, ...)
    for row in tc:
        assert row[0].page_tables is row[1].page_tables
        assert row[0].lengths is not row[1].lengths
        for c in row:
            assert tuple(c.k_pages.shape) == shard[1:]
            assert tuple(c.k_scales.shape) == jc.k_scales.addressable_shards[0].data.shape[1:]


@pytest.mark.parametrize("case", [dict(tp=3, match="not divisible"),
                                  dict(tp=2, engine=dict(prefill_mode="bucketed"),
                                       match="chunked")],
                         ids=["heads_tp", "bucketed"])
def test_tp_engine_rejects_what_jax_rejects(params_np, model, case):
    tp, ecfg = case["tp"], dict(TP_ECFG, **case.get("engine", {}))
    with pytest.raises(ValueError, match=case["match"]):
        jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np), jeng.EngineConfig(**ecfg),
                          mesh=jmake_mesh((1, tp), ("data", "model"), jax.devices()[:tp]))
    with pytest.raises(ValueError, match=case["match"]):
        teng.DecodeEngine(TCFG, model, teng.EngineConfig(**ecfg),
                          mesh=_tp_mesh((1, tp), ("data", "model")))
