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
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
from tf_flash_attention_tpu_torch.serving import engine as teng

from _torch_parity import PAYLOADS, one_torch_thread

# many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
ECFG = dict(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4, prefill_chunk=64)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


def test_params_from_jax_round_trips(params_np):
    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    np.testing.assert_array_equal(model.embed.detach().numpy(), params_np["embed"])
    np.testing.assert_array_equal(model.final_norm.detach().numpy(), params_np["final_norm"])
    for block, layer in zip(model.layers, params_np["layers"]):
        for name, value in layer.items():
            np.testing.assert_array_equal(getattr(block, name).detach().numpy(), value,
                                          err_msg=name)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())


def test_params_cast_once_norms_stay_float32(params_np):
    # parameters stay float32 and trainable; the engine casts its own copy once
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    params = ttf.params_from_jax(cfg, params_np, "cpu")
    model = teng.DecodeEngine(cfg, params, teng.EngineConfig(**ECFG), device="cpu").model
    assert params.embed.dtype == params.layers[0].wq.dtype == torch.float32
    assert model.embed.dtype == model.layers[0].wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.dtype == model.final_norm.dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(
        model.layers[1].w2.float().numpy(),
        np.asarray(jnp.asarray(params_np["layers"][1]["w2"]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_init_params_scales():
    cfg = dataclasses.replace(TCFG, vocab=512, d_model=256, d_ff=512)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
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


def test_rope_at_batch_matches_jax():
    """Token grids (S, T) as the speculative step rotates them."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    pos = (np.array([0, 70, 300])[:, None] + np.arange(4)).astype(np.int32)
    np.testing.assert_allclose(
        teng._rope_at(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jeng._rope_at_batch(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=0, atol=2e-5)


def _prompts():
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, 64, 64)]       # one full page
    return [[int(t) for t in rng.integers(1, 64, 100)],       # longer than a chunk
            shared + [5, 6, 7], shared + [9]]


def _engine(params_np, cfg=TCFG, **ecfg):
    """A port engine on the CPU from the JAX parameters."""
    return teng.DecodeEngine(cfg, ttf.params_from_jax(cfg, params_np, "cpu"),
                             teng.EngineConfig(**dict(ECFG, **ecfg)), device="cpu")


def _kv_options(quantized):
    """(JAX, port) EngineConfig KV options: False, True (int8) or a payload."""
    if not quantized:
        return dict(quantized_kv=False), dict(quantized_kv=False)
    jq, tq = PAYLOADS["int8" if quantized is True else quantized]
    return dict(kv_quant_dtype=jq), dict(kv_quant_dtype=tq)


# greedy parity with the JAX engine: same weights, same prompts, same
# schedule; the two requests sharing a page hit the prefix cache.  The int4
# engine's odd prompt lengths leave half-filled byte rows for the appends
@pytest.mark.parametrize("quantized", [False, True, "e4m3", "int4"])
def test_engine_matches_jax_engine(params_np, quantized):
    prompts = _prompts()
    jkv, tkv = _kv_options(quantized)
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**ECFG, **jkv))
    jr = [je.submit(p, max_new_tokens=8) for p in prompts]
    want = je.run()
    te = _engine(params_np, **tkv)
    tr = [te.submit(p, max_new_tokens=8) for p in prompts]
    got = te.run()
    for a, b in zip(jr, tr):
        assert got[b] == want[a], (got[b], want[a])
    assert te.stats == je.stats
    assert te.prefix_cache.hits == je.prefix_cache.hits >= 1
    assert te.allocator.free_pages == je.allocator.free_pages


PATTERN = [5, 9, 5, 9, 5, 9, 5, 9, 5]   # material for the n-gram proposer


SPEC = dict(speculative_tokens=3, prefill_chunk=8, prefix_caching=False)


# speculative greedy against the JAX engine: the pattern prompt gets drafts
# accepted; the second request stops at its budget inside a step
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_speculative_matches_jax_engine(params_np, quantized):
    jkv, tkv = _kv_options(quantized)
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**dict(ECFG, **jkv, **SPEC)))
    te = _engine(params_np, **tkv, **SPEC)
    reqs = [(PATTERN, 12), ([1, 2, 3, 4, 5], 7)]
    jr = [je.submit(p, max_new_tokens=n) for p, n in reqs]
    tr = [te.submit(p, max_new_tokens=n) for p, n in reqs]
    want, got = je.run(max_steps=50), te.run(max_steps=50)
    for a, b in zip(jr, tr):
        assert got[b] == want[a], (got[b], want[a])
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert te.spec_stats["accepted"] > 0
    assert te.stats["steps"] < te.stats["decode_tokens"]   # drafts saved steps
    assert te.allocator.free_pages == je.allocator.free_pages


def _oracle_proposer(continuations):
    """A proposer that drafts the known greedy continuation of each request
    (every draft is accepted): ``continuations`` maps prompt to tokens."""
    def propose(hist, n_draft):
        for full in continuations:
            if hist == full[:len(hist)] and len(full) > len(hist):
                cont = full[len(hist):len(hist) + n_draft]
                return cont + [cont[-1]] * (n_draft - len(cont))
        return [hist[-1]] * n_draft
    return propose


# an EOS that is an accepted draft with drafts after it: the step keeps
# the run up to the EOS and the request retires there, as in JAX
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_speculative_eos_inside_accepted_run(params_np, quantized):
    jkv, tkv = _kv_options(quantized)
    dry = _engine(params_np, **tkv, **SPEC)
    r = dry.submit(PATTERN, max_new_tokens=12)
    full = dry.run()[r]
    gen = full[len(PATTERN):]
    # with every draft accepted, the first step emits gen[1:5]: gen[2] is an
    # accepted draft with two tokens after it
    i = next(i for i in (2, 3, 1) if gen[i] not in gen[:i])
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**dict(ECFG, **jkv, **SPEC)))
    te = _engine(params_np, **tkv, **SPEC)
    je._propose = te._propose = _oracle_proposer([full])
    jr = je.submit(PATTERN, max_new_tokens=12, eos_id=gen[i])
    tr = te.submit(PATTERN, max_new_tokens=12, eos_id=gen[i])
    want, got = je.run(max_steps=50), te.run(max_steps=50)
    assert got[tr] == want[jr] == full[:len(PATTERN) + i + 1]
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert te.stats["steps"] == 1 and te.spec_stats == {"proposed": 3, "accepted": 3}
    assert te.allocator.free_pages == je.allocator.free_pages


def test_engine_speculative_int4(params_np):
    """Speculation over an int4 cache: the appends of one step fill both
    nibbles of byte rows; the JAX engine gives the same tokens."""
    jkv, tkv = _kv_options("int4")
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**dict(ECFG, **jkv, **SPEC)))
    te = _engine(params_np, **tkv, **SPEC)
    jr, tr = je.submit(PATTERN, max_new_tokens=10), te.submit(PATTERN, max_new_tokens=10)
    assert te.run(max_steps=50)[tr] == je.run(max_steps=50)[jr]
    assert te.stats == je.stats and te.spec_stats == je.spec_stats


def test_engine_speculative_sampled_slot(params_np):
    """A sampled slot emits one token per step; the greedy slot beside it
    keeps the tokens it has alone."""
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams
    spec = dict(speculative_tokens=3, seed=3)
    te = _engine(params_np, **spec)
    g = te.submit(PATTERN, max_new_tokens=10)
    s = te.submit([1, 2, 3], max_new_tokens=6,
                  sampling=SamplingParams(temperature=1.0, top_k=10))
    te.step()                              # admits both: one token each from prefill
    while te.num_active:
        before = len(te._results[s])
        active = te._slots[1] is not None
        te.step()
        if active:
            assert len(te._results[s]) == before + 1
    out = te._results
    assert len(out[s]) == 3 + 6 and all(0 <= t < 64 for t in out[s])
    alone = _engine(params_np, **spec)
    r = alone.submit(PATTERN, max_new_tokens=10)
    assert out[g] == alone.run()[r]
    assert te.spec_stats["proposed"] == alone.spec_stats["proposed"]


def test_engine_speculative_capacity_matches_jax(params_np):
    """Drafts cross into the page past the prompt's: the engine maps it
    before the appends, as the JAX engine does, page for page (a step that
    starts on a page boundary maps that page again; the slot hands every
    page back at retirement)."""
    spec = dict(speculative_tokens=3, prefix_caching=False)
    prompt = list(range(1, 63))                 # 62 tokens: drafts reach page 1
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jeng.DecodeEngine(MCFG, jparams, jeng.EngineConfig(**dict(ECFG, **spec)))
    te = _engine(params_np, **spec)
    jr, tr = je.submit(prompt, max_new_tokens=6), te.submit(prompt, max_new_tokens=6)
    want, got = je.run(), te.run()
    assert got[tr] == want[jr] and len(got[tr]) == 62 + 6
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert te.stats["pages_in_use_peak"] >= 2
    assert te.allocator.free_pages == je.allocator.free_pages == ECFG["n_pages"] - 1


# context parallelism: 4 shards on the CPU, pages of 16 tokens (a 40-token
# prompt spans shards 0-2; generations cross into shard 3's page and back
# to shard 0's), 8 pages a shard
CP_ECFG = dict(max_seqs=2, page_size=16, n_pages=8, max_pages_per_seq=4, prefill_chunk=16,
               prefix_caching=False)
CP_REQS = [([(i * 7 + 1) % 64 for i in range(40)], 10), ([7, 8, 9], 10)]


def _cp_engine(params_np, **ecfg):
    mesh = make_mesh((4,), ("seq",), ["cpu"] * 4)
    return teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                             teng.EngineConfig(**dict(CP_ECFG, **ecfg)), mesh=mesh)


def _serve(engine, reqs, max_steps=80):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    out = engine.run(max_steps=max_steps)
    return [out[r] for r in rids]


# the JAX engine's contract is that context parallelism gives the greedy
# tokens of one device: the port's CP engine against the JAX engine on one
# device (the same pages of 16, 16 a sequence), with and without
# speculation (the pattern prompt gets drafts accepted)
@pytest.mark.parametrize("spec", [0, 3], ids=["greedy", "speculative"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_engine_context_parallel_matches_jax_flat(params_np, quantized, spec):
    jkv, tkv = _kv_options(quantized)
    flat = dict(CP_ECFG, n_pages=32, max_pages_per_seq=16, speculative_tokens=spec)
    je = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                           jeng.EngineConfig(**flat, **jkv))
    te = _cp_engine(params_np, speculative_tokens=spec, **tkv)
    assert te.cp == 4 and te.prefix_cache is None
    reqs = CP_REQS + ([(PATTERN, 12)] if spec else [])
    assert _serve(te, reqs) == _serve(je, reqs)
    assert ({k: v for k, v in te.stats.items() if k != "pages_in_use_peak"}
            == {k: v for k, v in je.stats.items() if k != "pages_in_use_peak"})
    assert te.spec_stats == je.spec_stats
    if spec:
        assert te.spec_stats["accepted"] > 0
    assert [a.free_pages for a in te.allocators] == [CP_ECFG["n_pages"] - 1] * 4
    assert all(int(c.lengths.abs().sum()) == 0 for shard in te.shards for c in shard)


def test_engine_context_parallel_int4_deterministic(params_np):
    """int4 under page striding: the noise of 4-bit keys may flip a greedy
    choice against another engine, so the contract is the JAX test's:
    deterministic, full-length outputs, with and without speculation."""
    _, tkv = _kv_options("int4")
    for spec in (0, 3):
        reqs = CP_REQS + [(PATTERN, 12)]
        a = _serve(_cp_engine(params_np, speculative_tokens=spec, **tkv), reqs)
        b = _serve(_cp_engine(params_np, speculative_tokens=spec, **tkv), reqs)
        assert a == b
        assert [len(x) for x in a] == [len(p) + n for p, n in reqs]


def test_engine_cp_admission_respects_binding_shard(params_np):
    """Every sequence's first page is on shard 0, so admission budgets the
    binding shard: six 1-page requests against 3 usable pages a shard queue
    (3 at a time) and all finish, with the tokens of one device."""
    reqs = [([i + 1, i + 2, i + 3], 4) for i in range(6)]
    te = _cp_engine(params_np, max_seqs=6, n_pages=4)
    got = _serve(te, reqs)
    assert [len(x) for x in got] == [7] * 6
    assert te.stats["pages_in_use_peak"] == 3 and te.stats["admitted"] == 6
    assert got == _serve(_engine(params_np, max_seqs=6, page_size=16, n_pages=32,
                                 max_pages_per_seq=16, prefix_caching=False), reqs)


def test_engine_eos_and_queueing(params_np):
    """More requests than slots queue; an EOS stops a request early."""
    te = _engine(params_np, max_seqs=2)
    first = te.submit([1, 2, 3], max_new_tokens=4)
    rest = [te.submit([i + 1, i + 2], max_new_tokens=3) for i in range(3)]
    out = te.run()
    assert len(out[first]) == 3 + 4 and all(len(out[r]) == 2 + 3 for r in rest)
    eos = out[first][4]
    stop = 3 + out[first][3:].index(eos) + 1
    te2 = _engine(params_np)
    rid = te2.submit([1, 2, 3], max_new_tokens=8, eos_id=eos)
    assert te2.run()[rid] == out[first][:stop]
    assert te2.allocator.free_pages + len(te2.prefix_cache) == ECFG["n_pages"] - 1


def test_engine_sampled_request_runs(params_np):
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams
    te = _engine(params_np, seed=3)
    g = te.submit([1, 2, 3], max_new_tokens=5)
    s = te.submit([1, 2, 3], max_new_tokens=5,
                  sampling=SamplingParams(temperature=1.0, top_k=10))
    out = te.run()
    assert len(out[s]) == 8 and all(0 <= t < 64 for t in out[s])
    greedy_alone = _engine(params_np)
    r = greedy_alone.submit([1, 2, 3], max_new_tokens=5)
    assert out[g] == greedy_alone.run()[r]   # co-batching leaves greedy alone


def test_engine_defaults_to_the_card(params_np):
    """Without ``device`` the engine runs on the CUDA card; here, with no
    card, building one fails loudly instead of falling back to the CPU."""
    params = ttf.params_from_jax(TCFG, params_np, "cpu")
    if torch.cuda.is_available():
        assert teng.DecodeEngine(TCFG, params, teng.EngineConfig(**ECFG)).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        teng.DecodeEngine(TCFG, params, teng.EngineConfig(**ECFG))
    with pytest.raises((AssertionError, RuntimeError)):
        ttf.init_params(TCFG)


# the JAX engine's ValueError cases: a rule that is not left-to-right, a
# window model or a mesh with the bucketed prefill, a table too small for a
# window's live set (flat, with speculation, under cp), speculation past a
# page under cp, and an MoE model under tp, cp or both; "rule" is (window,
# log2 stride, causal) or "full"
BUCKETED = dict(prefill_mode="bucketed")


@pytest.mark.parametrize("case", [
    dict(rule=(8, 0, True), engine=BUCKETED, match="chunked"),
    dict(rule=(4, 1, True), engine=BUCKETED, match="chunked"),
    dict(rule=(8, 0, False), match="autoregressive"),
    dict(rule=(4, 1, False), match="autoregressive"),
    dict(rule=(8, 0, False), engine=BUCKETED, match="autoregressive"),
    dict(rule="full", match="autoregressive"),
    dict(cp=4, engine=BUCKETED, match="chunked"),
    dict(cp=2, engine=BUCKETED, match="chunked"),
    dict(cp=4, rule=(12, 0, True), engine=BUCKETED, match="chunked"),
    dict(rule=(64, 0, True), match="too small"),
    dict(rule=(16, 2, True), match="too small"),
    dict(rule=(56, 0, True), engine=dict(speculative_tokens=8), match="too small"),
    dict(cp=4, rule=(600, 0, True), match="too small"),
    dict(cp=4, engine=dict(page_size=2, speculative_tokens=3), match="page_size"),
    dict(moe=True, tp=2, match="tensor-parallel engine does not support MoE"),
    dict(moe=True, cp=2, match="context-parallel engine does not support MoE"),
    dict(moe=True, tp=2, cp=2, match="tensor-parallel engine does not support MoE"),
], ids=["window_bucketed", "strided_bucketed", "window_noncausal", "strided_noncausal",
        "noncausal_bucketed", "full_rule", "cp4_bucketed", "cp2_bucketed", "cp_window_bucketed",
        "window_table_small", "strided_table_small", "window_spec_table_small",
        "cp_window_table_small", "cp_spec_page_small", "moe_tp2", "moe_cp2", "moe_tp2_cp2"])
def test_engine_rejects_what_jax_rejects(params_np, moe_params_np, case):
    """Each configuration the JAX engine refuses with a ValueError, the port's
    engine refuses too, with the same words."""
    from tf_flash_attention_tpu.mask_rules import FullRule as JFullRule
    from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
    from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tf_flash_attention_tpu_torch.mask_rules import FullRule

    rule, cp, tp = case.get("rule"), case.get("cp", 1), case.get("tp", 1)
    rules = {None: ({}, {}), "full": (dict(rule=JFullRule()), dict(rule=FullRule()))}
    jrule, trule = (rules[rule] if rule in rules else
                    (dict(rule=JLocalRule(*rule)), dict(rule=LocalRule(*rule))))
    if case.get("moe"):
        jrule, trule, params_np = (dict(rule=jrule.get("rule", MCFG.rule), n_experts=4),
                                   dict(trule, n_experts=4), moe_params_np)
    ecfg = dict(ECFG, **case.get("engine", {}))
    axes = [(n, a) for n, a in ((tp, "model"), (cp, "seq")) if n > 1]
    shape, names = tuple(n for n, _ in axes), tuple(a for _, a in axes)
    with pytest.raises(ValueError, match=case["match"]):
        jeng.DecodeEngine(dataclasses.replace(MCFG, **jrule),
                          jax.tree.map(jnp.asarray, params_np), jeng.EngineConfig(**ecfg),
                          mesh=jmake_mesh(shape, names, jax.devices()[:tp * cp]) if axes else None)
    cfg = dataclasses.replace(TCFG, **trule)
    place = (dict(mesh=make_mesh(shape, names, ["cpu"] * (tp * cp))) if axes
             else dict(device="cpu"))
    with pytest.raises(ValueError, match=case["match"]):
        teng.DecodeEngine(cfg, ttf.params_from_jax(cfg, params_np, "cpu"),
                          teng.EngineConfig(**ecfg), **place)


@pytest.fixture(scope="module")
def moe_params_np():
    cfg = dataclasses.replace(MCFG, n_experts=4)
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))


def test_moe_engine_builds_flat(moe_params_np):
    """The flat MoE engine builds on both (``test_torch_moe_engine.py``
    serves on it against JAX); the Megatron placement refuses MoE with the
    JAX engine's words."""
    jeng.DecodeEngine(dataclasses.replace(MCFG, n_experts=4),
                      jax.tree.map(jnp.asarray, moe_params_np), jeng.EngineConfig(**ECFG))
    cfg = dataclasses.replace(TCFG, n_experts=4)
    params = ttf.params_from_jax(cfg, moe_params_np, "cpu")
    te = teng.DecodeEngine(cfg, params, teng.EngineConfig(**ECFG), device="cpu")
    assert te.tp == te.cp == 1 and te.model.layers[0].moe.w_in.dtype == torch.float32
    with pytest.raises(ValueError, match="tensor-parallel engine does not support MoE"):
        teng.megatron_shards(params, 2)
