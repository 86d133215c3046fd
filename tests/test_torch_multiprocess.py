"""Serving over a process group, on the CPU: one process a mesh slot.

One world of 4 processes joined by a gloo group (``_torch_mp_world.py``)
is spawned once for the module and runs every case; the tests assert on
what it sends back.  Meanwhile this process computes the references: the
JAX engine on a 4-device CPU mesh (model 2 x seq 2) and the JAX package's
``shard_map`` callables in interpret mode (each once; the callables start
from the port's written cache, which ``test_torch_seq_sharded.py`` holds
to JAX's write), and the port's single-controller engines and callables
on ``"cpu"`` four times, which run the same code on an in-process mesh.
The ranks' sums over the group are the in-process sums in shard order,
so a rank's results are bit-equal to the single-controller ones; against
JAX the tolerances are those of ``test_torch_tp_engine.py`` and
``test_torch_seq_sharded.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu.serving import seq_sharded_decode as jsd
from tf_flash_attention_tpu.serving.sharded_decode import sharded_paged_decode as jsharded
from tf_flash_attention_tpu_torch.models.transformer import inference_weights, params_from_jax
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
from tf_flash_attention_tpu_torch.serving import graphs
from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
from tf_flash_attention_tpu_torch.serving.engine import megatron_shards
from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache

import _torch_mp_world as mpw
from _torch_parity import cache_cfgs, caches_from, random_state, raw

MCFG = jtf.ModelConfig(**mpw.MODEL, max_seq=256, dtype=jnp.float32)
# the callables against JAX: test_torch_tp_engine.py:74 (int8 cache) and
# test_torch_seq_sharded.py (the merge at bf16-rounded p)
TOL_INT8 = 1e-3
OUTPUTS = ["sharded_decode", "decode", "decode_after", "prefill"]


def _jax_engine(params_np):
    """The JAX engine's tokens on 4 virtual CPU devices (model 2 x seq 2)."""
    eng = jeng.DecodeEngine(MCFG, jax.tree.map(jnp.asarray, params_np),
                            jeng.EngineConfig(**mpw.ENGINE),
                            mesh=jmake_mesh((2, 2), ("model", "seq"), jax.devices()[:4]))
    rids = [eng.submit(p, max_new_tokens=n) for p, n in mpw.REQUESTS]
    res = eng.run(max_steps=200)
    return [res[r] for r in rids]


def _jax_callables(inputs, tp_state, written):
    """JAX's sharded decode at tp 4, and its seq-sharded decode, appends,
    decode and prefill on 4 devices, as ``mpw.run_callables`` runs the
    port's."""
    out = {}
    jcfg, tcfg = cache_cfgs(True, n_kv=8, max_seqs=3)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(mpw.tp_cfg())
    jc = caches_from(tp_state, jcfg, tcfg)[0]
    out["sharded_decode"] = np.asarray(jsharded(
        jmake_mesh((1, 4), ("data", "model"), jax.devices()[:4]), jcfg, interpret=True)(
            jnp.asarray(inputs["tp_q"]), jc))
    jcfg, tcfg = cache_cfgs(True, page_size=32, n_pages=8, max_seqs=2, max_pages_per_seq=6)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(mpw.cp_cfg())
    mesh = jmake_mesh((4,), ("seq",), jax.devices()[:4])
    # JAX's sharded cache: the shards stacked on a leading axis
    jc = jsd.PagedKVCache(**{name: jnp.asarray(np.stack([written[r][name] for r in range(4)]))
                             for name in written[0]})
    tables = np.array(jc.page_tables)
    tables[0, 0, 2] = 3
    jc = dataclasses.replace(jc, page_tables=jnp.asarray(tables))
    decode = jsd.seq_sharded_paged_decode(mesh, jcfg, "seq", interpret=True)
    out["decode"] = np.asarray(decode(jnp.asarray(inputs["q"]), jc))
    append = jsd.seq_sharded_append(mesh, jcfg, "seq", trash_page=jcfg.n_pages - 1,
                                    interpret=True)
    active = jnp.asarray([True, False])
    for kn in inputs["appends"]:
        k_new = np.zeros((2, 2, 32), np.float32)
        k_new[0] = kn
        jc = append(jc, jnp.asarray(k_new), jnp.asarray(-k_new), active)
    out["shards"] = {r: {name: np.asarray(getattr(jc, name))[r]
                         for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths")}
                     for r in range(4)}
    out["decode_after"] = np.asarray(decode(jnp.asarray(inputs["q"]), jc))
    start = inputs["t"] + len(inputs["appends"]) - 40
    out["prefill"] = np.asarray(jsd.seq_sharded_paged_prefill(mesh, jcfg, "seq",
                                                              interpret=True)(
        jnp.asarray(inputs["qp"]), jc, jnp.asarray(0), jnp.asarray(start), jnp.asarray(40)))
    return out


@pytest.fixture(scope="module")
def world():
    """The ranks' results beside the references: {"ranks": {rank: ...},
    "single": the port single-controller, "jax": the JAX package's,
    "params": the model's numpy weights}."""
    params_np = jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))
    inputs = mpw.callable_inputs()
    tp_state = random_state(mpw.tp_cfg(), np.random.default_rng(3), [151, 64, 0])
    started = mpw.start(dict(params=params_np, callables=inputs, tp_state=tp_state))
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        single = dict(engines=mpw.serve_engines(params_np, ["cpu"] * mpw.WORLD),
                      callables=mpw.run_callables(inputs, tp_state, ["cpu"] * mpw.WORLD))
        torch.set_num_threads(n)
        ref = dict(engine=_jax_engine(params_np),
                   callables=_jax_callables(inputs, tp_state, single["callables"]["written"]))
    finally:
        ranks = mpw.join(started)
    return dict(ranks=ranks, single=single, jax=ref, params=params_np)


ENGINES = list(mpw.LAYOUTS)
RUNS = ENGINES + ["tp2cp2_spec", "cp4_sampled"]


@pytest.mark.parametrize("name", ENGINES)
def test_engine_tokens_match_jax(world, name):
    """Every rank's greedy float32 tokens equal the JAX engine's on a
    4-device mesh (model 2 x seq 2, the same configuration), and so do the
    single-controller port's."""
    want = world["jax"]["engine"]
    assert world["single"]["engines"][name]["tokens"] == want
    for rank, res in world["ranks"].items():
        assert res["engines"][name]["tokens"] == want, rank


@pytest.mark.parametrize("name", RUNS)
def test_engine_matches_single_controller(world, name):
    """A rank's engine against the single-controller engine on ``"cpu"``
    four times: the same tokens, the last prompt token's logits bit for bit
    (sums in shard order on both), stats, drafts and free pages."""
    want = world["single"]["engines"][name]
    for rank, res in world["ranks"].items():
        got = res["engines"][name]
        assert got["tokens"] == want["tokens"], rank
        assert got["logits"].keys() == want["logits"].keys()
        for i in want["logits"]:
            np.testing.assert_array_equal(got["logits"][i], want["logits"][i])
        assert (got["stats"], got["spec_stats"], got["free"]) == (
            want["stats"], want["spec_stats"], want["free"])
    if name.endswith("spec"):
        assert want["spec_stats"]["accepted"] > 0


@pytest.mark.parametrize("name", RUNS)
def test_every_rank_equal(world, name):
    """Every rank returns the same tokens and logits: the sampler draws from
    a generator seeded alike over the same numbers everywhere (sampled
    requests included)."""
    ranks = world["ranks"]
    first = ranks[0]["engines"][name]
    for rank in range(1, mpw.WORLD):
        got = ranks[rank]["engines"][name]
        assert got["tokens"] == first["tokens"], rank
        for i in first["logits"]:
            np.testing.assert_array_equal(got["logits"][i], first["logits"][i])


@pytest.mark.parametrize("name", ENGINES)
def test_rank_holds_its_own_slot(world, name):
    """A rank builds one head shard's Megatron slices and one (seq, head)
    shard's caches: its slot's, by rank (rank k at flat index k)."""
    shape, axes = mpw.LAYOUTS[name]
    tp = dict(zip(axes, shape)).get("model", 1)
    model = inference_weights(params_from_jax(mpw.model_cfg(), world["params"], "cpu"), "cpu")
    shards = megatron_shards(model, tp) if tp > 1 else [model]
    for rank, res in world["ranks"].items():
        got = res["engines"][name]
        assert got["held"] == (1, 1), rank
        t = dict(zip(axes, np.unravel_index(rank, shape))).get("model", 0)
        np.testing.assert_array_equal(got["wq"], shards[t].layers[0].wq.numpy())


@pytest.mark.parametrize("out", OUTPUTS)
def test_callables_match_jax(world, out):
    """The four callables across ranks against JAX's ``shard_map`` versions
    (int8 caches; every rank holds the whole output)."""
    want = world["jax"]["callables"][out]
    for rank, res in world["ranks"].items():
        got = res["callables"][out]
        if out == "prefill":
            got, want = got[:40], want[:40]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8, err_msg=str(rank))


@pytest.mark.parametrize("out", OUTPUTS)
def test_callables_match_single_controller(world, out):
    """The same calls bit for bit against the single-controller callables."""
    want = world["single"]["callables"][out]
    for rank, res in world["ranks"].items():
        np.testing.assert_array_equal(res["callables"][out], want, err_msg=str(rank))


def test_appends_land_on_each_ranks_shard(world):
    """Rank r drives shard r: after the prompt's write its shard equals the
    single-controller one, and after the appends also JAX's slice of it
    (payloads and scales outside the trash page, lengths)."""
    trash = mpw.cp_cfg().n_pages - 1
    jax_shards = world["jax"]["callables"]["shards"]
    single = world["single"]["callables"]
    for rank, res in world["ranks"].items():
        assert list(res["callables"]["shards"]) == [rank]
        for name, x in res["callables"]["written"][rank].items():
            np.testing.assert_array_equal(x, single["written"][rank][name], err_msg=name)
        got = res["callables"]["shards"][rank]
        for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
            a, b, c = got[name], jax_shards[rank][name], single["shards"][rank][name]
            np.testing.assert_array_equal(a, c, err_msg=name)
            if name != "lengths":
                a, b = a[:, :trash], b[:, :trash]
            np.testing.assert_array_equal(raw(a), raw(b), err_msg=f"rank {rank} {name}")
    inputs = mpw.callable_inputs()
    assert sum(int(r["callables"]["shards"][k]["lengths"][0]) for k, r in
               world["ranks"].items()) == inputs["t"] + len(inputs["appends"])


def test_mesh_ownership_by_rank(world):
    """``make_mesh`` over the group with ``"cpu"`` four times: rank k holds
    the slot at flat index k, its coordinates and device are its own,
    ``shard`` returns its block only and ``unshard`` gathers the whole;
    ``devices=None`` gives every rank its own device (the CPU here)."""
    x = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    for rank, res in world["ranks"].items():
        m = res["mesh"]
        i, j = divmod(rank, 2)
        assert m["ranks"] == [[0, 1], [2, 3]]
        assert m["coords"] == {"model": i, "seq": j}
        assert m["device"] == "cpu" and m["local"] == ["cpu"]
        np.testing.assert_array_equal(m["block"], x[2 * i:2 * i + 2, :, j:j + 1])
        assert m["back_equal"]
        assert m["auto_devices"] == ["cpu"] * mpw.WORLD
        assert m["axis"] == (2, j, True)


def test_collectives_over_gloo(world):
    """``psum``/``pmax`` of int32 over the seq line and an ``all_gather`` of
    bf16 (raw bytes through gloo) over the model line, on every rank."""
    for rank, res in world["ranks"].items():
        m = res["mesh"]
        line = [2 * (rank // 2), 2 * (rank // 2) + 1]          # the seq line
        assert m["psum"] == [sum(line), -sum(line)]
        assert m["pmax"] == [max(line), -min(line)]
        col = [rank % 2, rank % 2 + 2]                         # the model line
        assert m["gather"] == [[r + 0.5] * 3 for r in col]


def test_gloo_refuses_capture_and_training_refuses_the_mesh(world):
    """On the CPU nothing is captured (no refusal); a gloo group on a CUDA
    device is refused with a message naming it; and the training
    callables, once refused on a process-group mesh, now run on it:
    ``ring_flash_attention`` on the (model 2, seq 2) mesh returns the whole
    causal attention on every rank (``test_torch_mp_train.py`` holds the
    training factories to JAX)."""
    for res in world["ranks"].values():
        m = res["mesh"]
        assert m["refusal_cpu"] is None
        assert "gloo" in m["refusal_cuda"] and "eagerly" in m["refusal_cuda"]
        np.testing.assert_allclose(m["ring"], m["ring_plain"], rtol=2e-5, atol=2e-5)


# ---- the callables' graph keys (the graphs themselves: test_torch_cuda.py) ----

def test_cache_key_is_the_cache_tensors_identity():
    """Two caches of one shape have different keys, a cache keeps its key
    through in-place updates, and nested lists key by every cache."""
    cfg = mpw.cp_cfg()
    a, b = PagedKVCache.create(cfg, "cpu"), PagedKVCache.create(cfg, "cpu")
    key = graphs.cache_key(a)
    assert len(key) == 6 and key[0] == a.k_pages.data_ptr()
    assert graphs.cache_key(b) != key
    a.lengths.add_(1)
    a.k_pages[0, 0, 0, 0] = 1
    assert graphs.cache_key(a) == key
    assert graphs.cache_key([[a, b]]) == ((key, graphs.cache_key(b)),)


def test_callables_on_the_cpu_are_eager():
    """On the CPU the four factories return the eager function, no
    ``GraphedCall``."""
    from tf_flash_attention_tpu_torch.serving.sharded_decode import sharded_paged_decode
    mesh = make_mesh((4,), ("seq",), ["cpu"] * 4)
    cfg = mpw.cp_cfg()
    fns = [tsd.seq_sharded_paged_decode(mesh, cfg, "seq"),
           tsd.seq_sharded_paged_prefill(mesh, cfg, "seq"),
           tsd.seq_sharded_append(mesh, cfg, "seq", trash_page=7),
           sharded_paged_decode(make_mesh((2,), ("model",), ["cpu"] * 2), cfg)]
    assert not any(isinstance(f, graphs.GraphedCall) for f in fns)
