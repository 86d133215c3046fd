"""A world of processes on the CPU for the port's process-group tests.

``start`` spawns ``world`` processes that join one gloo process group
(``tcp://127.0.0.1``, a free port) and each run ``run_world(rank,
inputs)``; ``join`` collects every rank's result and raises if a rank
failed.  The cases are plain functions of a mesh, so the parent runs the
same code on a single-controller mesh of ``"cpu"`` four times, and the
ranks on the process-group mesh: ``serve_engines`` and ``run_callables``
(``run_world``, serving), ``train_layouts`` and ``train_callables``
(``train_world``, training).
Nothing here imports JAX: the ranks start without it, and the parent
brings the JAX package's numbers itself.
"""

import dataclasses
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
# the engines: (mesh shape, axes) by name, one configuration
LAYOUTS = {"tp4": ((4,), ("model",)), "cp4": ((4,), ("seq",)),
           "tp2cp2": ((2, 2), ("model", "seq"))}
ENGINE = dict(max_seqs=2, page_size=16, n_pages=16, max_pages_per_seq=4, quantized_kv=False,
              prefill_mode="chunked", prefill_chunk=16, prefix_caching=False)
REQUESTS = [([(i * 7 + 1) % 64 for i in range(40)], 6), ([7, 8, 9], 6)]
SPEC_REQUESTS = [([5, 9, 5, 9, 5, 9, 5], 6)]
MODEL = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, inputs, out, case):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank)
        out.put((rank, None, globals()[case](rank, inputs)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start(inputs, world: int = WORLD, case: str = "run_world"):
    """Spawn the world, each rank running ``case(rank, inputs)`` (a function
    of this module); returns what ``join`` takes."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, inputs, out, case),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def join(started, timeout: float = 240.0):
    """{rank: result}; raises with the failing ranks' tracebacks."""
    procs, out = started
    results, errors = {}, []
    try:
        for _ in procs:
            rank, err, value = out.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = value
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(len(procs))) - set(results))} sent nothing "
                      f"within {timeout} s")
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


# ---- the cases: the same code on a single-controller and a process-group mesh ----

def model_cfg():
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig
    return ModelConfig(**MODEL, dtype=torch.float32)


def _serve(engine, reqs, sampling=None):
    logits, inner = {}, engine._prefill

    def prefill(p, slot):
        r = inner(p, slot)
        logits[len(logits)] = r[0].float().numpy().copy()
        return r

    engine._prefill = prefill
    rids = [engine.submit(p, max_new_tokens=n, **({"sampling": sampling} if sampling else {}))
            for p, n in reqs]
    res = engine.run(max_steps=200)
    return [res[r] for r in rids], logits


def serve_engines(params_np, devices):
    """Every layout's engine on a mesh of ``devices`` (a process-group mesh
    where a group is up): {name: (tokens, the last prompt token's logits by
    admission, stats, free pages, (params, shards) this process holds)};
    ``tp2cp2_spec`` adds speculation (2 drafts), ``cp4_sampled`` samples
    (temperature 0.8, top-k 10) from the engine's generator."""
    from tf_flash_attention_tpu_torch.models.transformer import params_from_jax
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    cfg = model_cfg()
    model = params_from_jax(cfg, params_np, "cpu")
    out = {}
    runs = ([(name, name, 0, REQUESTS, None) for name in LAYOUTS]
            + [("tp2cp2_spec", "tp2cp2", 2, SPEC_REQUESTS, None),
               ("cp4_sampled", "cp4", 0, REQUESTS, SamplingParams(temperature=0.8, top_k=10))])
    for label, name, spec, reqs, sampling in runs:
        shape, axes = LAYOUTS[name]
        ecfg = EngineConfig(**dict(ENGINE, speculative_tokens=spec))
        eng = DecodeEngine(cfg, model, ecfg, mesh=make_mesh(shape, axes, devices))
        tokens, logits = _serve(eng, reqs, sampling)
        out[label] = dict(tokens=tokens, logits=logits, stats=dict(eng.stats),
                          spec_stats=dict(eng.spec_stats),
                          free=[a.free_pages for a in eng.allocators],
                          held=(len(eng._params), len(eng.shards)),
                          wq=eng._params[0].layers[0].wq.numpy().copy())
    return out


def callable_inputs():
    """numpy inputs of the four callables: a head-sharded int8 decode (8 KV
    heads, 16 q heads), and ``test_torch_seq_sharded.py``'s 4-shard int8
    case (its draws): a prompt of 7 pages and 20 tokens (page 32), queries,
    16 appends (the last 4 into global page 8) and a prefill chunk."""
    rng = np.random.default_rng(41)
    t = 7 * 32 + 20
    out = dict(k=rng.uniform(-1, 1, (2, t, 32)).astype(np.float32),
               v=rng.uniform(-1, 1, (2, t, 32)).astype(np.float32),
               q=rng.uniform(-1, 1, (2, 4, 32)).astype(np.float32),
               appends=[rng.uniform(-1, 1, (2, 32)).astype(np.float32) for _ in range(16)],
               t=t)
    out["qp"] = rng.uniform(-1, 1, (48, 4, 32)).astype(np.float32)
    out["tp_q"] = np.random.default_rng(3).uniform(-1, 1, (3, 16, 32)).astype(np.float32)
    return out


def cp_cfg():
    from tf_flash_attention_tpu_torch.serving.kv_cache import KVCacheConfig
    return KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=32, n_pages=8, max_seqs=2,
                         max_pages_per_seq=6, quantized=True, quant_dtype=torch.int8,
                         dtype=torch.float32)


def tp_cfg():
    from tf_flash_attention_tpu_torch.serving.kv_cache import KVCacheConfig
    return KVCacheConfig(n_kv_heads=8, head_dim=32, page_size=64, n_pages=16, max_seqs=3,
                         max_pages_per_seq=4, quantized=True, quant_dtype=torch.int8,
                         dtype=torch.float32)


def _cache_state(cache):
    return {f.name: None if getattr(cache, f.name) is None
            else getattr(cache, f.name).numpy().copy() for f in dataclasses.fields(cache)}


def run_callables(inputs, tp_state, devices):
    """The four callables on meshes of ``devices``: ``sharded_paged_decode``
    at tp 4 on ``tp_state`` (a full cache's numpy state), and on a seq axis
    of 4 a decode, 16 appends (the last 4 into global page 8, shard 0's
    local page 2), a decode and a prefill chunk over the last 40 tokens.
    Returns the outputs (whole on every process) and the cache state of
    each shard this process drives after the prompt's write and after the
    appends, by shard index."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache
    from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                     sharded_paged_decode)

    f = lambda x: torch.from_numpy(np.asarray(x).copy())
    out = {}
    heads = make_mesh((4,), ("model",), devices)
    full = PagedKVCache(**{k: None if v is None else f(v) for k, v in tp_state.items()})
    out["sharded_decode"] = sharded_paged_decode(heads, tp_cfg())(
        f(inputs["tp_q"]), shard_cache_heads(full, tp_cfg(), heads)).numpy()

    seq, cfg = make_mesh((4,), ("seq",), devices), cp_cfg()
    caches = tsd.write_prompt_seq_sharded(tsd.create_seq_sharded_cache(cfg, seq, "seq"), cfg,
                                          seq, "seq", 0, [[0, 1, 2]] * 4, f(inputs["k"]),
                                          f(inputs["v"]))
    first = seq.axis("seq").index
    out["written"] = {first + i: _cache_state(c) for i, c in enumerate(caches)}
    if first == 0:
        caches[0].page_tables[0, 2] = 3             # global page 8: shard 0's local page 2
    decode = tsd.seq_sharded_paged_decode(seq, cfg, "seq")
    out["decode"] = decode(f(inputs["q"]), caches).numpy()
    append = tsd.seq_sharded_append(seq, cfg, "seq", trash_page=cfg.n_pages - 1)
    active = torch.tensor([True, False])
    for kn in inputs["appends"]:
        k_new = torch.zeros((2, 2, 32))
        k_new[0] = f(kn)
        append(caches, k_new, -k_new, active)
    out["shards"] = {first + i: _cache_state(c) for i, c in enumerate(caches)}
    out["decode_after"] = decode(f(inputs["q"]), caches).numpy()
    start = inputs["t"] + len(inputs["appends"]) - 40
    out["prefill"] = tsd.seq_sharded_paged_prefill(seq, cfg, "seq")(
        f(inputs["qp"]), caches, 0, start, 40).numpy()
    return out


def mesh_checks(rank):
    """A process-group mesh's ownership and collectives, from one rank."""
    from tf_flash_attention_tpu_torch.parallel import collectives as col
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh, shard, unshard
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.parallel.ring import ring_flash_attention
    from tf_flash_attention_tpu_torch.parallel.sharded import mha

    mesh = make_mesh((2, 2), ("model", "seq"), ["cpu"] * WORLD)
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    block = shard(x, mesh, ("model", None, "seq"))
    back = unshard(block, ("model", None, "seq"), "cpu", mesh)
    auto = make_mesh((WORLD,), ("data",))
    ax = mesh.axis("seq")
    mine = torch.tensor([rank, -rank], dtype=torch.int32)
    half = torch.full((3,), rank + 0.5, dtype=torch.bfloat16)
    # the training callables take the process-group mesh: heads over the
    # model line, each rank's block, the whole output gathered
    q, k, v = (torch.from_numpy(np.random.default_rng(s).uniform(-1, 1, (1, 4, 32, 16))
                                .astype(np.float32)) for s in range(3))
    ring = ring_flash_attention(mesh)(q, k, v)
    return dict(
        coords=mesh.coords(), ranks=mesh.ranks.tolist(), device=str(mesh.device),
        local=[str(d) for d in mesh.local_devices()], block=block.numpy(),
        back_equal=bool(torch.equal(back, x)), auto_devices=[str(d) for d in auto.devices.flat],
        axis=(ax.size, ax.index, ax.group is not None),
        psum=col.psum([mine], ax).tolist(), pmax=col.pmax([mine], ax).tolist(),
        gather=[t.float().tolist() for t in col.all_gather([half], mesh.axis("model"))],
        refusal_cpu=mesh.capture_refusal(),
        refusal_cuda=col.capture_refusal([ax], "cuda:0"),
        ring=ring.numpy(), ring_plain=mha(q, k, v, rule=CausalRule()).numpy())


def run_world(rank, inputs):
    """Every case on the process-group mesh of ``"cpu"`` four times."""
    devices = ["cpu"] * WORLD
    return dict(mesh=mesh_checks(rank),
                engines=serve_engines(inputs["params"], devices),
                callables=run_callables(inputs["callables"], inputs["tp_state"], devices))


# ---- training over the group ----

# the training layouts: (mesh shape, axes, model config, batch shape of the
# tokens); tests/test_torch_sharded_train.py's, test_torch_moe.py's and
# test_torch_pipeline.py's configurations at 4 slots
TRAIN_MODEL = dict(vocab=128, d_model=64, n_layers=1, n_heads=4, n_kv_heads=4, d_head=16,
                   d_ff=128, max_seq=128)
TRAIN = {
    "dense": ((2, 2), ("data", "model"), {}, (4, 65)),
    "cp": ((1, 2, 2), ("data", "model", "context"), dict(context_parallel=True), (4, 129)),
    "moe": ((2, 2), ("data", "model"), dict(n_experts=4), (4, 65)),
    "pipe": ((2, 2), ("data", "pipe"), dict(n_layers=2), (8, 33)),
}
MICROBATCHES = 2
TRAIN_LR = 1e-2
TRAIN_STEPS = 2
# the callables at context 4 (ring and Ulysses) and on (data 2, model 2)
CALLABLES = {
    "ring-causal": ((1, 1, 4), "ring", "causal"), "ring-full": ((1, 1, 4), "ring", "full"),
    "ring-local": ((1, 1, 4), "ring", "local"), "ulysses": ((1, 1, 4), "ulysses", "causal"),
    "sharded": ((2, 2, 1), "sharded", "causal"),
}


def train_cfg(name):
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig
    return ModelConfig(**{**TRAIN_MODEL, **TRAIN[name][2]}, dtype=torch.float32)


def _named(module):
    return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


def train_layouts(params_np, tokens, devices):
    """``TRAIN_STEPS`` AdamW steps (optax.adamw's settings) of every layout
    on a mesh of ``devices`` from ``params_np`` (the JAX parameter pytrees
    by layout; the pipeline's stacked by stage): {name: (losses, the whole
    parameters gathered after the steps, the parameters this process
    holds, the gradients of the last step gathered)}."""
    from tf_flash_attention_tpu_torch.models import pipeline as tpp
    from tf_flash_attention_tpu_torch.models import transformer as ttf
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for name, (shape, axes, _, _) in TRAIN.items():
        cfg, mesh = train_cfg(name), make_mesh(shape, axes, devices)
        tok = torch.from_numpy(tokens[name]).long()
        if name == "pipe":
            slot = tpp.slot_stages(tpp.stages_from_jax(cfg, params_np[name], "cpu"), mesh)
            opt = torch.optim.AdamW(slot.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=1e-4)
            step, _ = tpp.make_pipeline_train_step(cfg, mesh, opt, MICROBATCHES)
            gather = lambda grads=False: tpp.gather_stages(slot, mesh, grads=grads)
        else:
            slot = ttf.slot_params(cfg, ttf.params_from_jax(cfg, params_np[name], "cpu"), mesh)
            opt = torch.optim.AdamW(slot.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=1e-4)
            step = ttf.make_sharded_train_step(cfg, mesh, opt)
            gather = lambda grads=False: ttf.gather_params(cfg, slot, mesh, grads=grads)
        losses = [float(step(slot, tok)) for _ in range(TRAIN_STEPS)]
        out[name] = dict(losses=losses, params=_named(gather()), held=_named(slot),
                         grads=_named(gather(grads=True)))
    return out


def callable_qkv(name):
    """A callable's numpy q, k, v and output cotangent."""
    rng = np.random.default_rng(7)
    shape = (2, 4, 64, 16) if name == "sharded" else (1, 4, 128, 16)
    return tuple(rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(4))


def train_callables(devices, names=None):
    """Every one of CALLABLES (or of ``names``) on a mesh of ``devices``:
    {name: (output, dq, dk, dv)}, whole on every process."""
    from tf_flash_attention_tpu_torch import mask_rules as rules
    from tf_flash_attention_tpu_torch.parallel import (make_mesh, ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)

    pick = {"causal": rules.CausalRule(), "full": rules.FullRule(),
            "local": rules.LocalRule(100, is_causal=True)}
    out = {}
    for name in names or CALLABLES:
        shape, kind, rule = CALLABLES[name]
        mesh = make_mesh(shape, ("data", "model", "context"), devices)
        fn = {"ring": lambda: ring_flash_attention(mesh, rule=pick[rule]),
              "ulysses": lambda: ulysses_flash_attention(mesh, pick[rule]),
              "sharded": lambda: sharded_flash_attention(mesh, pick[rule])}[kind]()
        *qkv, do = (torch.from_numpy(x) for x in callable_qkv(name))
        qkv = [x.requires_grad_(True) for x in qkv]
        o = fn(*qkv)
        grads = torch.autograd.grad(o, qkv, do)
        out[name] = [o.detach().numpy()] + [g.numpy() for g in grads]
    return out


def collective_checks(rank):
    """The new collectives and their backwards over the group, from one
    rank, on a (2, 2) mesh ("a", "b")."""
    from tf_flash_attention_tpu_torch.parallel import collectives as col
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2, 2), ("a", "b"), ["cpu"] * WORLD)
    a, b = mesh.axis("a"), mesh.axis("b")
    x = torch.arange(4.0).reshape(2, 2) + 10 * rank
    out = {}

    def grad_of(fn, x, cot):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        g, = torch.autograd.grad(y, x, cot(y))
        return y.detach().numpy(), g.numpy()

    ones = lambda y: torch.ones_like(y)
    weighted = lambda y: torch.full_like(y, float(rank + 1))
    out["psum"] = grad_of(lambda t: col.psum([t], a), x, weighted)
    out["pvary"] = grad_of(lambda t: col.pvary(t, a), x, weighted)
    out["all_gather"] = grad_of(lambda t: torch.stack(col.all_gather([t], b)), x, weighted)
    out["all_gather_invariant"] = grad_of(
        lambda t: torch.stack(col.all_gather_invariant(t, b)), x, weighted)
    out["piece"] = grad_of(lambda t: col.piece(t, b, 0), x, weighted)
    out["psum_scatter"] = grad_of(lambda t: col.psum_scatter(t, b, 0), x, weighted)
    out["ppermute"] = grad_of(lambda t: col.ppermute([t], b, [(0, 1)])[0], x, weighted)
    out["all_to_all"] = grad_of(lambda t: col.all_to_all([t], a, 0, 1)[0], x, weighted)
    half = torch.full((3,), rank + 0.5, dtype=torch.bfloat16)
    out["ppermute_bf16"] = col.ppermute([half], b, [(0, 1), (1, 0)])[0].float().numpy()
    p = torch.nn.Parameter(torch.zeros(2))
    q = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((2,), float(rank))
    col.psum_gradients([p, q], [a, b])
    out["psum_gradients"] = (p.grad.numpy(), q.grad.numpy())
    out["calls"] = dict(col.CALLS)
    return out


def train_world(rank, inputs):
    """The training cases on the process-group mesh of ``"cpu"`` four
    times."""
    devices = ["cpu"] * WORLD
    return dict(collectives=collective_checks(rank),
                layouts=train_layouts(inputs["params"], inputs["tokens"], devices),
                callables=train_callables(devices))
