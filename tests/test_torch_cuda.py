"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests need a card and skip
elsewhere.  Run them on the GPU with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import fuzz_case
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.block_sizes import BlockConfig
from tf_flash_attention_tpu_torch.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.ops import backward, forward
from tf_flash_attention_tpu_torch.serving import decode, engine, kv_cache, prefill
from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

pytestmark = pytest.mark.cuda

TOL_F32 = 1e-5   # float32 throughout: summation order only


def tol_low(ref):
    """bf16 outputs or bf16-rounded p: kernel and plain version round at the
    same points and sum in other orders, so an element parts by a rounding
    flip, one bf16 ulp of its own magnitude (at most 2**-7 of the largest):
    2 ulps at the output's scale, with no floor."""
    return 2 * 2.0 ** -8 * float(ref.float().abs().max())


def _serving_close(got, want, f32):
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL_F32 if f32 else tol_low(want))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# quantized caches by name (True is int8)
QDTYPES = {True: torch.int8, "int8": torch.int8, "e4m3": torch.float8_e4m3fn,
           "e5m2": torch.float8_e5m2, "int4": "int4"}


def _cache(quantized, dtype, dev, lengths, n_kv=2, head_dim=32, seed=0):
    """A cache of random contents; ``quantized`` is False, True (int8) or a
    payload name of ``QDTYPES``."""
    qd = QDTYPES.get(quantized)
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=head_dim, page_size=64,
                                 n_pages=4 * len(lengths) + 2, max_seqs=len(lengths), max_pages_per_seq=4,
                                 quantized=qd is not None,
                                 quant_dtype=torch.int8 if qd is None else qd, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for p in (c.k_pages, c.v_pages):
        if cfg.is_int4:
            p.copy_(torch.randint(-128, 128, p.shape, generator=gen, device=dev))
        elif qd == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
        elif qd is not None:
            qmax = kv_cache._quant_max(qd)
            p.copy_((torch.randn(p.shape, generator=gen, device=dev) * qmax / 8).clamp(-qmax, qmax))
        else:
            x = torch.rand(p.shape, generator=gen, device=dev) * 2 - 1
            x[..., head_dim:] = 0
            p.copy_(x)
    if qd is not None:
        unit = 127.0 / kv_cache._quant_max(qd)
        for s in (c.k_scales, c.v_scales):
            s.copy_((0.005 + 0.015 * torch.rand(s.shape, generator=gen, device=dev)) * unit)
    perm = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)
    c.page_tables.copy_(perm[:len(lengths) * 4].reshape(len(lengths), 4))
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cfg, c


def _clone(c):
    return dataclasses.replace(c, **{f.name: getattr(c, f.name).clone()
                                     for f in dataclasses.fields(c)
                                     if getattr(c, f.name) is not None})


def _same(a, b, trash):
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None:
            if x.element_size() == 1:      # fp8 and int4 bit for bit
                x, y = x.view(torch.uint8), y.view(torch.uint8)
            assert torch.equal(x[:, :trash], y[:, :trash]), name
    assert torch.equal(a.lengths, b.lengths)


CASES = [(True, torch.float32, torch.float32), (True, torch.bfloat16, torch.bfloat16),
         (False, torch.float32, torch.float32), (False, torch.bfloat16, torch.bfloat16),
         ("e4m3", torch.bfloat16, torch.bfloat16), ("e5m2", torch.float32, torch.float32),
         ("int4", torch.bfloat16, torch.bfloat16), ("int4", torch.float32, torch.float32)]
CASE_IDS = ["int8-f32", "int8-bf16", "f32", "bf16", "e4m3-bf16", "e5m2-f32", "int4-bf16",
            "int4-f32"]


@pytest.mark.parametrize("quantized,act,kvdt", CASES, ids=CASE_IDS)
def test_kv_writes_bit_identical(dev, quantized, act, kvdt):
    cfg, c = _cache(quantized, kvdt, dev, [70, 0, 130])
    trash = cfg.n_pages - 1
    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn((2, 96, 32), generator=gen, device=dev).to(act)
    v = torch.randn((2, 96, 32), generator=gen, device=dev).to(act)
    a, b = _clone(c), _clone(c)
    kv_cache.write_tokens_at(a, cfg, 2, 40, k, v, 80, trash)
    kv_cache._write_tokens_plain(b, cfg, 2, 40, k, v, 80, trash)
    b.lengths[2] = 120
    _same(a, b, trash)
    kn = torch.randn((3, 2, 32), generator=gen, device=dev).to(act)
    vn = torch.randn((3, 2, 32), generator=gen, device=dev).to(act)
    active = torch.tensor([True, False, True], device=dev)
    kv_cache.append_tokens_batched(a, cfg, kn, vn, active, trash)
    kv_cache._append_plain(b, cfg, kn, vn, active, trash)
    b.lengths += active.to(torch.int32)
    _same(a, b, trash)


@pytest.mark.parametrize("quantized,act,kvdt", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("n_q", [2, 8])
def test_decode_and_prefill_match_plain(dev, quantized, act, kvdt, n_q):
    cfg, c = _cache(quantized, kvdt, dev, [150, 0, 64, 255])
    gen = torch.Generator(device=dev).manual_seed(2)
    f32 = act == kvdt == torch.float32 and not quantized
    q = torch.randn((4, n_q, 32), generator=gen, device=dev).to(act)
    o = decode.paged_decode_attention(q, c, cfg)
    ref = decode._paged_decode_plain(q, c, cfg, 32 ** -0.5, CausalRule())
    _serving_close(o, ref, f32)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    qp = torch.randn((40, n_q, 32), generator=gen, device=dev).to(act)
    o = prefill.paged_prefill_attention(qp, c, cfg, 0, 110, 33)
    qs = (qp.float() * torch.tensor(32 ** -0.5 * 1.4426950408889634)).to(act)
    ref = prefill._paged_prefill_plain(qs, c, cfg, 0, 110, 33, CausalRule())
    _serving_close(o[:33], ref[:33], f32)


@pytest.mark.parametrize("quantized,act,kvdt", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("n_q,gamma", [(2, 1), (2, 3), (4, 4), (8, 2)])
def test_multitoken_decode_matches_plain(dev, quantized, act, kvdt, n_q, gamma):
    cfg, c = _cache(quantized, kvdt, dev, [150, 0, 64, 255])
    gen = torch.Generator(device=dev).manual_seed(4)
    f32 = act == kvdt == torch.float32 and not quantized
    q = torch.randn((4, gamma, n_q, 32), generator=gen, device=dev).to(act)
    native.reset_launch_counts()
    o = decode.paged_multitoken_decode(q, c, cfg)
    assert native.LAUNCHES["paged_multitoken_decode"] == 1
    ref = decode._paged_multitoken_decode_plain(q, c, cfg, 32 ** -0.5, CausalRule())
    _serving_close(o, ref, f32)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    if gamma == 1:
        torch.testing.assert_close(o[:, 0], decode.paged_decode_attention(q[:, 0], c, cfg),
                                   rtol=0, atol=0)


def test_int4_odd_lengths_bit_identical(dev):
    """An odd true_len leaves a half-padding byte row; the appends after it
    read-modify-write both nibbles in turn."""
    cfg, c = _cache("int4", torch.bfloat16, dev, [70, 0, 130])
    trash = cfg.n_pages - 1
    gen = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((2, 64, 32), generator=gen, device=dev).to(torch.bfloat16)
    a, b = _clone(c), _clone(c)
    kv_cache.write_tokens_at(a, cfg, 0, 0, k, -k, 37, trash)
    kv_cache._write_tokens_plain(b, cfg, 0, 0, k, -k, 37, trash)
    b.lengths[0] = 37
    _same(a, b, trash)
    active = torch.tensor([True, False, True], device=dev)
    for _ in range(3):
        kn = torch.randn((3, 2, 32), generator=gen, device=dev).to(torch.bfloat16)
        kv_cache.append_tokens_batched(a, cfg, kn, -kn, active, trash)
        kv_cache._append_plain(b, cfg, kn, -kn, active, trash)
        b.lengths += active.to(torch.int32)
        _same(a, b, trash)


@pytest.mark.parametrize("payload", ["e4m3", "int4"])
def test_large_pages_match_plain(dev, payload):
    """The serving shapes: d 128 and pages of 256 (int4 512) tokens, staged
    whole; GQA 8/2 with gamma 4 fills the 16 query rows of a block (int4 at
    page 512: the largest shared memory)."""
    cfg = kv_cache.KVCacheConfig(n_kv_heads=2, head_dim=128, n_pages=20, max_seqs=2,
                                 page_size=512 if payload == "int4" else 256,
                                 max_pages_per_seq=8, quant_dtype=QDTYPES[payload])
    gen = torch.Generator(device=dev).manual_seed(6)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    k = torch.randn((2, 1200, 128), generator=gen, device=dev).to(torch.bfloat16)
    kv_cache.write_prompt(c, cfg, 0, list(range(8)), k, k.flip(1))
    q = torch.randn((2, 4, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    o = decode.paged_multitoken_decode(q, c, cfg)
    ref = decode._paged_multitoken_decode_plain(q, c, cfg, 128 ** -0.5, CausalRule())
    _serving_close(o, ref, False)


def _wide_cache(dev, quantized, n_kv, head_dim, page_size, lengths, seed):
    """A cache holding ``lengths`` tokens of random K/V, written by the
    kernels (every slot's pages mapped)."""
    pages = -(-max(lengths) // page_size)
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=head_dim, page_size=page_size,
                                 n_pages=len(lengths) * pages + 2, max_seqs=len(lengths),
                                 max_pages_per_seq=pages, quantized=quantized is not None,
                                 quant_dtype=QDTYPES.get(quantized, torch.int8),
                                 dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for slot, n in enumerate(lengths):
        if n:
            k = torch.randn((n_kv, n, head_dim), generator=gen, device=dev).to(torch.bfloat16)
            kv_cache.write_prompt(c, cfg, slot, list(range(slot * pages, (slot + 1) * pages)),
                                  k, -k.flip(1))
    return cfg, c, gen


@pytest.mark.parametrize("n_q,n_kv,gamma,quantized", [(16, 2, 4, "int8"), (32, 1, 1, None),
                                                      (32, 1, 1, "int4"), (16, 2, 4, None)])
def test_decode_many_rows_wide_heads_match_plain(dev, n_q, n_kv, gamma, quantized):
    """More than 16 query rows a kv head (GQA 8 at gamma 4, MQA 32/1) at
    head_dim_store 384: the decode kernels take them in row groups."""
    cfg, c, gen = _wide_cache(dev, quantized, n_kv, 384, 64, [300, 0, 129], seed=n_q + gamma)
    assert cfg.head_dim_store == 384
    q = torch.randn((3, gamma, n_q, 384), generator=gen, device=dev).to(torch.bfloat16)
    native.reset_launch_counts()
    o = decode.paged_multitoken_decode(q, c, cfg)
    ref = decode._paged_multitoken_decode_plain(q, c, cfg, 384 ** -0.5, CausalRule())
    _serving_close(o, ref, False)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert native.LAUNCHES["paged_multitoken_decode"] == 1
    if gamma == 1:
        o = decode.paged_decode_attention(q[:, 0], c, cfg)
        _serving_close(o, decode._paged_decode_plain(q[:, 0], c, cfg, 384 ** -0.5, CausalRule()),
                       False)


@pytest.mark.parametrize("quantized", [None, "int8", "int4"])
@pytest.mark.parametrize("page_size", [8, 16, 64])
def test_prefill_small_pages_match_plain(dev, page_size, quantized):
    """Pages below the prefill kernel's 32-key sub-tile (8, 16) and a
    multiple of it (64), with a cached prefix."""
    cfg, c, gen = _wide_cache(dev, quantized, 2, 128, page_size, [0, 150], seed=page_size)
    qp = torch.randn((48, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
    native.reset_launch_counts()
    o = prefill.paged_prefill_attention(qp, c, cfg, 1, 110, 40)
    assert native.LAUNCHES["paged_prefill"] == 1
    qs = (qp.float() * torch.tensor(128 ** -0.5 * 1.4426950408889634)).to(torch.bfloat16)
    ref = prefill._paged_prefill_plain(qs, c, cfg, 1, 110, 40, CausalRule())
    _serving_close(o[:40], ref[:40], False)


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2)])
def test_local_rule_kernels_match_plain(dev, w, s):
    cfg, c = _cache(False, torch.float32, dev, [200, 90, 0])
    rule = LocalRule(window_size=w, log2_stride_size=s, is_causal=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((3, 4, 32), generator=gen, device=dev)
    o = decode.paged_decode_attention(q, c, cfg, rule=rule)
    ref = decode._paged_decode_plain(q, c, cfg, 32 ** -0.5, rule)
    torch.testing.assert_close(o, ref, rtol=0, atol=TOL_F32)
    qp = torch.randn((48, 4, 32), generator=gen, device=dev)
    o = prefill.paged_prefill_attention(qp, c, cfg, 0, 150, 40, rule=rule)
    qs = qp * torch.tensor(32 ** -0.5 * 1.4426950408889634)
    ref = prefill._paged_prefill_plain(qs, c, cfg, 0, 150, 40, rule)
    torch.testing.assert_close(o[:40], ref[:40], rtol=0, atol=TOL_F32)
    qm = torch.randn((3, 4, 4, 32), generator=gen, device=dev)
    o = decode.paged_multitoken_decode(qm, c, cfg, rule=rule)
    ref = decode._paged_multitoken_decode_plain(qm, c, cfg, 32 ** -0.5, rule)
    torch.testing.assert_close(o, ref, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("quantized", [False, True, "e4m3", "int4"])
def test_engine_on_gpu_matches_cpu(dev, quantized):
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.float32)
    kv = dict(quantized_kv=bool(quantized))
    if quantized:
        kv["kv_quant_dtype"] = QDTYPES[quantized]
    ecfg = engine.EngineConfig(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4,
                               prefill_chunk=64, **kv)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 64, n)] for n in (100, 5, 70)]
    outs = []
    for where in ("cpu", dev):
        e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"), ecfg, device=where)
        rids = [e.submit(p, max_new_tokens=8) for p in prompts]
        native.reset_launch_counts()
        res = e.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    assert min(native.LAUNCHES[k] for k in native.SERVING_KERNELS
               if k != "paged_multitoken_decode") > 0


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_page_16_on_gpu_matches_cpu(dev, quantized):
    """The engine at page 16 (the CPU engine tests' page size) gives the CPU
    engine's tokens, with and without speculation."""
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.float32)
    prompts = [[5, 9] * 4 + [5], [1, 2, 3, 4, 5], list(range(1, 62))]
    for spec in (0, 3):
        ecfg = engine.EngineConfig(max_seqs=3, page_size=16, n_pages=40, max_pages_per_seq=8,
                                   prefill_chunk=32, speculative_tokens=spec,
                                   quantized_kv=bool(quantized))
        outs = []
        for where in ("cpu", dev):
            e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                                         "cpu"), ecfg, device=where)
            rids = [e.submit(p, max_new_tokens=10) for p in prompts]
            native.reset_launch_counts()
            res = e.run()
            outs.append(([res[r] for r in rids], e.stats, e.allocator.free_pages))
        assert outs[0] == outs[1]
        assert native.LAUNCHES["paged_prefill"] > 0


@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_engine_speculative_on_gpu_matches_cpu(dev, quantized):
    """Speculative greedy on the card gives the CPU engine's tokens, spec
    stats and page counts; the verify step runs paged_multitoken_decode."""
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.float32)
    kv = dict(quantized_kv=bool(quantized))
    if quantized:
        kv["kv_quant_dtype"] = QDTYPES[quantized]
    ecfg = engine.EngineConfig(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4,
                               prefill_chunk=8, speculative_tokens=3, **kv)
    prompts = [[5, 9] * 4 + [5], [1, 2, 3, 4, 5], list(range(1, 62))]
    outs = []
    for where in ("cpu", dev):
        e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"), ecfg, device=where)
        rids = [e.submit(p, max_new_tokens=10) for p in prompts]
        native.reset_launch_counts()
        res = e.run()
        outs.append(([res[r] for r in rids], e.stats, e.spec_stats, e.allocator.free_pages))
    assert outs[0] == outs[1]
    assert native.LAUNCHES["paged_multitoken_decode"] > 0 and native.LAUNCHES["kv_append"] > 0


# ---- the sequence-sharded variants: (l, m) outputs, page stride and offset,
# global lengths, on each shard of a 4-shard layout ----

def _owned(total, r, ps=64):
    return kv_cache._owned_token_count(total, ps, 4, r)


def _close_lm(got, want):
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rule", [CausalRule(), LocalRule(100, 0, True), LocalRule(8, 2, True)],
                         ids=["causal", "local_100", "local_8_stride_4"])
@pytest.mark.parametrize("quantized,act,kvdt", CASES, ids=CASE_IDS)
def test_seq_sharded_variants_match_plain(dev, quantized, act, kvdt, rule):
    glob = [700, 130, 0, 255]      # slot 1 has no page on shard 3; slot 2 is empty
    f32 = act == kvdt == torch.float32 and not quantized
    s = 32 ** -0.5
    for r in range(4):
        cfg, c = _cache(quantized, kvdt, dev, [_owned(n, r) for n in glob], seed=r)
        gen = torch.Generator(device=dev).manual_seed(10 + r)
        shard = dict(page_stride=4, page_offset=r)
        g = torch.tensor(glob, dtype=torch.int32, device=dev)
        native.reset_launch_counts()
        q = torch.randn((4, 4, 32), generator=gen, device=dev).to(act)
        got = decode.paged_decode_attention(q, c, cfg, rule=rule, returning_l_m=True,
                                            global_lengths=g, **shard)
        want = decode._paged_decode_plain(q, c, cfg, s, rule, True, global_lengths=g, **shard)
        _serving_close(got[0], want[0], f32)
        _close_lm(got, want)
        assert torch.equal(got[0][2], torch.zeros_like(got[0][2])) and float(got[1][2].abs().max()) == 0
        if r == 3:
            assert float(got[0][1].abs().max()) == 0 and float(got[1][1].abs().max()) == 0
        qm = torch.randn((4, 3, 4, 32), generator=gen, device=dev).to(act)
        got = decode.paged_multitoken_decode(qm, c, cfg, rule=rule, returning_l_m=True,
                                             global_lengths=g, **shard)
        want = decode._paged_multitoken_decode_plain(qm, c, cfg, s, rule, True,
                                                     global_lengths=g, **shard)
        _serving_close(got[0], want[0], f32)
        _close_lm(got, want)
        qp = torch.randn((48, 4, 32), generator=gen, device=dev).to(act)
        got = prefill.paged_prefill_attention(qp, c, cfg, 0, 600, 40, rule=rule,
                                              returning_l_m=True, **shard)
        qs = (qp.float() * torch.tensor(s * 1.4426950408889634)).to(act)
        want = prefill._paged_prefill_plain(qs, c, cfg, 0, 600, 40, rule, True, **shard)
        _serving_close(got[0][:40], want[0][:40], f32)
        _close_lm([x[:40] for x in got], [x[:40] for x in want])
        trash = cfg.n_pages - 1
        k = torch.randn((2, 96, 32), generator=gen, device=dev).to(act)
        a, b = _clone(c), _clone(c)
        kv_cache.write_tokens_at(a, cfg, 3, 40, k, -k, 81, trash, **shard)
        kv_cache._write_tokens_plain(b, cfg, 3, 40, k, -k, 81, trash, **shard)
        b.lengths[3] = _owned(121, r)
        _same(a, b, trash)
        torch.cuda.synchronize()
        assert all(native.LAUNCHES[v] == 1 for v in native.CP_VARIANTS), native.LAUNCHES
        assert not any(native.LAUNCHES[k] for k in native.SERVING_KERNELS)


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_engine_context_parallel_on_gpu_matches_cpu(dev, quantized, spec):
    """cp = 4 on cuda:0 (the shards share the card) gives the tokens, stats
    and free pages of cp = 4 on the CPU, and launches every CP variant."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.float32)
    kv = dict(quantized_kv=bool(quantized))
    if quantized:
        kv["kv_quant_dtype"] = QDTYPES[quantized]
    ecfg = engine.EngineConfig(max_seqs=3, page_size=64, n_pages=8, max_pages_per_seq=4,
                               prefill_chunk=64, speculative_tokens=spec, **kv)
    prompts = [[5, 9] * 4 + [5], list(range(1, 62)), [int(t) % 64 for t in range(300)]]
    outs = []
    for where in ("cpu", dev):
        e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"), ecfg,
                                mesh=make_mesh((4,), ("seq",), [where] * 4))
        rids = [e.submit(p, max_new_tokens=20) for p in prompts]
        native.reset_launch_counts()
        res = e.run()
        outs.append(([res[r] for r in rids], e.stats, e.spec_stats,
                     [a.free_pages for a in e.allocators]))
    assert outs[0] == outs[1]
    want = {"paged_multitoken_decode[cp]" if spec else "paged_decode[cp]", "paged_prefill[cp]",
            "kv_chunk_write[cp]", "kv_append"}
    assert {k for k, n in native.LAUNCHES.items() if n} == want, native.LAUNCHES


def test_engine_sampling_on_gpu(dev):
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.bfloat16)
    e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                            engine.EngineConfig(max_seqs=2, page_size=64, n_pages=8,
                                                max_pages_per_seq=4, prefill_chunk=64,
                                                seed=5), device=dev)
    g = e.submit([1, 2, 3], max_new_tokens=6)
    s = e.submit([1, 2, 3], max_new_tokens=6,
                 sampling=SamplingParams(temperature=1.0, top_k=8, top_p=0.9))
    out = e.run()
    assert len(out[g]) == len(out[s]) == 9
    assert all(0 <= t < 64 for t in out[s])


# ---- the op path's kernels: flash_fwd, flash_bwd_fused, flash_bwd_dq,
# flash_bwd_dkv (the table kernels), banded_fwd, banded_bwd, window_fwd and
# window_bwd, each against its plain version on the same card ----

BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
# the JAX package's route switches: all off sends every schedule to the
# table kernels; FA_RESIDENT=1 sends banded forwards to the resident kernel
ROUTES = {"auto": {}, "resident": {"FA_RESIDENT": "1"},
          "table": {v: "0" for v in ("FA_BANDED", "FA_WINDOW", "FA_BANDED_BWD",
                                     "FA_WINDOW_BWD")}}


def _op_tol(dtype, ref):
    """float32: summation order only; half: two ulps of the output type at
    the tensor's scale (both sides compute in float32 and round once)."""
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    return 2 * ulp * max(1.0, float(ref.float().abs().max()))


def _close(name, got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got.float()).all(), name
    assert err <= _op_tol(dtype, want), (name, err, _op_tol(dtype, want))


def _run_op_case(dev, rule, sync, q_seq, k_seq, d, v_d, b_kv, g, dtype, seed=0):
    """Forward and the three backward families (kv-outer fused, split,
    q-outer fused) on the routes the environment selects, kernel against
    plain version."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))

    def t(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)

    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    do = t(b_kv * g, q_len, v_d)
    scale = d ** -0.5
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    o2, l2, m2 = forward._flash_forward_plain(forward.prescale(q, scale), k, v, pack, rule)
    torch.cuda.synchronize()
    _close("o", o, o2, dtype)
    _close("l", l, l2, torch.float32)
    _close("m", m, m2, torch.float32)
    lse2, delta = backward.backward_stats(o, l, m, do)
    for fused in ("kv", False, "q"):
        got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule,
                                      config=BLOCKS, fused=fused)
        want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, scale,
                                              bool(fused))
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(f"{name} fused={fused}", a, b, dtype)
    return o, l, m


OP_CASES = {
    # ragged lengths (not multiples of 128), v_d != d, sync scaling
    "causal_1d_ragged": (CausalRule(), "scale_front", (300,), (520,), 32, 24, 2, 1),
    "causal_1d_gqa": (CausalRule(), "none_front", (384,), (384,), 32, 32, 2, 2),
    "full_1d": (FullRule(), "none_front", (200,), (130,), 16, 40, 1, 1),
    "local_stride_1d": (LocalRule(5, 1, True), "scale_front", (220,), (310,), 24, 12, 2, 1),
    "local_2d": (LocalRule(7, 0, False), "scale_end", (10, 22), (20, 11), 24, 12, 2, 1),
    "wide_heads": (CausalRule(), "none_front", (260,), (260,), 200, 256, 1, 2),
    "wide_heads_local": (LocalRule(5, 0, False), "none_front", (260,), (300,), 256, 200, 1, 2),
    # the third tile class (and the tensor-core forward's 32-key stages)
    "wide_384": (CausalRule(), "none_front", (260,), (300,), 384, 384, 1, 2),
    "wide_384_local": (LocalRule(5, 0, False), "none_front", (260,), (300,), 384, 384, 1, 2),
    # output columns past 512 over grid z
    "wide_v_576": (CausalRule(), "scale_front", (200,), (330,), 64, 576, 1, 1),
    # d past the tensor-core classes: bf16 / fp16 forwards on the scalar body
    "wide_q_576": (CausalRule(), "none_front", (200,), (330,), 576, 64, 1, 1),
}


@pytest.mark.parametrize("routes", list(ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", list(OP_CASES))
def test_attention_kernels_match_plain(dev, monkeypatch, case, dtype, routes):
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    _run_op_case(dev, *OP_CASES[case], dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("run", range(12))
def test_attention_kernels_fuzz(dev, run, dtype):
    """The random cases of test_torch_attention.py's fuzz test (rules,
    sync modes, 1d/2d lengths, channel dims, GQA), kernels against plain."""
    kind, kw, sync, q_seq, k_seq, d, v_d, g = fuzz_case(run)
    rule = {"full": FullRule, "causal": CausalRule, "local": LocalRule}[kind](**kw)
    _run_op_case(dev, rule, sync, q_seq, k_seq, d, v_d, 2, g, dtype, seed=run)


def test_attention_dead_rows(dev):
    """scale_end causal with q longer than k: query 0 precedes every key and
    gets O = 0, l = 0, m = NEG_INF, and zero gradients."""
    from tf_flash_attention_tpu_torch.ops.kernel_common import NEG_INF_F32
    o, l, m = _run_op_case(dev, CausalRule(), "scale_end", (33,), (4,), 8, 6, 1, 1,
                           torch.float32)
    assert float(o[0, 0].abs().max()) == 0.0 and float(l[0, 0]) == 0.0
    assert float(m[0, 0]) == NEG_INF_F32


@pytest.mark.parametrize("routes", list(ROUTES))
def test_attention_kernels_slice_shape(dev, monkeypatch, routes):
    """The training slice: (B·H, S, d) = (64, 2048, 128), bf16, causal, and
    a GQA group of 4 at the same width; each route launches its forward once
    (bf16: flash_fwd and banded_fwd on the tensor-core body)."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    native.reset_launch_counts()
    _run_op_case(dev, CausalRule(), "none_front", (2048,), (2048,), 128, 128, 64, 1,
                 torch.bfloat16)
    fwd = {"auto": "banded_fwd", "table": "flash_fwd", "resident": "resident_fwd"}[routes]
    assert native.LAUNCHES[fwd] == 1
    _run_op_case(dev, CausalRule(), "none_front", (2048,), (2048,), 128, 128, 16, 4,
                 torch.bfloat16)


@pytest.mark.parametrize("routes,rule,kernels", [
    ("auto", CausalRule(), {"banded_fwd", "banded_bwd"}),
    ("auto", LocalRule(5, 1, True), {"window_fwd", "window_bwd"}),
    ("resident", CausalRule(), {"resident_fwd", "banded_bwd"}),
    ("table", CausalRule(), {"flash_fwd", "flash_bwd_fused"})])
def test_attention_launch_counts(dev, monkeypatch, routes, rule, kernels):
    """Every attention kernel launches on its route, and only there (the
    split pair and the q-outer kernel on their ``fused`` arguments)."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    native.reset_launch_counts()
    _run_op_case(dev, rule, "scale_front", (300,), (410,), 32, 32, 1, 1, torch.float32)
    assert {k for k in native.ATTENTION_KERNELS if native.LAUNCHES[k]} == kernels | {
        "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_qouter"}


# ---- the tensor-core forward (attention_fwd_tc.cuh) ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_tc_tile_matches_matmul(dev, dtype):
    """One 64 x 64 tile through the building blocks: the S product (both
    operands K-major in swizzled shared memory) against a k^T, and the PV
    product (P from the accumulator fragments, V through the transpose bit)
    against T(s) v, both in float32."""
    gen = torch.Generator(device=dev).manual_seed(1)
    a, k = (torch.rand((64, 64), generator=gen, device=dev) * 4 - 2).to(dtype), \
        (torch.rand((64, 64), generator=gen, device=dev) * 4 - 2).to(dtype)
    v = (torch.rand((64, 128), generator=gen, device=dev) * 4 - 2).to(dtype)
    s, o = native.tc_tile_check(a, k, v)
    s_ref = torch.matmul(a.float(), k.float().T)
    o_ref = torch.matmul(s_ref.to(dtype).float(), v.float())
    # float32 sums of exact products: the order only
    torch.testing.assert_close(s, s_ref, rtol=0, atol=1e-4 * float(s_ref.abs().max()))
    torch.testing.assert_close(o, o_ref, rtol=0, atol=1e-5 * float(o_ref.abs().max()))


# (rule, sync, q_seq, k_seq, d, v_d, b_kv, g): the tensor-core forward's
# classes, widths below the MMA step and odd (the staging without TMA), d !=
# v_d, GQA, ragged tails with q_len != k_len, dead rows, a strided 2-d rule
TC_CASES = {
    "d24": (CausalRule(), "none_front", (300,), (300,), 24, 24, 2, 1),
    "d64": (CausalRule(), "none_front", (384,), (384,), 64, 64, 2, 1),
    "d128": (CausalRule(), "none_front", (520,), (520,), 128, 128, 1, 1),
    "d256": (CausalRule(), "none_front", (260,), (260,), 256, 256, 1, 2),
    "d384": (CausalRule(), "none_front", (260,), (300,), 384, 384, 1, 2),
    "d_ne_vd": (CausalRule(), "scale_front", (300,), (520,), 96, 40, 2, 1),
    "odd_widths": (FullRule(), "none_front", (200,), (130,), 27, 13, 1, 1),
    "gqa_8_2": (CausalRule(), "none_front", (384,), (384,), 128, 128, 2, 4),
    "ragged": (FullRule(), "none_front", (333,), (199,), 64, 64, 1, 1),
    "dead_rows": (CausalRule(), "scale_end", (300,), (40,), 32, 32, 1, 1),
    "local_2d_strided": (LocalRule(3, 1, True), "scale_front", (16, 24), (24, 16), 64, 64, 1, 1),
}


@pytest.mark.parametrize("routes", ["auto", "table"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_forward_matches_plain(dev, monkeypatch, case, dtype, routes):
    """The tensor-core body of flash_fwd and banded_fwd against the plain
    forward, which rounds p to the input type before PV as the kernel does:
    2 ulps of the output type at the output's scale, l and m 2e-5 at theirs."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = TC_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + v_d)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    native.reset_launch_counts()
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    torch.cuda.synchronize()
    launched = {kn for kn in native.ATTENTION_KERNELS if native.LAUNCHES[kn]}
    assert launched <= {"flash_fwd", "banded_fwd", "window_fwd"}, launched
    if routes == "table":
        assert launched == {"flash_fwd"}
    o2, l2, m2 = forward._flash_forward_plain(forward.prescale(q, d ** -0.5), k, v, pack, rule)
    _close("o", o, o2, dtype)
    _close("l", l, l2, torch.float32)
    _close("m", m, m2, torch.float32)
    if case == "dead_rows":
        assert float(o[:, 0].float().abs().max()) == 0.0 and float(l[:, 0].abs().max()) == 0.0


# (rule, sync, q_seq, k_seq, d, v_d, b_kv, g): the resident forward's
# persistent walk at fewer items than SMs (2 rows of 3 ragged tiles), many
# more (200 rows of 8), an item count no multiple of the grid (37 x 4 =
# 148), GQA 4, dead rows (scale_end, q longer than k), every tensor-core
# class and the scalar body past d 512
RESIDENT_CASES = {
    "few_items_ragged": (CausalRule(), "none_front", (300,), (300,), 128, 128, 2, 1),
    "many_items": (CausalRule(), "none_front", (1024,), (1024,), 64, 64, 200, 1),
    "items_past_grid": (CausalRule(), "none_front", (512,), (512,), 128, 128, 37, 1),
    "gqa_4": (CausalRule(), "none_front", (640,), (640,), 128, 128, 3, 4),
    "dead_rows": (CausalRule(), "scale_end", (300,), (40,), 128, 128, 2, 1),
    "d256": (CausalRule(), "none_front", (384,), (384,), 256, 256, 2, 1),
    "d384": (CausalRule(), "none_front", (260,), (300,), 384, 384, 1, 2),
    "d512": (CausalRule(), "none_front", (384,), (384,), 512, 64, 2, 1),
    "d576_scalar": (CausalRule(), "none_front", (200,), (330,), 576, 64, 1, 1),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_resident_tc_walk(dev, monkeypatch, case, dtype):
    """The resident forward (FA_RESIDENT=1, the window route off) launches
    once on the body native.fwd_body names and matches the plain forward:
    o within 2 ulps of the output type, l and m within 2e-5 at their scale."""
    monkeypatch.setenv("FA_RESIDENT", "1")
    monkeypatch.setenv("FA_WINDOW", "0")
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = RESIDENT_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + 7 * b_kv)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    native.reset_launch_counts()
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    torch.cuda.synchronize()
    assert {kn: n for kn, n in native.LAUNCHES.items() if n} == {"resident_fwd": 1}
    walk = native.WALKS["resident_fwd"]   # what the launch used
    assert walk["body"] == native.fwd_body(dtype, d, v_d)
    if walk["body"] == "tensor-core":
        per_row = -(-q_len // 128) * -(-v_d // 256)
        assert walk["items"] == b_kv * g * per_row
        assert walk["grid"] == min(walk["items"], torch.cuda.get_device_properties(
            dev).multi_processor_count)
        assert walk["group_rows"] == min(b_kv * g, max(1, walk["grid"] // per_row))
    o2, l2, m2 = forward._flash_forward_plain(forward.prescale(q, d ** -0.5), k, v, pack, rule)
    _close("o", o, o2, dtype)
    _close("l", l, l2, torch.float32)
    _close("m", m, m2, torch.float32)
    if case == "dead_rows":
        assert float(o[:, 0].float().abs().max()) == 0.0 and float(l[:, 0].abs().max()) == 0.0


# ---- the tensor-core backward (attention_bwd_tc.cuh) ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_tc_bwd_tile_matches_matmul(dev, dtype):
    """The backward's products on one tile: S^T = x y^T (both K-major), the
    dV / dK product T(S^T) z (A from the accumulator fragments, z a 64-row
    stage through the transpose bit) and the dQ product dst^T kt over 128
    kv rows (A, the dS^T tile, and B, K, both MN-major through the transpose
    bits), against float32 matmuls."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x, y, z, dst, kt = ((torch.rand(s, generator=gen, device=dev) * 4 - 2).to(dtype)
                        for s in ((64, 64), (64, 64), (64, 128), (128, 64), (128, 128)))
    st, o, dq = native.tc_bwd_tile_check(x, y, z, dst, kt)
    st_ref = torch.matmul(x.float(), y.float().T)
    # the kernel's own st, rounded as the kernel rounds it (a sum in another
    # order may round to the neighbouring half value)
    o_ref = torch.matmul(st.to(dtype).float(), z.float())
    dq_ref = torch.matmul(dst.float().T, kt.float())
    # float32 sums of exact products: the order only
    for got, want in ((st, st_ref), (o, o_ref), (dq, dq_ref)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("routes", ["auto", "table"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_backward_matches_plain(dev, monkeypatch, case, dtype, routes):
    """The fused backward on bf16 / fp16 (the tensor-core body of banded_bwd
    and flash_bwd_fused where max(d, v_d) <= 128, the scalar body above)
    against the plain backward, which rounds p and dS to the input type where
    the kernels round them: dQ, dK and dV within 2 ulps of the output type at
    each tensor's scale.  The auto route launches banded_bwd (window_bwd for
    the two cases whose transposed schedule is one band per sub-block), the
    table route flash_bwd_fused."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = TC_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + 3 * v_d)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    do = t(b_kv * g, q_len, v_d)
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    lse2, delta = backward.backward_stats(o, l, m, do)
    native.reset_launch_counts()
    got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule, config=BLOCKS,
                                  fused="kv")
    torch.cuda.synchronize()
    launched = {kn for kn in native.ATTENTION_KERNELS if native.LAUNCHES[kn]}
    want_kernel = {"auto": "window_bwd" if case in ("dead_rows", "local_2d_strided")
                   else "banded_bwd", "table": "flash_bwd_fused"}[routes]
    assert launched == {want_kernel}, launched
    assert native.bwd_body(dtype, d, v_d) == ("tensor-core" if max(d, v_d) <= 128 else "scalar")
    want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, d ** -0.5, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b, dtype)
    if case == "dead_rows":
        assert float(got[0][:, 0].float().abs().max()) == 0.0


# ---- the experiment tools' kernels (experiments/) against their plain versions ----

def _exp_tol(ref, ulps=2):
    """``ulps`` bf16 ulps at the output's scale, with no floor: kernel and
    plain version round p and o at the same points and sum in other orders,
    so an element parts by a rounding flip (one ulp of its magnitude, at most
    2**-7 of the largest), and the decode outputs are far below 1."""
    return ulps * 2.0 ** -8 * float(ref.float().abs().max())


def _uniform(gen, shape, dev, dtype=torch.bfloat16):
    return (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(dtype)


def _exp_launch(name, fn):
    native.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    assert native.LAUNCHES[name] == 1, native.LAUNCHES
    return out


@pytest.mark.parametrize("bq,bkv", [(256, 256), (256, 128), (128, 64), (512, 128), (1024, 1024)])
def test_exp_resident_kernel_matches_plain(dev, bq, bkv):
    from tf_flash_attention_tpu_torch.experiments import exp_resident as x
    gen = torch.Generator(device=dev).manual_seed(bq + bkv)
    q, k, v = (_uniform(gen, (2, 2048, 128), dev) for _ in range(3))
    got = _exp_launch("exp_resident_fwd",
                      lambda: x.resident_forward(q, k, v, block_q=bq, block_kv=bkv))
    # an item of block_q rows: 2 rows of 2048 / bq items
    assert native.WALKS["exp_resident_fwd"]["items"] == 2 * 2048 // bq
    want = x.resident_forward_plain(q, k, v, block_q=bq, block_kv=bkv)
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)
    assert float((got.float() - x.causal_oracle(q, k, v).float()).abs().max()) < 1e-2


def _exp_walk(name, dev, B, S):
    """The launch's walk: the tensor-core body, items of 128 query rows,
    a CTA an SM at most."""
    walk = native.WALKS[name]
    assert walk["body"] == native.EXP_FWD_BODY[name] == "tensor-core", walk
    assert walk["items"] == B * S // 128, walk
    assert walk["grid"] == min(walk["items"], torch.cuda.get_device_properties(
        dev).multi_processor_count), walk


# (block, d): the tool's blocks at d 128, whose cases keep their ids, then
# d 64 (TMA, Q and K padded to 128 columns) and d 60 (not a multiple of 8:
# the producer's plain loads)
EXP_BLOCK_D = [pytest.param(b, d, id=f"{b}" if d == 128 else f"{b}-d{d}")
               for b, d in ((512, 128), (2048, 128), (128, 128), (256, 128), (256, 64),
                            (256, 60))]


@pytest.mark.parametrize("block,d", EXP_BLOCK_D)
@pytest.mark.parametrize("rung", native.LADDER_RUNGS)
def test_exp_vpu_ladder_kernel_matches_plain(dev, rung, block, d):
    from tf_flash_attention_tpu_torch.experiments import exp_vpu_attrib as x
    gen = torch.Generator(device=dev).manual_seed(block)
    q, k, v = (_uniform(gen, (2, 2 * block, d), dev) for _ in range(3))
    q = q * torch.tensor(0.1275, dtype=torch.bfloat16, device=dev)
    got = _exp_launch("exp_vpu_ladder",
                      lambda: x.ladder(rung, q, k, v, block_q=block, block_kv=block))
    _exp_walk("exp_vpu_ladder", dev, 2, 2 * block)
    want = x.ladder_plain(rung, q, k, v, block_q=block, block_kv=block)
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)


# (block_kv, d): the tool's cut 256 at d 128, whose cases keep their ids,
# then 128 and 512 keys and d 64, d 60
EXP_UNROLL_CASES = [
    pytest.param(name, nkv, fused, bkv, d,
                 id=f"{name}-{nkv}-{fused}" + ("" if (bkv, d) == (256, 128) else f"-{bkv}-d{d}"))
    for bkv, d in ((256, 128), (128, 128), (512, 128), (256, 64), (256, 60))
    for name, nkv, fused in (("base", 1, False), ("unroll2", 2, False), ("unroll2f", 2, True),
                             ("unroll4", 4, False))]


@pytest.mark.parametrize("name,nkv,fused,bkv,d", EXP_UNROLL_CASES)
def test_exp_kv_unroll_kernel_matches_plain(dev, name, nkv, fused, bkv, d):
    from tf_flash_attention_tpu_torch.experiments import exp_kv_unroll as x
    gen = torch.Generator(device=dev).manual_seed(nkv)
    q, kv = _uniform(gen, (2, 2048, d), dev), _uniform(gen, (2, 2048, d), dev)
    got = _exp_launch("exp_kv_unroll",
                      lambda: x.kv_unroll(q, kv, kv, nkv=nkv, fused=fused, block_kv=bkv))
    _exp_walk("exp_kv_unroll", dev, 2, 2048)
    want = x.kv_unroll_plain(q, kv, kv, nkv=nkv, fused=fused, block_kv=bkv)
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)


@pytest.mark.parametrize("G", [8, 2])
@pytest.mark.parametrize("name", ["int8ref", "s32", "twopage", "fourpage", "int8_2pg", "bitcast"])
def test_exp_int4_unpack_kernels_match_plain(dev, name, G):
    from tf_flash_attention_tpu_torch.experiments import exp_int4_unpack as x
    gen = torch.Generator(device=dev).manual_seed(G)
    kv = torch.rand((2, 2, 2048, 128), generator=gen, device=dev) * 2 - 1
    kernel = x.KERNELS[name]
    if kernel.startswith("exp_int4_int8"):
        (k, ks), (v, vs) = x.quantize_int8(kv[0]), x.quantize_int8(kv[1])
    else:
        (k, ks, _), (v, vs, _) = x.quantize_int4(kv[0]), x.quantize_int4(kv[1])
    q = _uniform(gen, (4, 2, G, 128), dev)
    got = _exp_launch(kernel, lambda: x.int4_decode(kernel, q, k, ks, v, vs))
    want = x.int4_decode_plain(kernel, q, k, ks, v, vs)
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(
        want, 3 if name == "bitcast" else 2)


def _exp_decode_cache(dev, n_q=4):
    """An int8 cache, page 128, 3 slots (lengths 300, 512, 0), 4 pages a
    slot, 2 kv heads, d 128, and q (3, n_q, 128)."""
    cfg = kv_cache.KVCacheConfig(n_kv_heads=2, head_dim=128, page_size=128, n_pages=14,
                                 max_seqs=3, max_pages_per_seq=4, quantized=True,
                                 dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for p in (c.k_pages, c.v_pages):
        p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
    for s in (c.k_scales, c.v_scales):
        s.copy_(0.005 + 0.015 * torch.rand(s.shape, generator=gen, device=dev))
    c.page_tables.copy_(torch.randperm(13, generator=gen, device=dev)[:12].reshape(3, 4))
    c.lengths.copy_(torch.tensor([300, 512, 0], dtype=torch.int32))
    return c, _uniform(gen, (3, n_q, 128), dev)


@pytest.mark.parametrize("n_q", [2, 4, 16])
@pytest.mark.parametrize("variant", ["current", "postscale", "postscale_t", "int8mm", "int8mm_t"])
def test_exp_paged_decode_kernel_matches_plain(dev, variant, n_q):
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    c, q = _exp_decode_cache(dev, n_q)
    scales = ((c.k_scales, c.v_scales) if variant.endswith("_t")
              else (x.page_major(c.k_scales), x.page_major(c.v_scales)))
    args = (variant, q, c.k_pages, c.v_pages, *scales, c.page_tables, c.lengths)
    got = _exp_launch("exp_paged_decode", lambda: x.paged_decode(*args))
    want = x.paged_decode_plain(*args)
    assert torch.isfinite(got).all() and not got[2].any()
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)


def test_exp_paged_decode_int8mm_codes_equal(dev):
    """int8mm's q codes, integer scores and p codes equal the plain
    version's bit for bit."""
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    c, q = _exp_decode_cache(dev)
    args = ("int8mm_t", q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, c.page_tables,
            c.lengths)
    got = x.paged_decode(*args, codes=True)
    want = x.paged_decode_plain(*args, codes=True)
    for name, a, b in zip(("q codes", "scores", "p codes"), got[1:], want[1:]):
        assert torch.equal(a, b), (name, int((a != b).sum()))


# ---- the tensor-core q-outer backward (attention_qouter_tc.cuh) ----

# (rule, sync, q_seq, k_seq, d, v_d, b_kv, g): d and v_d 64 and 128, GQA 1
# and 4, causal, local and full rules, q_len != k_len with rows past q_len
# (ragged tiles), dead rows, widths whose row pitch is no multiple of 16
# bytes (the plain-load staging and the scalar atomics), and a long causal
# walk (32 stages) at the slice's width
QOUTER_CASES = {
    "d64_causal": (CausalRule(), "none_front", (384,), (384,), 64, 64, 2, 1),
    "d128_causal_gqa4": (CausalRule(), "none_front", (300,), (300,), 128, 128, 2, 4),
    "full_q_ne_k": (FullRule(), "none_front", (333,), (199,), 128, 64, 1, 1),
    "full_gqa4_k_longer": (FullRule(), "none_front", (150,), (420,), 64, 128, 1, 4),
    "local_stride": (LocalRule(5, 1, True), "scale_front", (220,), (310,), 64, 128, 2, 1),
    "local_2d_gqa4": (LocalRule(7, 0, False), "scale_end", (10, 22), (20, 11), 128, 64, 1, 4),
    "dead_rows": (CausalRule(), "scale_end", (300,), (40,), 64, 64, 1, 1),
    "pitch_60": (CausalRule(), "none_front", (260,), (260,), 60, 60, 1, 4),
    "pitch_q_only": (FullRule(), "none_front", (200,), (130,), 27, 13, 1, 1),
    "long_causal": (CausalRule(), "none_front", (2048,), (2048,), 128, 128, 2, 2),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(QOUTER_CASES))
def test_qouter_tc_matches_plain(dev, case, dtype):
    """The q-outer backward (fused="q") on bf16 / fp16 at max(d, v_d) <= 128
    launches once, on the tensor-core body (as the launch reports it and
    native.bwd_body names it), and matches the plain backward, which rounds
    p and dS where _fused_qouter_kernel does: dQ, dK and dV within 2 ulps of
    the output type at each tensor's scale."""
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = QOUTER_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + 5 * v_d + g)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    do = t(b_kv * g, q_len, v_d)
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    lse2, delta = backward.backward_stats(o, l, m, do)
    native.reset_launch_counts()
    got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule, config=BLOCKS,
                                  fused="q")
    torch.cuda.synchronize()
    assert {kn: n for kn, n in native.LAUNCHES.items() if n} == {"flash_bwd_qouter": 1}
    assert native.WALKS["flash_bwd_qouter"]["body"] == native.bwd_body(dtype, d, v_d) \
        == "tensor-core"
    want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, d ** -0.5, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b, dtype)
    if case == "dead_rows":
        assert float(got[0][:, 0].float().abs().max()) == 0.0


def test_qouter_scalar_body_where_the_rule_says(dev):
    """float32 and max(d, v_d) > 128 keep the scalar q-outer body, as the
    launch reports it."""
    for dtype, d, v_d in ((torch.float32, 64, 64), (torch.bfloat16, 200, 256)):
        gen = torch.Generator(device=dev).manual_seed(d)
        pack = make_sync_pack("none_front", (260,), (260,))
        t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
        q, k, v, do = t(2, 260, d), t(1, 260, d), t(1, 260, v_d), t(2, 260, v_d)
        o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=CausalRule(), config=BLOCKS)
        got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=CausalRule(),
                                      config=BLOCKS, fused="q")
        torch.cuda.synchronize()
        assert native.WALKS["flash_bwd_qouter"]["body"] == native.bwd_body(dtype, d, v_d) \
            == "scalar"
        lse2, delta = backward.backward_stats(o, l, m, do)
        want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, CausalRule(),
                                              d ** -0.5, True)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(name, a, b, dtype)


# ---- the tensor-core prefill (prefill_tc.cuh) ----

def _pf_cache(dev, payload, page_size, n_kv, mapped, seed):
    """A bf16-activation cache filled as chip_smoke.py fills the card's:
    quantized payloads over their type's range, scales that bring each to
    int8's size, the unquantized cache N(0, 1); slot 0 maps ``mapped``
    random pages."""
    qd = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
          "int4": "int4", "bf16": None}[payload]
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=128, page_size=page_size,
                                 n_pages=mapped + 3, max_seqs=2, max_pages_per_seq=mapped,
                                 quantized=qd is not None,
                                 quant_dtype=torch.int8 if qd is None else qd,
                                 dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for p in (c.k_pages, c.v_pages):
        if cfg.is_int4:
            p.copy_(torch.randint(-128, 128, p.shape, generator=gen, device=dev))
        elif qd == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
        elif qd is not None:
            qmax = kv_cache._quant_max(qd)
            p.copy_((torch.randn(p.shape, generator=gen, device=dev) * qmax / 8).clamp(-qmax, qmax))
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev))
    if qd is not None:
        unit = 127.0 / kv_cache._quant_max(qd)
        for s in (c.k_scales, c.v_scales):
            s.copy_((0.005 + 0.02 * torch.rand(s.shape, generator=gen, device=dev)) * unit)
    c.page_tables[0] = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)[:mapped].int()
    return cfg, c, gen


def _pf_run(dev, payload, page_size, n_q, n_kv, start, chunk, true_len, rule=CausalRule(),
            stride=1, offset=0, seed=0):
    """One paged_prefill launch on the tensor-core body against the plain
    version: o within 2 bf16 ulps at the output's scale, with the [cp]
    form's l and m within 1e-5."""
    mapped = -(-(start + true_len) // (page_size * stride)) + 1
    cfg, c, gen = _pf_cache(dev, payload, page_size, n_kv, mapped, seed)
    assert native.prefill_body(torch.bfloat16, cfg) == "tensor-core"
    qp = torch.randn((chunk, n_q, 128), generator=gen, device=dev).to(torch.bfloat16)
    qs = (qp.float() * torch.tensor(128 ** -0.5 * 1.4426950408889634)).to(torch.bfloat16)
    cp = stride != 1 or offset != 0
    shard = dict(page_stride=stride, page_offset=offset, returning_l_m=cp)
    native.reset_launch_counts()
    got = prefill.paged_prefill_attention(qp, c, cfg, 0, start, true_len, rule=rule, **shard)
    torch.cuda.synchronize()
    name = "paged_prefill[cp]" if cp else "paged_prefill"
    assert {k: n for k, n in native.LAUNCHES.items() if n} == {name: 1}
    assert native.WALKS[name] == dict(body="tensor-core")
    want = prefill._paged_prefill_plain(qs, c, cfg, 0, start, true_len, rule, cp, stride, offset)
    got, want = (got, want) if cp else ((got,), (want,))
    _serving_close(got[0][:true_len], want[0][:true_len], False)
    if cp:
        _close_lm([x[:true_len] for x in got], [x[:true_len] for x in want])
    return got


@pytest.mark.parametrize("page_size", [64, 256, 512])
@pytest.mark.parametrize("payload", ["int8", "e4m3", "e5m2", "int4", "bf16"])
def test_prefill_tc_matches_plain(dev, payload, page_size):
    """Every payload at pages of 64, 256 and 512 tokens: GQA 8/2, a cached
    prefix of 640 tokens and a 200-row chunk (no multiple of the 64-row
    items) with 190 real rows; and 8/8 heads, a 300-row chunk at 1000."""
    _pf_run(dev, payload, page_size, 8, 2, 640, 200, 190, seed=page_size)
    _pf_run(dev, payload, page_size, 8, 8, 1000, 300, 300, seed=page_size + 1)


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
def test_prefill_empty_chunk_reports_its_body(dev, act):
    """An empty chunk launches nothing on either body, and reports the body
    ``prefill_body`` names."""
    cfg, c, gen = _pf_cache(dev, "int8", 256, 2, 4, 0)
    qs = torch.zeros((0, 8, 128), dtype=act, device=dev)
    native.WALKS.pop("paged_prefill", None)
    o = native.paged_prefill(qs, c, cfg, 0, 640, 640, 0, 3, CausalRule())
    torch.cuda.synchronize()
    assert o.shape == (0, 8, 128)
    assert native.WALKS["paged_prefill"]["body"] == native.prefill_body(act, cfg)


@pytest.mark.parametrize("payload", ["int8", "e5m2", "bf16"])
def test_prefill_tc_start_0(dev, payload):
    """A first chunk (start 0): row 0 sees one key, and the pages past a
    tile's last row are skipped."""
    _pf_run(dev, payload, 64, 4, 4, 0, 300, 257)


@pytest.mark.parametrize("rule", [LocalRule(300, 0, True), LocalRule(40, 2, True)],
                         ids=["window_300", "window_40_stride_4"])
@pytest.mark.parametrize("payload", ["int8", "int4"])
def test_prefill_tc_local_window(dev, payload, rule):
    """A local window whose first pages fall below the slot's oldest chunk
    row (first_live > 0), at pages of 64 and 256."""
    for page_size in (64, 256):
        _pf_run(dev, payload, page_size, 8, 2, 1500, 128, 128, rule=rule)


@pytest.mark.parametrize("stride,offset", [(4, 0), (4, 3), (2, 1)])
@pytest.mark.parametrize("payload", ["int8", "e4m3", "int4", "bf16"])
def test_prefill_tc_cp_matches_plain(dev, payload, stride, offset):
    """The sequence-sharded form: a shard's pages of a stride from an
    offset, global key positions, l and m out."""
    _pf_run(dev, payload, 256, 8, 2, 3000, 512, 512, stride=stride, offset=offset)
