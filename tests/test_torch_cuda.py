"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests need a card and skip
elsewhere.  Run them on the GPU with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import CheckerCausal, fuzz_case
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.block_sizes import BlockConfig
from tf_flash_attention_tpu_torch.mask_rules import CausalRule, FullRule, LocalRule, MaskRule
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


def _cache(quantized, dtype, dev, lengths, n_kv=2, head_dim=32, seed=0, page_size=64,
           max_pages=4):
    """A cache of random contents; ``quantized`` is False, True (int8) or a
    payload name of ``QDTYPES``."""
    qd = QDTYPES.get(quantized)
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=head_dim, page_size=page_size,
                                 n_pages=max_pages * len(lengths) + 2, max_seqs=len(lengths),
                                 max_pages_per_seq=max_pages,
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
    c.page_tables.copy_(perm[:len(lengths) * max_pages].reshape(len(lengths), max_pages))
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cfg, c


def _write_plain(cache, cfg, slot, start, k, v, true_len, trash, page_stride=1, page_offset=0):
    """The chunk write's plain version at host scalars (its meta built on
    k's device)."""
    meta = kv_cache.chunk_write_meta(slot, start, true_len, trash, page_stride, k.device)
    kv_cache._write_tokens_plain(cache, cfg, meta[page_offset], k, v, page_stride)


def _prefill_plain(qs, cache, cfg, slot, start, true_len, rule, returning_l_m=False,
                   page_stride=1, page_offset=0):
    """The prefill's plain version at host scalars (its meta built on qs's
    device)."""
    meta = prefill.prefill_meta(cfg, slot, start, true_len, rule, page_stride, qs.device)
    return prefill._paged_prefill_plain(qs, cache, cfg, meta[page_offset], rule, returning_l_m,
                                        page_stride)


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
    _write_plain(b, cfg, 2, 40, k, v, 80, trash)
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
    ref = _prefill_plain(qs, c, cfg, 0, 110, 33, CausalRule())
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
    _write_plain(b, cfg, 0, 0, k, -k, 37, trash)
    b.lengths[0] = 37
    _same(a, b, trash)
    active = torch.tensor([True, False, True], device=dev)
    for _ in range(3):
        kn = torch.randn((3, 2, 32), generator=gen, device=dev).to(torch.bfloat16)
        kv_cache.append_tokens_batched(a, cfg, kn, -kn, active, trash)
        kv_cache._append_plain(b, cfg, kn, -kn, active, trash)
        b.lengths += active.to(torch.int32)
        _same(a, b, trash)


# ---- the KV writes' vector body: bit for bit with the plain versions ----

KV_PAYLOADS = [False, "int8", "e4m3", "e5m2", "int4"]


def _kv_body_ran(kernel, k, v, cfg):
    """The body the last launch of ``kernel`` reported, which must be the one
    native.kv_write_body names."""
    body = native.WALKS[kernel]["body"]
    assert body == native.kv_write_body(k, v, cfg), (kernel, body)
    return body


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", KV_PAYLOADS,
                         ids=["unquantized", "int8", "e4m3", "e5m2", "int4"])
def test_kv_writes_vector_body_bit_identical(dev, quantized, act, d):
    """kv_chunk_write on the projection's transposed (strided) K/V, a chunk
    crossing pages with an odd true_len, then appends of one token and of
    four (inactive slot 1), from even and odd lengths: pages, scales and
    lengths bit for bit with the plain versions, on the vector body (d 64
    pads the stored width 128 with zeros)."""
    cfg, c = _cache(quantized, act, dev, [70, 0, 33, 130], head_dim=d, page_size=16,
                    max_pages=16, seed=d)
    trash = cfg.n_pages - 1
    gen = torch.Generator(device=dev).manual_seed(d + 1)
    k = torch.randn((96, 2, d), generator=gen, device=dev).to(act).transpose(0, 1)
    v = torch.randn((96, 2, d), generator=gen, device=dev).to(act).transpose(0, 1)
    a, b = _clone(c), _clone(c)
    native.reset_launch_counts()
    kv_cache.write_tokens_at(a, cfg, 2, 40, k, v, 81, trash)
    _write_plain(b, cfg, 2, 40, k, v, 81, trash)
    b.lengths[2] = 121
    _same(a, b, trash)
    assert _kv_body_ran("kv_chunk_write", k, v, cfg) == "vector"
    active = torch.tensor([True, False, True, True], device=dev)
    for T in (1, 4):
        kn = torch.randn((4, T, 2, d), generator=gen, device=dev).to(act)
        vn = torch.randn((4, T, 2, d), generator=gen, device=dev).to(act)
        kv_cache.append_tokens_batched(a, cfg, kn, vn, active, trash)
        kv_cache._append_tokens_plain(b, cfg, kn, vn, active, trash)
        _same(a, b, trash)
        assert _kv_body_ran("kv_append", kn, vn, cfg) == "vector"
    torch.cuda.synchronize()
    assert {n: x for n, x in native.LAUNCHES.items() if x} == {"kv_chunk_write": 1,
                                                               "kv_append": 2}


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("quantized", KV_PAYLOADS,
                         ids=["unquantized", "int8", "e4m3", "e5m2", "int4"])
def test_kv_writes_sharded_bit_identical(dev, quantized, stride):
    """Every shard of a stride: a chunk write crossing pages with an odd
    true_len (only the shard's rows, its length the owned-token count), then
    appends of T = 1, 2, 4 and 5 tokens a slot at global lengths odd and
    even, with an inactive slot and tokens other shards own: bit for bit
    with the plain versions (T ordered appends with the owner masks)."""
    glob = [13, 30, 47, 58]
    for r in range(stride):
        local = [kv_cache._owned_token_count(g, 16, stride, r) for g in glob]
        cfg, c = _cache(quantized, torch.bfloat16, dev, local, head_dim=128, page_size=16,
                        max_pages=16, seed=stride + r)
        trash = cfg.n_pages - 1
        gen = torch.Generator(device=dev).manual_seed(10 * stride + r)
        shard = dict(page_stride=stride, page_offset=r)
        k = torch.randn((2, 64, 128), generator=gen, device=dev).to(torch.bfloat16)
        a, b = _clone(c), _clone(c)
        kv_cache.write_tokens_at(a, cfg, 1, 18, k, -k, 45, trash, **shard)
        _write_plain(b, cfg, 1, 18, k, -k, 45, trash, **shard)
        b.lengths[1] = kv_cache._owned_token_count(63, 16, stride, r)
        _same(a, b, trash)
        g = torch.tensor(glob, dtype=torch.int32, device=dev)
        g[1] = 63
        active = torch.tensor([True, True, False, True], device=dev)
        for T in (1, 2, 4, 5):
            kn = torch.randn((4, T, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn((4, T, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
            glob_before = g.clone()
            kv_cache.append_tokens_batched(a, cfg, kn, vn, active, trash, global_lengths=g,
                                           **shard)
            kv_cache._append_tokens_plain(b, cfg, kn, vn, active, trash, g, **shard)
            _same(a, b, trash)
            g += T * active.to(torch.int32)
            want = [kv_cache._owned_token_count(int(x), 16, stride, r) for x in g.tolist()]
            assert a.lengths.tolist() == want, (T, glob_before.tolist())
        assert native.WALKS["kv_append"]["body"] == "vector"


@pytest.mark.parametrize("case", ["d_store_384", "d_30", "misaligned"])
@pytest.mark.parametrize("quantized", ["int8", "int4", False],
                         ids=["int8", "int4", "unquantized"])
def test_kv_writes_scalar_body_bit_identical(dev, quantized, case):
    """Shapes the vector body does not take run the scalar body, as the
    launch reports and kv_write_body names: a stored width of 384, a head
    dim not a multiple of 4, a source one element off its alignment."""
    d = {"d_store_384": 384, "d_30": 30, "misaligned": 128}[case]
    cfg, c = _cache(quantized, torch.bfloat16, dev, [70, 0, 33], head_dim=d, page_size=16,
                    max_pages=16, seed=7)
    trash = cfg.n_pages - 1
    gen = torch.Generator(device=dev).manual_seed(8)
    extra = 1 if case == "misaligned" else 0

    def src(*shape):
        x = torch.randn((*shape[:-1], shape[-1] + extra), generator=gen, device=dev)
        return x.to(torch.bfloat16)[..., extra:]

    k, v = src(2, 64, d), src(2, 64, d)
    a, b = _clone(c), _clone(c)
    kv_cache.write_tokens_at(a, cfg, 1, 20, k, v, 37, trash)
    _write_plain(b, cfg, 1, 20, k, v, 37, trash)
    b.lengths[1] = 57
    _same(a, b, trash)
    assert _kv_body_ran("kv_chunk_write", k, v, cfg) == "scalar"
    active = torch.tensor([True, False, True], device=dev)
    for T in (1, 3):
        kn, vn = src(3, T, 2, d), src(3, T, 2, d)
        kv_cache.append_tokens_batched(a, cfg, kn, vn, active, trash)
        kv_cache._append_tokens_plain(b, cfg, kn, vn, active, trash)
        _same(a, b, trash)
        assert _kv_body_ran("kv_append", kn, vn, cfg) == "scalar"


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
    ref = _prefill_plain(qs, c, cfg, 1, 110, 40, CausalRule())
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
    ref = _prefill_plain(qs, c, cfg, 0, 150, 40, rule)
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


def _ran(e, kernel):
    """The launches of ``kernel`` that ran in ``e``'s steps: the wrappers'
    less those a graph's capture recorded without running, plus the
    graphs' replays'."""
    captured = sum(g.launches.get(kernel, 0)
                   for step in (e._decode_step, e._spec_step, e._chunk_prefill)
                   for g in getattr(step, "graphs", {}).values())
    return native.LAUNCHES[kernel] - captured + native.REPLAYED[kernel]


@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_engine_speculative_on_gpu_matches_cpu(dev, quantized):
    """Speculative greedy on the card gives the CPU engine's tokens, spec
    stats and page counts; the verify step runs paged_multitoken_decode,
    and a step's gamma tokens take one kv_append a layer."""
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
    assert native.LAUNCHES["paged_multitoken_decode"] > 0
    assert _ran(e, "kv_append") == cfg.n_layers * e.stats["steps"], native.LAUNCHES


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
        want = _prefill_plain(qs, c, cfg, 0, 600, 40, rule, True, **shard)
        _serving_close(got[0][:40], want[0][:40], f32)
        _close_lm([x[:40] for x in got], [x[:40] for x in want])
        trash = cfg.n_pages - 1
        k = torch.randn((2, 96, 32), generator=gen, device=dev).to(act)
        a, b = _clone(c), _clone(c)
        kv_cache.write_tokens_at(a, cfg, 3, 40, k, -k, 81, trash, **shard)
        _write_plain(b, cfg, 3, 40, k, -k, 81, trash, **shard)
        b.lengths[3] = _owned(121, r)
        _same(a, b, trash)
        torch.cuda.synchronize()
        assert all(native.LAUNCHES[v] == 1 for v in native.CP_VARIANTS), native.LAUNCHES
        assert not any(native.LAUNCHES[k] for k in native.SERVING_KERNELS)


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_engine_context_parallel_on_gpu_matches_cpu(dev, quantized, spec):
    """cp = 4 on cuda:0 (the shards share the card) gives the tokens, stats
    and free pages of cp = 4 on the CPU, and launches every CP variant; a
    step takes one kv_append a layer a shard (with speculation too)."""
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
    assert _ran(e, "kv_append") == 4 * cfg.n_layers * e.stats["steps"]


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


class Checker(CheckerCausal, MaskRule):
    pass


# a custom rule on each route it takes: auto (the window kernels at these
# lengths), table, resident (banded forward), the q-outer and split
# backwards in every case; d 128 reaches the tensor-core bodies on half
# inputs
CUSTOM_CASES = {
    "1d_ragged": ("scale_front", (300,), (520,), 32, 24, 2, 1),
    "2d": ("scale_end", (10, 22), (20, 11), 24, 12, 2, 1),
    "1d_gqa_d128": ("none_front", (384,), (512,), 128, 128, 2, 2),
}


@pytest.mark.parametrize("routes", list(ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", list(CUSTOM_CASES))
def test_custom_rule_kernels_match_plain(dev, monkeypatch, case, dtype, routes):
    """A custom rule's check reaches every op body through its granule mask
    (kind 3): forward and the three backward families, kernel against plain
    version, on every route."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    assert native.fa_rule(make_sync_pack("none_front", (64,), (64,)), Checker(),
                          dev).kind == native.CUSTOM_KIND
    _run_op_case(dev, Checker(), *CUSTOM_CASES[case], dtype=dtype)


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


@pytest.mark.parametrize("routes", ["auto", "table", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_backward_matches_plain(dev, monkeypatch, case, dtype, routes):
    """The backward on bf16 / fp16 (the tensor-core bodies of banded_bwd,
    flash_bwd_fused and the split pair where max(d, v_d) <= 128, the scalar
    bodies above) against the plain backward, which rounds p and dS to the
    input type where the kernels round them: dQ, dK and dV within 2 ulps of
    the output type at each tensor's scale.  The auto route launches
    banded_bwd (window_bwd for the two cases whose transposed schedule is
    one band per sub-block), the table route flash_bwd_fused, the split route
    (FA_FUSED_BWD=0, the auto backward) flash_bwd_dq and flash_bwd_dkv."""
    env = {"FA_FUSED_BWD": "0"} if routes == "split" else ROUTES[routes]
    for var, val in env.items():
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
                                  fused=None if routes == "split" else "kv")
    torch.cuda.synchronize()
    launched = {kn for kn in native.ATTENTION_KERNELS if native.LAUNCHES[kn]}
    want_kernels = {"auto": {"window_bwd" if case in ("dead_rows", "local_2d_strided")
                             else "banded_bwd"}, "table": {"flash_bwd_fused"},
                    "split": {"flash_bwd_dq", "flash_bwd_dkv"}}[routes]
    assert launched == want_kernels, launched
    body = "tensor-core" if max(d, v_d) <= 128 else "scalar"
    assert native.bwd_body(dtype, d, v_d) == body
    if routes == "split":
        assert native.WALKS["flash_bwd_dq"]["body"] == native.WALKS["flash_bwd_dkv"]["body"] \
            == body
    want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, d ** -0.5,
                                          routes != "split")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b, dtype)
    if case == "dead_rows":
        assert float(got[0][:, 0].float().abs().max()) == 0.0


# ---- the window walks of the tensor-core bodies (window_fwd, window_bwd) ----

# (rule, sync, q_seq, k_seq, d, v_d, b_kv, g): the JAX package's window
# sweep's two shapes cut to size (a 32 x 32 image at window 8, 2,048 tokens
# at window 512), GQA 8 q / 2 kv heads, a band with no masked element (the
# forward's masked=False walk), ragged q_len and k_len, and chip_smoke.py
# phase 5 case (e)'s fp16 d 64 / v_d 96 (a window forward, a banded
# backward)
WINDOW_TC_CASES = {
    "local2d_w8": (LocalRule(8, 0, True), "none_front", (32, 32), (32, 32), 128, 128, 2, 1),
    "local1d_w512": (LocalRule(512, 0, True), "none_front", (2048,), (2048,), 128, 128, 2, 1),
    "gqa_8_2": (LocalRule(64, 0, True), "none_front", (640,), (640,), 128, 128, 2, 4),
    "unmasked": (LocalRule(1000, 0, False), "none_front", (512,), (512,), 128, 128, 2, 1),
    "ragged": (LocalRule(64, 0, True), "scale_end", (300,), (520,), 128, 128, 2, 1),
    "case_e": (LocalRule(7, 0, False), "scale_end", (32, 48), (48, 32), 64, 96, 2, 1),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("case", list(WINDOW_TC_CASES))
def test_window_tc_matches_plain(dev, case, dtype):
    """window_fwd and window_bwd through the op path against their plain
    versions within 2 ulps of the output type at each tensor's scale (l and
    m 2e-5 at theirs), each launch reporting the body fwd_body / bwd_body
    names (bf16 and fp16: the tensor-core walks; float32: the scalar
    bodies); two backward launches give bit-equal dK and dV (dQ's
    reduce-add may vary in its last bits)."""
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = WINDOW_TC_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + 5 * g)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    q, k, v = t(b_kv * g, q_len, d), t(b_kv, k_len, d), t(b_kv, k_len, v_d)
    do = t(b_kv * g, q_len, v_d)
    fw = forward.forward_route(pack, rule, BLOCKS, d, v_d)
    (bw,) = backward.backward_route(pack, rule, BLOCKS, g, "kv")
    assert fw.kernel == "window_fwd" and fw.masked == (case != "unmasked")
    assert bw.kernel == ("banded_bwd" if case == "case_e" else "window_bwd")
    native.reset_launch_counts()
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    torch.cuda.synchronize()
    assert native.LAUNCHES["window_fwd"] == 1
    want_fwd = "tensor-core" if dtype != torch.float32 else "scalar"
    assert native.WALKS["window_fwd"]["body"] == native.fwd_body(dtype, d, v_d) == want_fwd
    o2, l2, m2 = forward._flash_forward_plain(forward.prescale(q, d ** -0.5), k, v, pack, rule)
    _close("o", o, o2, dtype)
    _close("l", l, l2, torch.float32)
    _close("m", m, m2, torch.float32)
    runs = [backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule, config=BLOCKS,
                                    fused="kv") for _ in range(2)]
    torch.cuda.synchronize()
    if bw.kernel == "window_bwd":
        assert native.LAUNCHES["window_bwd"] == 2
        assert native.WALKS["window_bwd"]["body"] == native.bwd_body(dtype, d, v_d) == want_fwd
    lse2, delta = backward.backward_stats(o, l, m, do)
    want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, d ** -0.5, True)
    for name, a, b in zip(("dq", "dk", "dv"), runs[0], want):
        _close(name, a, b, dtype)
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])


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


# (G, pages of 256, rows B): 4 rows of 8 pages at G 8 and 2 (the first
# cases, whose ids stay), then G 1 and 4 and page counts of 4, 12 and 32 at
# row counts whose split counts do not always divide the merge units (24
# rows x 2 kv heads: 11 splits; 64 rows: 4 splits of 12 pages' 6 two-page
# units, one CTA empty)
INT4_CASES = [(8, 8, 4), (2, 8, 4), (1, 4, 4), (4, 12, 24), (8, 32, 24), (2, 12, 64)]


@pytest.mark.parametrize("name,G,pages,B", [
    pytest.param(name, G, pages, B, id=f"{name}-{G}" + ("" if pages == 8 else f"-p{pages}-b{B}"))
    for G, pages, B in INT4_CASES
    for name in ("int8ref", "s32", "twopage", "fourpage", "int8_2pg", "bitcast")])
def test_exp_int4_unpack_kernels_match_plain(dev, name, G, pages, B):
    """Each of the tool's kernels against its plain version (2 bf16 ulps at
    the output's scale, bitcast 3); each site reports the decode's
    tensor-core body with ``native.exp_int4_plan``'s splits and CTAs, and two
    launches give the same bits."""
    from tf_flash_attention_tpu_torch.experiments import exp_int4_unpack as x
    gen = torch.Generator(device=dev).manual_seed(G)
    kv = torch.rand((2, 2, 256 * pages, 128), generator=gen, device=dev) * 2 - 1
    kernel = x.KERNELS[name]
    if kernel.startswith("exp_int4_int8"):
        (k, ks), (v, vs) = x.quantize_int8(kv[0]), x.quantize_int8(kv[1])
    else:
        (k, ks, _), (v, vs, _) = x.quantize_int4(kv[0]), x.quantize_int4(kv[1])
    q = _uniform(gen, (B, 2, G, 128), dev)
    got = _exp_launch(kernel, lambda: x.int4_decode(kernel, q, k, ks, v, vs))
    want = x.int4_decode_plain(kernel, q, k, ks, v, vs)
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(
        want, 3 if name == "bitcast" else 2)
    plan = native.exp_int4_plan(kernel, B, 2, G, pages, k.shape[2])
    assert native.WALKS[kernel] == dict(body="tensor-core", splits=plan["splits"],
                                        ctas=plan["ctas"]), native.WALKS[kernel]
    assert torch.equal(x.int4_decode(kernel, q, k, ks, v, vs), got)   # run order: the same bits


@pytest.mark.parametrize("int4", [True, False])
def test_serving_decode_on_the_tools_pages(dev, int4):
    """The yardstick of the int4 sites: the serving decode (its tensor-core
    body, the serving unpack) on the tool's K/V laid out as a cache whose
    16 slots share its pages computes s32's function (int8: int8ref's),
    within the gate of that plain version."""
    from tf_flash_attention_tpu_torch.experiments import exp_int4_unpack as x
    gen = torch.Generator(device=dev).manual_seed(11)
    kv = torch.rand((2, 2, 8192, 128), generator=gen, device=dev) * 2 - 1
    if int4:
        (k, ks, _), (v, vs, _) = x.quantize_int4(kv[0]), x.quantize_int4(kv[1])
    else:
        (k, ks), (v, vs) = x.quantize_int8(kv[0]), x.quantize_int8(kv[1])
    q = _uniform(gen, (16, 2, 8, 128), dev)
    got = _exp_launch("paged_decode", lambda: x.serving_decode(q, k, ks, v, vs))
    assert native.WALKS["paged_decode"]["body"] == "tensor-core"
    want = x.int4_decode_plain("exp_int4_s32" if int4 else "exp_int4_int8ref", q, k, ks, v, vs)
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)


def _exp_decode_cache(dev, n_q=4, page=128, lengths=(300, 512, 0), max_pages=4):
    """An int8 cache of 2 kv heads, d 128, a slot per length (page 128, 3
    slots of lengths 300, 512 and 0, 4 pages a slot, by default), pages
    drawn at random, and q (slots, n_q, 128)."""
    S = len(lengths)
    cfg = kv_cache.KVCacheConfig(n_kv_heads=2, head_dim=128, page_size=page,
                                 n_pages=S * max_pages + 2, max_seqs=S,
                                 max_pages_per_seq=max_pages, quantized=True,
                                 dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for p in (c.k_pages, c.v_pages):
        p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
    for s in (c.k_scales, c.v_scales):
        s.copy_(0.005 + 0.015 * torch.rand(s.shape, generator=gen, device=dev))
    c.page_tables.copy_(torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)
                        [:S * max_pages].reshape(S, max_pages))
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return c, _uniform(gen, (S, n_q, 128), dev)


def _exp_decode_run(dev, variant, n_q, **cache):
    """exp_decode's ``variant`` on ``_exp_decode_cache``: within 2 bf16 ulps
    of its plain version at the output's scale, an empty slot's rows zero,
    the decode's tensor-core body with ``native.exp_decode_plan``'s splits
    and CTAs, and two launches' bits equal."""
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    c, q = _exp_decode_cache(dev, n_q, **cache)
    scales = ((c.k_scales, c.v_scales) if variant.endswith("_t")
              else (x.page_major(c.k_scales), x.page_major(c.v_scales)))
    args = (variant, q, c.k_pages, c.v_pages, *scales, c.page_tables, c.lengths)
    got = _exp_launch("exp_paged_decode", lambda: x.paged_decode(*args))
    want = x.paged_decode_plain(*args)
    empty = c.lengths.cpu() == 0
    assert torch.isfinite(got).all() and not got[empty].any()
    assert float((got.float() - want.float()).abs().max()) <= _exp_tol(want)
    plan = native.exp_decode_plan(variant.removesuffix("_t"), *q.shape[:2], 2,
                                  c.k_pages.shape[2], c.page_tables.shape[1])
    assert native.WALKS["exp_paged_decode"] == dict(body="tensor-core", splits=plan["splits"],
                                                    ctas=plan["ctas"])
    assert torch.equal(x.paged_decode(*args), got)


EXP_DECODE_VARIANTS = ["current", "postscale", "postscale_t", "int8mm", "int8mm_t"]


# n_q 2, 4, 16 and 32 over 2 kv heads: G 1, 2, 8 and 16
@pytest.mark.parametrize("n_q", [2, 4, 16, 32])
@pytest.mark.parametrize("variant", EXP_DECODE_VARIANTS)
def test_exp_paged_decode_kernel_matches_plain(dev, variant, n_q):
    _exp_decode_run(dev, variant, n_q)


# pages of 512 keys (the tool's) and 64, lengths that are no multiple of 64
# (1,000, 37), a full slot and an empty one, at G 1 and 16
@pytest.mark.parametrize("page,lengths,max_pages", [(512, (1000, 2048, 0, 37), 4),
                                                    (64, (1000, 0, 37, 1024), 16)])
@pytest.mark.parametrize("n_q", [2, 32])
@pytest.mark.parametrize("variant", EXP_DECODE_VARIANTS)
def test_exp_paged_decode_pages(dev, variant, n_q, page, lengths, max_pages):
    _exp_decode_run(dev, variant, n_q, page=page, lengths=lengths, max_pages=max_pages)


@pytest.mark.parametrize("n_q,page", [(34, 128), (2, 96), (2, 1024)])
def test_exp_paged_decode_refuses_other_shapes(dev, n_q, page):
    """G > 16 and pages that are not 64-512 keys, a multiple of 64, raise:
    no scalar body takes them."""
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    c, q = _exp_decode_cache(dev, n_q, page=page, lengths=(page, 0), max_pages=2)
    with pytest.raises(ValueError, match="G <= 16"):
        x.paged_decode("postscale_t", q, c.k_pages, c.v_pages, c.k_scales, c.v_scales,
                       c.page_tables, c.lengths)


def _int8mm_codes_equal(dev, **cache):
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    c, q = _exp_decode_cache(dev, **cache)
    args = ("int8mm_t", q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, c.page_tables,
            c.lengths)
    got = x.paged_decode(*args, codes=True)
    want = x.paged_decode_plain(*args, codes=True)
    for name, a, b in zip(("q codes", "scores", "p codes"), got[1:], want[1:]):
        assert torch.equal(a, b), (name, int((a != b).sum()))


def test_exp_paged_decode_int8mm_codes_equal(dev):
    """int8mm's q codes, integer scores and p codes equal the plain
    version's bit for bit."""
    _int8mm_codes_equal(dev)


def test_exp_paged_decode_int8mm_codes_equal_page512(dev):
    """The same on the tool's pages of 512 keys, ragged and empty slots."""
    _int8mm_codes_equal(dev, page=512, lengths=(1000, 2048, 0, 37), max_pages=4)


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


# ---- the split pair on the tensor-core bodies (flash_bwd_dq, flash_bwd_dkv) ----

# (rule, sync, q_seq, k_seq, d, v_d, b_kv, g): causal, full, strided local
# and a custom rule; GQA 8/2 (2 kv rows of 4 query heads); q_len != k_len
# and lengths that are no multiple of 64; d = v_d = 128, d 64 / v_d 128, d
# 72 (TMA with a part-filled second slab) and d 60 (a pitch no multiple of
# 16 bytes: the producer's plain-load staging)
SPLIT_CASES = {
    "causal_d128": (CausalRule(), "none_front", (384,), (384,), 128, 128, 2, 1),
    "causal_gqa_8_2": (CausalRule(), "none_front", (300,), (300,), 128, 128, 2, 4),
    "full_q_ne_k": (FullRule(), "none_front", (333,), (199,), 64, 128, 1, 1),
    "full_k_longer_gqa": (FullRule(), "none_front", (150,), (420,), 128, 64, 1, 4),
    "local_stride": (LocalRule(5, 1, True), "scale_front", (220,), (310,), 64, 128, 2, 1),
    "local_2d_gqa": (LocalRule(7, 0, False), "scale_end", (10, 22), (20, 11), 128, 64, 1, 4),
    "custom": (Checker(), "none_front", (384,), (512,), 128, 128, 2, 2),
    "d72": (CausalRule(), "none_front", (260,), (300,), 72, 72, 1, 2),
    "pitch_60": (CausalRule(), "none_front", (260,), (260,), 60, 60, 1, 4),
    "dead_rows": (CausalRule(), "scale_end", (300,), (40,), 64, 64, 1, 1),
    "long_causal": (CausalRule(), "none_front", (2048,), (2048,), 128, 128, 2, 2),
}


def _split_inputs(dev, case, dtype):
    rule, sync, q_seq, k_seq, d, v_d, b_kv, g = SPLIT_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(d + 7 * v_d + g)
    pack = make_sync_pack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
    # q and k at different scales: the dQ kernel takes prescaled q, the dK/dV
    # kernel prescaled k, and a swap of the two stays hidden at equal scales
    q, k = t(b_kv * g, q_len, d) * 0.5, t(b_kv, k_len, d) * 2
    v, do = t(b_kv, k_len, v_d), t(b_kv * g, q_len, v_d)
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=BLOCKS)
    return rule, pack, (q, k, v, o, l, m, do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_tc_matches_plain(dev, case, dtype):
    """The split pair (fused=False) on bf16 / fp16 at max(d, v_d) <= 128
    launches each kernel once, on the tensor-core body (as each launch
    reports it and native.bwd_body names it), matches the plain split
    backward, which rounds p and dS where _dq_kernel and _dkv_kernel do
    (dQ, dK and dV within 2 ulps of the output type at each tensor's
    scale), and gives bit-equal gradients on a second call: the route is
    deterministic."""
    rule, pack, (q, k, v, o, l, m, do) = _split_inputs(dev, case, dtype)
    d, v_d = q.shape[2], v.shape[2]
    native.reset_launch_counts()
    got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule, config=BLOCKS,
                                  fused=False)
    torch.cuda.synchronize()
    assert {kn: n for kn, n in native.LAUNCHES.items() if n} == {"flash_bwd_dq": 1,
                                                                 "flash_bwd_dkv": 1}
    for kn in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert native.WALKS[kn]["body"] == native.bwd_body(dtype, d, v_d) == "tensor-core"
    lse2, delta = backward.backward_stats(o, l, m, do)
    want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, d ** -0.5,
                                          False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b, dtype)
    again = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule, config=BLOCKS,
                                    fused=False)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), name
    if case == "dead_rows":
        assert float(got[0][:, 0].float().abs().max()) == 0.0


def test_split_scalar_body_where_the_rule_says(dev):
    """float32 and max(d, v_d) > 128 keep the scalar split pair, as each
    launch reports it, and match the plain split backward."""
    for dtype, d, v_d in ((torch.float32, 64, 64), (torch.float32, 128, 128),
                          (torch.bfloat16, 256, 256), (torch.float16, 128, 200)):
        gen = torch.Generator(device=dev).manual_seed(d + v_d)
        pack = make_sync_pack("none_front", (260,), (300,))
        t = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 4 - 2).to(dtype)
        q, k, v, do = t(2, 260, d), t(1, 300, d), t(1, 300, v_d), t(2, 260, v_d)
        o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=CausalRule(), config=BLOCKS)
        got = backward.flash_backward(q, k, v, o, l, m, do, pack=pack, rule=CausalRule(),
                                      config=BLOCKS, fused=False)
        torch.cuda.synchronize()
        for kn in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert native.WALKS[kn]["body"] == native.bwd_body(dtype, d, v_d) == "scalar"
        lse2, delta = backward.backward_stats(o, l, m, do)
        want = backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, CausalRule(),
                                              d ** -0.5, False)
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
    want = _prefill_plain(qs, c, cfg, 0, start, true_len, rule, cp, stride, offset)
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
    meta = prefill.prefill_meta(cfg, 0, 640, 0, CausalRule(), device=dev)[0]
    o = native.paged_prefill(qs, c, cfg, meta, CausalRule())
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


# ---- the rest of jax.jit: graphed training steps, attention callables and
# the bucketed prefill against their eager functions on the same card ----

TINY = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                       d_ff=128, dtype=torch.float32)


def _graphed_train_case(dev, layout, cards=None):
    """``make() -> (params, step)``: a training layout on one card (its
    slots on ``cards`` in turn, where given), from the same initial weights
    at every call."""
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    cfg = {"moe": dataclasses.replace(TINY, n_experts=4),
           "cp2": dataclasses.replace(TINY, context_parallel=True),
           "cp4": dataclasses.replace(TINY, context_parallel=True)}.get(layout, TINY)
    init = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = lambda params: torch.optim.AdamW(params, lr=1e-2, capturable=True)
    shapes = {"dense": ((1, 1), ("data", "model")), "tp2": ((2, 2), ("data", "model")),
              "cp2": ((1, 1, 2), ("data", "model", "context")),
              "cp4": ((1, 2, 2), ("data", "model", "context")),
              "moe": ((2, 2), ("data", "model")), "pipeline": ((2, 2), ("data", "pipe"))}
    shape, axes = shapes[layout]
    n = int(np.prod(shape))
    mesh = make_mesh(shape, axes, [cards[i % len(cards)] for i in range(n)] if cards
                     else [dev] * n)

    def make():
        params = copy.deepcopy(init).to(dev)
        if layout == "pipeline":
            staged = pipeline.stack_stage_params(cfg, params, 2)
            return staged, pipeline.make_pipeline_train_step(cfg, mesh, opt(staged.parameters()),
                                                             2)[0]
        return params, ttf.make_sharded_train_step(cfg, mesh, opt(params.parameters()))

    return make


@pytest.mark.parametrize("layout", ["dense", "tp2", "cp2", "cp4", "moe", "pipeline"])
def test_graphed_train_step_matches_eager(dev, layout):
    """Three steps of the factory's graph (the first eager, then the
    capture; two replays) and three of its eager step from the same
    weights: equal losses and gradients within float32 summation order,
    a fresh loss each call, the graph's banded launches counted once and
    its replays apart."""
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedTrainStep

    make = _graphed_train_case(dev, layout)
    tokens = torch.randint(0, 64, (4, 33), generator=torch.Generator().manual_seed(1)).to(dev)
    runs = []
    for graphed in (False, True):
        params, step = make()
        assert isinstance(step, GraphedTrainStep)
        native.reset_launch_counts()
        losses = [(step if graphed else step.eager)(params, tokens) for _ in range(3)]
        grads = [p.grad.clone() for p in params.parameters() if p.grad is not None]
        runs.append((torch.stack(losses), grads))
    (want, want_g), (got, got_g) = runs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert len(got_g) == len(want_g)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    g = next(iter(step.graphs.values()))
    assert g.replays == 2 and g.nodes["kernels"] >= sum(g.launches.values()) > 0
    for kernel, n in g.launches.items():
        assert native.LAUNCHES[kernel] == native.REPLAYED[kernel] == 2 * n, kernel


def test_graphed_attention_callables_match_eager(dev):
    """The ring and Ulysses on a context axis of 2 and the sharded callable
    on a model axis of 2, bf16: a replay's output and gradients equal the
    eager function's within 2 ulps; a backward after a later call of the
    same signature raises."""
    from tf_flash_attention_tpu_torch.parallel import (make_mesh, ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)

    ctx = make_mesh((1, 1, 2), ("data", "model", "context"), [dev] * 2)
    heads = make_mesh((1, 2), ("data", "model"), [dev] * 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((2, 4, 512, 64), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do)]

    for fn in (ring_flash_attention(ctx, rule=CausalRule()),
               ulysses_flash_attention(ctx, CausalRule()),
               sharded_flash_attention(heads, CausalRule())):
        want = run(fn.eager)
        run(fn)
        for a, b in zip(run(fn), want):
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol_low(b))
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        first = fn(*xs)
        fn(*xs)
        with pytest.raises(RuntimeError, match="later call"):
            torch.autograd.grad(first, xs, do)


def test_graphed_bucketed_engine_matches_eager(dev):
    """The bucketed engine with its graphs (a bucket's prefill, the first-
    token sampler) gives the eager engine's tokens, sampled ones included."""
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    ecfg = engine.EngineConfig(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4,
                               prefill_mode="bucketed", prefill_buckets=(32, 128), seed=3)
    # both buckets, each twice (a replay), tokens within the vocabulary of 64
    prompts = [list(range(1, 21)), [(5 * i) % 63 + 1 for i in range(100)], [7] * 30,
               list(range(2, 64))]
    sampled = SamplingParams(temperature=0.9, top_k=10)
    outs = []
    for graphed in (False, True):
        e = engine.DecodeEngine(TINY, ttf.init_params(TINY, torch.Generator().manual_seed(0),
                                                      "cpu"), ecfg, device=dev)
        if not graphed:
            e._bucket_prefill, e._sample1 = e._prefill_impl, e._sample1_impl
        rids = [e.submit(p, max_new_tokens=6, sampling=sampled if i % 2 else SamplingParams())
                for i, p in enumerate(prompts)]
        res = e.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    assert len(e._bucket_prefill.graphs) == 2 and len(e._sample1.graphs) == 1


# ---- serving over a process group (a world of one rank in this process)
# and the standalone serving callables' graphs ----

def _world_of_one(backend, dev):
    """A world-size-1 ``backend`` group in this process; returns its
    tear-down."""
    import os
    import socket

    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(torch.device(dev.type, torch.cuda.current_device()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    return dist.destroy_process_group


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_process_group_engine_of_one_rank(dev, backend):
    """The flat engine on a world-size-1 group's mesh (seq 1 x model 1)
    gives the single-process engine's tokens: over NCCL graphed, its sums
    inside the graphs; over gloo a graphed step refuses when it would
    capture (not at construction), and the eager steps serve."""
    from tf_flash_attention_tpu_torch.parallel import collectives
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    params = ttf.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    ecfg = engine.EngineConfig(max_seqs=2, page_size=64, n_pages=16, max_pages_per_seq=4,
                               prefill_chunk=32)
    prompts = [list(range(1, 40)), [5, 9, 5, 9, 5]]

    def serve(e):
        rids = [e.submit(p, max_new_tokens=6) for p in prompts]
        res = e.run()
        return [res[r] for r in rids]

    want = serve(engine.DecodeEngine(TINY, params, ecfg, device=dev))
    close = _world_of_one(backend, dev)
    try:
        mesh = make_mesh((1, 1), ("seq", "model"))
        assert mesh.process_group and mesh.device.type == "cuda"
        e = engine.DecodeEngine(TINY, params, ecfg, mesh=mesh)
        if backend == "gloo":
            with pytest.raises(RuntimeError, match="gloo"):
                e._decode_step(e._in_tokens, e._in_active)
            for name in ("_decode_step", "_spec_step", "_chunk_prefill"):
                setattr(e, name, getattr(e, name + "_impl"))
        collectives.CALLS.clear()
        assert serve(e) == want
        assert collectives.CALLS["psum"] > 0
        if backend == "nccl":
            g = next(iter(e._decode_step.graphs.values()))
            assert g.replays > 0 and g.nodes["kernels"] >= sum(g.launches.values())
    finally:
        close()


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_process_group_training_of_one_rank(dev, backend):
    """``make_sharded_train_step`` and ``ring_flash_attention`` on a
    world-size-1 group's mesh give the single-process results: three steps'
    losses and the gathered parameters after them, the ring's output.  Over
    NCCL the step and the callable are graphs with the loss's ``psum``
    inside; over gloo each refuses at the call that would capture, and its
    ``eager`` runs."""
    from tf_flash_attention_tpu_torch.parallel import collectives, mha, ring_flash_attention
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    adamw = lambda ps: torch.optim.AdamW(ps, lr=1e-3, capturable=True)
    init = ttf.init_params(TINY, torch.Generator().manual_seed(0), "cpu").to(dev)
    tokens = torch.randint(0, 64, (4, 33), generator=torch.Generator().manual_seed(1)).to(dev)
    ref = copy.deepcopy(init)
    opt = adamw(ref.parameters())
    want = torch.stack([ttf.train_step(TINY, ref, tokens, optimizer=opt) for _ in range(3)])
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((2, 4, 256, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    want_o = mha(q, k, v, rule=CausalRule())
    close = _world_of_one(backend, dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        slot = ttf.slot_params(TINY, init, mesh)
        step = ttf.make_sharded_train_step(TINY, mesh, adamw(slot.parameters()))
        ring = ring_flash_attention(make_mesh((1, 1, 1), ("data", "model", "context")),
                                    rule=CausalRule())
        if backend == "gloo":
            with pytest.raises(RuntimeError, match="gloo"):
                step(slot, tokens)
            with pytest.raises(RuntimeError, match="gloo"):
                ring(q, k, v)
            step, ring = step.eager, ring.eager
        collectives.CALLS.clear()
        got = torch.stack([step(slot, tokens) for _ in range(3)])
        assert collectives.CALLS["psum"] > 0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for a, b in zip(ttf.gather_params(TINY, slot, mesh).parameters(), ref.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        for _ in range(2):      # over NCCL the second call replays the graph
            o = ring(q, k, v)
        torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=tol_low(want_o))
        if backend == "nccl":
            assert next(iter(step.graphs.values())).replays == 2
    finally:
        close()


def _seq_caches(mesh, dev, seed, lengths=(700, 300)):
    """Two slots' prompts (bf16 K/V, int8 cache, 8 KV heads, d 128, page 64)
    written round-robin over ``mesh``'s seq axis of 4."""
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    cfg = kv_cache.KVCacheConfig(n_kv_heads=8, head_dim=128, page_size=64, n_pages=12,
                                 max_seqs=2, max_pages_per_seq=4, quantized=True,
                                 quant_dtype=torch.int8, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    caches = tsd.create_seq_sharded_cache(cfg, mesh, "seq")
    for s, t in enumerate(lengths):
        k, v = (torch.randn((8, t, 128), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        tsd.write_prompt_seq_sharded(caches, cfg, mesh, "seq", s, [range(4 * s, 4 * s + 4)] * 4,
                                     k, v)
    return cfg, caches


def test_graphed_serving_callables_key_by_cache(dev):
    """On cuda x 4 each serving callable is a ``GraphedCall``; two caches of
    one shape called in turn (A, B, A, B) each give the eager result on
    their own cache, bit for bit, from two graphs replayed once each (a
    graph keyed by shapes alone would replay A's caches for B); a prefill
    replays at another start; the appends leave each cache as eager ones
    leave a copy."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedCall
    from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                     sharded_paged_decode)

    seq = make_mesh((4,), ("seq",), [dev] * 4)
    heads = make_mesh((4,), ("model",), [dev] * 4)
    (cfg, sa), (_, sb) = _seq_caches(seq, dev, 1), _seq_caches(seq, dev, 2)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((2, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    qp = torch.randn((128, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    full = [_cache("int8", torch.bfloat16, dev, [200, 90], n_kv=8, head_dim=128, seed=s)
            for s in (4, 5)]
    ha, hb = (shard_cache_heads(c, cfg_, heads) for cfg_, c in full)
    cases = [(sharded_paged_decode(heads, full[0][0]), (q, ha), (q, hb)),
             (tsd.seq_sharded_paged_decode(seq, cfg, "seq"), (q, sa), (q, sb)),
             (tsd.seq_sharded_paged_prefill(seq, cfg, "seq"), (qp, sa, 0, 172, 128),
              (qp, sb, 0, 172, 128))]
    for fn, args_a, args_b in cases:
        assert isinstance(fn, GraphedCall)
        want = [fn.eager(*args_a), fn.eager(*args_b)]
        assert not torch.equal(want[0], want[1])
        for i, args in enumerate((args_a, args_b, args_a, args_b)):
            assert torch.equal(fn(*args), want[i % 2]), i
        assert sorted(g.replays for g in fn.graphs.values()) == [1, 1]
    prefill_fn = cases[2][0]
    assert torch.equal(prefill_fn(qp, sa, 0, 300, 128), prefill_fn.eager(qp, sa, 0, 300, 128))
    assert len(prefill_fn.graphs) == 2

    append = tsd.seq_sharded_append(seq, cfg, "seq", trash_page=cfg.n_pages - 1)
    copies = [[_clone(c) for c in s] for s in (sa, sb)]
    k_new = torch.randn((2, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    for _ in range(2):
        for caches in copies:
            append.eager(caches, k_new, -k_new, active)
        for caches in (sa, sb):
            assert append(caches, k_new, -k_new, active) is caches
    for got, want in ((sa, copies[0]), (sb, copies[1])):
        for g, w in zip(got, want):
            _same(g, w, cfg.n_pages - 1)
    assert sorted(g.replays for g in append.graphs.values()) == [1, 1]


# ---- several cards of one host: each kernel launched on its tensors' card,
# the single-controller engine graphed across four cards ----

def _needs_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards of one host")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def card1():
    """``cuda:1`` while ``cuda:0`` is the current device (two cards)."""
    _needs_cards(2)
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def _kernel_devices(fn):
    """``fn()`` under the profiler: the device of every CUDA kernel, copy
    and set it ran, by device index."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.device_index] = out.get(e.device_index, 0) + 1
    return out


# each kernel family through its public entry on ``dev``, against its plain
# version (the checks above): (run, the kernels it must launch, the route
# switches it runs under)
CARD_FAMILIES = {
    "kv_writes": (lambda dev: test_kv_writes_bit_identical(dev, True, torch.bfloat16,
                                                           torch.bfloat16),
                  {"kv_chunk_write", "kv_append"}, "auto"),
    "decode_prefill": (lambda dev: test_decode_and_prefill_match_plain(
        dev, True, torch.bfloat16, torch.bfloat16, 8), {"paged_decode", "paged_prefill"}, "auto"),
    "multitoken_decode": (lambda dev: test_multitoken_decode_matches_plain(
        dev, "int4", torch.bfloat16, torch.bfloat16, 4, 4), {"paged_multitoken_decode"}, "auto"),
    "sharded_variants": (lambda dev: test_seq_sharded_variants_match_plain(
        dev, True, torch.bfloat16, torch.bfloat16, CausalRule()),
        {"paged_decode[cp]", "paged_prefill[cp]", "kv_chunk_write[cp]"}, "auto"),
    "banded_split_qouter": (lambda dev: _run_op_case(dev, *OP_CASES["causal_1d_gqa"],
                                                     dtype=torch.bfloat16),
                            {"banded_fwd", "banded_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                             "flash_bwd_qouter"}, "auto"),
    "window": (lambda dev: _run_op_case(dev, *OP_CASES["local_stride_1d"], dtype=torch.bfloat16),
               {"window_fwd", "window_bwd"}, "auto"),
    "table": (lambda dev: _run_op_case(dev, *OP_CASES["causal_1d_ragged"], dtype=torch.float32),
              {"flash_fwd", "flash_bwd_fused"}, "table"),
    "resident": (lambda dev: _run_op_case(dev, *OP_CASES["full_1d"], dtype=torch.float16),
                 {"resident_fwd"}, "resident"),
}


@pytest.mark.parametrize("family", list(CARD_FAMILIES))
def test_kernels_launch_on_their_tensors_card(card1, monkeypatch, family):
    """Each kernel family on ``cuda:1`` while ``cuda:0`` is current: right
    against its plain version, its kernels launched, and every kernel, copy
    and set of the run on card 1 (the launch takes its tensors' device and
    that device's stream); the current device stays ``cuda:0``."""
    run, kernels, routes = CARD_FAMILIES[family]
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    native.reset_launch_counts()
    seen = _kernel_devices(lambda: run(card1))
    launched = {k for k, n in native.LAUNCHES.items() if n}
    assert kernels <= launched, launched
    assert set(seen) == {1}, seen
    assert torch.cuda.current_device() == 0


def test_launch_refuses_tensors_on_two_cards(card1):
    """A wrapper whose tensors lie on two cards raises before its launch
    and counts nothing."""
    cfg, c = _cache(True, torch.bfloat16, card1, [70, 0, 130])
    k = torch.zeros((3, 2, 32), dtype=torch.bfloat16, device="cuda:0")
    active = torch.ones(3, dtype=torch.bool, device=card1)
    native.reset_launch_counts()
    with pytest.raises(ValueError, match=r"one CUDA device.*\['cuda:0', 'cuda:1'\]"):
        native.kv_append(c, cfg, k, k, active)
    assert native.LAUNCHES["kv_append"] == 0


MULTICARD_LAYOUTS = {"tp4": ((4,), ("model",)), "cp4": ((4,), ("seq",)),
                     "tp2cp2": ((2, 2), ("model", "seq"))}
CARD_MODEL = ttf.ModelConfig(vocab=64, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                             d_head=32, d_ff=256, dtype=torch.bfloat16)


def _serve_logged(e, prompts):
    """(tokens, each admission's last prompt token's logits) of ``prompts``
    through ``e``."""
    logits, inner = [], e._prefill

    def prefill(p, slot):
        r = inner(p, slot)
        logits.append(r[0].float().cpu())
        return r

    e._prefill = prefill
    rids = [e.submit(p, max_new_tokens=8) for p in prompts]
    res = e.run()
    return [res[r] for r in rids], logits


@pytest.mark.parametrize("layout", list(MULTICARD_LAYOUTS))
def test_single_controller_engine_graphed_across_cards(layout):
    """One process driving the shards on ``cuda:0..3``: every step a graph
    over the four cards (replayed, no eager fallback), whose tokens and
    logits equal the same layout's on ``cuda:0`` four times and the eager
    steps' on the four cards bit for bit; one profiled decode step runs the
    same number of kernels on each card."""
    _needs_cards(4)
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    shape, axes = MULTICARD_LAYOUTS[layout]
    params = ttf.init_params(CARD_MODEL, torch.Generator().manual_seed(0), "cpu")
    ecfg = engine.EngineConfig(max_seqs=2, page_size=64, n_pages=16, max_pages_per_seq=4,
                               prefill_chunk=64)
    prompts = [[(7 * i + 3) % 63 + 1 for i in range(150)], [5, 9, 5, 9, 5]]
    cards = [torch.device("cuda", i) for i in range(4)]
    runs = {}
    for label, devices, graphed in (("one card", [cards[0]] * 4, True),
                                    ("four cards", cards, True),
                                    ("four cards eager", cards, False)):
        e = engine.DecodeEngine(CARD_MODEL, params, ecfg, mesh=make_mesh(shape, axes, devices))
        if not graphed:
            for name in ("_decode_step", "_spec_step", "_chunk_prefill"):
                setattr(e, name, getattr(e, name + "_impl"))
        runs[label] = _serve_logged(e, prompts)
        if label == "four cards":
            g = next(iter(e._decode_step.graphs.values()))
            assert g.devices[0] == cards[0] and set(g.devices) == set(cards)
            assert g.replays > 0
            assert next(iter(e._chunk_prefill.graphs.values())).replays > 0
            e.submit(prompts[0], max_new_tokens=4)
            e.step()
            per_card = _kernel_devices(e.step)
            assert set(per_card) == {0, 1, 2, 3}, per_card
    want_tokens, want_logits = runs["one card"]
    for label in ("four cards", "four cards eager"):
        tokens, logits = runs[label]
        assert tokens == want_tokens, label
        for a, b in zip(logits, want_logits):
            assert torch.equal(a, b), label


def _churn(cards):
    """A block of NaNs filling a quarter of each of ``cards``' free memory,
    kept while the caller replays: memory freed into the allocator's cache
    on those cards is overwritten."""
    out = []
    for d in cards:
        free, _ = torch.cuda.mem_get_info(d)
        out.append(torch.full((free // 16,), float("nan"), device=d))
    return out


def _kernels_by_card(fn, names):
    """``fn()`` under the profiler: {kernel name: {device index: count}} of
    the CUDA kernels whose names hold one of ``names``' entries."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                by = out.setdefault(name, {})
                by[e.device_index] = by.get(e.device_index, 0) + 1
    return out


@pytest.mark.parametrize("n_cards", [2, 4])
@pytest.mark.parametrize("layout", ["tp2", "cp4", "moe", "pipeline"])
def test_graphed_train_step_across_cards(layout, n_cards):
    """One process over ``cuda:0..n_cards-1`` (the mesh's slots on the cards
    in turn): the factory's step is one graph across the cards, the
    backward run in the capturing thread.  Three graphed steps (the first
    eager, then the capture; two replays, the second with the other cards'
    free memory filled with NaNs) against three eager steps on the same
    cards from the same weights: the tolerances of the one-card test; the
    graph holds the wrappers' launches and the copies between the cards,
    and a profiled replay runs kernels on every card."""
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedTrainStep

    _needs_cards(n_cards)
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    make = _graphed_train_case(cards[0], layout, cards)
    tokens = torch.randint(0, 64, (4, 33), generator=torch.Generator().manual_seed(1)
                           ).to(cards[0])
    runs = []
    for graphed in (False, True):
        params, step = make()
        assert isinstance(step, GraphedTrainStep)
        assert tuple(s.device for s in step.streams) == tuple(cards)
        native.reset_launch_counts()
        losses = []
        for i in range(3):
            junk = _churn(cards[1:]) if graphed and i == 2 else []
            losses.append((step if graphed else step.eager)(params, tokens))
            for d in cards:
                torch.cuda.synchronize(d)
            del junk
        grads = [p.grad.clone() for p in params.parameters() if p.grad is not None]
        runs.append((torch.stack(losses), grads))
    (want, want_g), (got, got_g) = runs
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert len(got_g) == len(want_g)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    g = next(iter(step.graphs.values()))
    assert g.devices == tuple(cards) and g.replays == 2
    assert g.nodes["kernels"] >= sum(g.launches.values()) > 0 and g.nodes["copies"] > 0
    assert set(g.pool_by_device) == {str(d) for d in cards}
    seen = _kernel_devices(lambda: step(params, tokens))
    assert set(seen) == set(range(n_cards)), seen


CARD_CALLABLES = {"ring": ((1, 1, 4), "context"), "ulysses": ((1, 1, 4), "context"),
                  "sharded": ((2, 2, 1), "model")}


@pytest.mark.parametrize("kind", list(CARD_CALLABLES))
def test_graphed_callables_across_cards(kind):
    """The ring, Ulysses (context 4) and sharded (data 2 x model 2)
    callables over ``cuda:0..3``, bf16: a forward and a backward graph each
    across the four cards, the replays' output and gradients within 2 ulps
    of the eager call's on the same cards, every card running attention
    kernels in a profiled forward and backward replay, their count over
    the cards the graphs' wrapper launches."""
    from tf_flash_attention_tpu_torch.parallel import (make_mesh, ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedFunction

    _needs_cards(4)
    cards = [torch.device("cuda", i) for i in range(4)]
    shape, _ = CARD_CALLABLES[kind]
    mesh = make_mesh(shape, ("data", "model", "context"), cards)
    fn = {"ring": lambda: ring_flash_attention(mesh, rule=CausalRule()),
          "ulysses": lambda: ulysses_flash_attention(mesh, CausalRule()),
          "sharded": lambda: sharded_flash_attention(mesh, CausalRule())}[kind]()
    assert isinstance(fn, GraphedFunction)
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    q, k, v, do = (torch.randn((2, 4, 1024, 64), generator=gen, device=cards[0])
                   .to(torch.bfloat16) for _ in range(4))

    def run(f):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = f(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do)]

    want = run(fn.eager)
    run(fn)
    junk = _churn(cards[1:])
    got = run(fn)
    del junk
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol_low(b))
    sig = next(iter(fn.graphs.values()))
    for g in (sig.fwd, sig.bwd):
        assert g.devices == tuple(cards) and g.replays == 1
        assert g.nodes["kernels"] >= sum(g.launches.values()) > 0 and g.nodes["copies"] > 0
    # the tensor-core bodies by their symbols, and every wrapper that
    # launches each (a ring visit takes the route of its block's schedule)
    bodies = {"fwd_tc_kernel": ("banded_fwd", "flash_fwd", "window_fwd", "resident_fwd"),
              "bwd_tc_kernel": ("banded_bwd", "flash_bwd_fused", "window_bwd", "flash_bwd_dkv")}
    seen = _kernels_by_card(lambda: run(fn), list(bodies))
    for body, kernels in bodies.items():
        by = seen.get(body, {})
        launched = sum(g.launches.get(k, 0) for g in (sig.fwd, sig.bwd) for k in kernels)
        assert set(by) == {0, 1, 2, 3} and sum(by.values()) == launched > 0, (body, by)
    assert sig.fwd.launches.get("banded_fwd") and sig.bwd.launches.get("banded_bwd")
