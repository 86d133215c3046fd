"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests need a card and skip
elsewhere.  Run them on the GPU with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.serving import decode, engine, kv_cache, prefill

pytestmark = pytest.mark.cuda

TOL_F32 = 1e-5   # float32 throughout: summation order only
TOL_LOW = 1e-2   # bf16 outputs or bf16-rounded p: a bf16 ulp at |o| ~ 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cache(quantized, dtype, dev, lengths, n_kv=2, head_dim=32, seed=0):
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=head_dim, page_size=64,
                                 n_pages=4 * len(lengths) + 2, max_seqs=len(lengths), max_pages_per_seq=4,
                                 quantized=quantized, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = kv_cache.PagedKVCache.create(cfg, dev)
    for p in (c.k_pages, c.v_pages):
        if quantized:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
        else:
            x = torch.rand(p.shape, generator=gen, device=dev) * 2 - 1
            x[..., head_dim:] = 0
            p.copy_(x)
    if quantized:
        for s in (c.k_scales, c.v_scales):
            s.copy_(0.005 + 0.015 * torch.rand(s.shape, generator=gen, device=dev))
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
            assert torch.equal(x[:, :trash], y[:, :trash]), name
    assert torch.equal(a.lengths, b.lengths)


CASES = [(True, torch.float32, torch.float32), (True, torch.bfloat16, torch.bfloat16),
         (False, torch.float32, torch.float32), (False, torch.bfloat16, torch.bfloat16)]
CASE_IDS = ["int8-f32", "int8-bf16", "f32", "bf16"]


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
    tol = TOL_F32 if act == kvdt == torch.float32 and not quantized else TOL_LOW
    q = torch.randn((4, n_q, 32), generator=gen, device=dev).to(act)
    o = decode.paged_decode_attention(q, c, cfg)
    ref = decode._paged_decode_plain(q, c, cfg, 32 ** -0.5, CausalRule())
    torch.testing.assert_close(o.float(), ref.float(), rtol=0, atol=tol)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    qp = torch.randn((40, n_q, 32), generator=gen, device=dev).to(act)
    o = prefill.paged_prefill_attention(qp, c, cfg, 0, 110, 33)
    qs = (qp.float() * torch.tensor(32 ** -0.5 * 1.4426950408889634)).to(act)
    ref = prefill._paged_prefill_plain(qs, c, cfg, 0, 110, 33, CausalRule())
    torch.testing.assert_close(o[:33].float(), ref[:33].float(), rtol=0, atol=tol)


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


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_on_gpu_matches_cpu(dev, quantized):
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.float32)
    ecfg = engine.EngineConfig(max_seqs=3, page_size=64, n_pages=32, max_pages_per_seq=4,
                               prefill_chunk=64, quantized_kv=quantized)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 64, n)] for n in (100, 5, 70)]
    outs = []
    for where in ("cpu", dev):
        e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0)),
                                ecfg, device=where)
        rids = [e.submit(p, max_new_tokens=8) for p in prompts]
        native.reset_launch_counts()
        res = e.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    assert min(native.LAUNCHES.values()) > 0


def test_engine_sampling_on_gpu(dev):
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams
    cfg = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, dtype=torch.bfloat16)
    e = engine.DecodeEngine(cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0)),
                            engine.EngineConfig(max_seqs=2, page_size=64, n_pages=8,
                                                max_pages_per_seq=4, prefill_chunk=64,
                                                seed=5), device=dev)
    g = e.submit([1, 2, 3], max_new_tokens=6)
    s = e.submit([1, 2, 3], max_new_tokens=6,
                 sampling=SamplingParams(temperature=1.0, top_k=8, top_p=0.9))
    out = e.run()
    assert len(out[g]) == len(out[s]) == 9
    assert all(0 <= t < 64 for t in out[s])
