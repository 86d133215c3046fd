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
    assert min(native.LAUNCHES[k] for k in native.SERVING_KERNELS) > 0


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
    a GQA group of 4 at the same width."""
    for var, val in ROUTES[routes].items():
        monkeypatch.setenv(var, val)
    _run_op_case(dev, CausalRule(), "none_front", (2048,), (2048,), 128, 128, 64, 1,
                 torch.bfloat16)
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
