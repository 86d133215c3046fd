"""The port's paged prefill attention against the JAX kernel, on the CPU.

The JAX side runs its Pallas prefill kernel in interpret mode; the port
runs its plain PyTorch version.  Rows past ``true_len`` are padding and
are compared by neither side's contract.  ``quantized`` is False
(unquantized), True (int8) or a payload name (fp8 e4m3, e5m2, int4).
"""

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import prefill as jpre
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.serving import prefill as tpre

from _torch_parity import cache_cfgs, caches_from, one_torch_thread, random_state

# many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_F32 = 2e-5   # float32, unquantized cache: summation order only
TOL_INT8 = 1e-3  # int8 cache: a bf16-rounded p element may round the other way
TOL_Q = 2e-3     # fp8/int4: the same, at outputs up to ~2.5 (fp8 spans its range)
QUANTIZED = [False, True, "e4m3", "e5m2", "int4"]


def _run(quantized, start, chunk, true_len, n_q=4, rules=(None, None), seed=0, page_size=64,
         max_pages=4):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_cfgs(quantized, page_size=page_size, max_pages_per_seq=max_pages,
                            n_pages=3 * max_pages + 4)
    jc, tc = caches_from(random_state(tcfg, rng, [0, start + true_len, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (chunk, n_q, 32)).astype(np.float32)
    jkw = {} if rules[0] is None else {"rule": rules[0]}
    tkw = {} if rules[1] is None else {"rule": rules[1]}
    want = np.asarray(jpre.paged_prefill_attention(q, jc, jcfg, 1, start, true_len,
                                                   interpret=True, **jkw))
    got = tpre.paged_prefill_attention(torch.from_numpy(q), tc, tcfg, 1, start,
                                       true_len, **tkw).numpy()
    return got[:true_len], want[:true_len]


# start > 0 is a cached prefix; true_len < chunk leaves padding rows
@pytest.mark.parametrize("quantized", QUANTIZED)
@pytest.mark.parametrize("start,chunk,true_len", [(0, 64, 64), (70, 48, 40), (128, 96, 77)])
def test_paged_prefill_matches_jax(quantized, start, chunk, true_len):
    got, want = _run(quantized, start, chunk, true_len)
    tol = TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_paged_prefill_gqa_8_to_2():
    got, want = _run(False, 100, 32, 32, n_q=8, seed=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("quantized", ["e4m3", "int4"])
def test_paged_prefill_gqa_8_to_2_quantized(quantized):
    got, want = _run(quantized, 100, 32, 31, n_q=8, seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_Q)


@pytest.mark.parametrize("w,s", [(32, 0), (8, 2)])
def test_paged_prefill_local_rule(w, s):
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 150, 48, 40, rules=rules, seed=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


# pages smaller than the kernel's 32-key sub-tile, and a ragged last
# sub-tile: every page size the JAX engine takes
@pytest.mark.parametrize("quantized", [False, True, "int4"])
@pytest.mark.parametrize("page_size", [8, 16, 48])
def test_paged_prefill_small_pages_match_jax(quantized, page_size):
    got, want = _run(quantized, 70, 48, 40, seed=4, page_size=page_size,
                     max_pages=-(-110 // page_size))
    tol = TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---- the tensor-core body (csrc/prefill_tc.cuh): its rule, its shared
# memory, and its merge once a 64-key stage against the reference's once a
# page ----

from tf_flash_attention_tpu_torch import native  # noqa: E402
from tf_flash_attention_tpu_torch.mask_rules import CausalRule  # noqa: E402
from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E  # noqa: E402
from tf_flash_attention_tpu_torch.serving import decode as tdec  # noqa: E402
from tf_flash_attention_tpu_torch.serving.kv_cache import (  # noqa: E402
    KVCacheConfig, PagedKVCache, _quant_max)

# cache payloads by name: the quant_dtype, or None for an unquantized bf16 cache
PAYLOADS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
            "int4": "int4", "bf16": None}


def _cfg(payload, **kw):
    qd = PAYLOADS[payload]
    return KVCacheConfig(quantized=qd is not None, quant_dtype=torch.int8 if qd is None else qd,
                         dtype=torch.bfloat16, **kw)


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("act,head_dim,page,body", [
    (torch.bfloat16, 128, 64, "tensor-core"), (torch.bfloat16, 128, 256, "tensor-core"),
    (torch.bfloat16, 96, 512, "tensor-core"), (torch.bfloat16, 128, 192, "tensor-core"),
    (torch.bfloat16, 128, 32, "scalar"), (torch.bfloat16, 128, 16, "scalar"),
    (torch.bfloat16, 128, 48, "scalar"), (torch.bfloat16, 384, 256, "scalar"),
    (torch.float32, 128, 256, "scalar")])
def test_prefill_body(payload, act, head_dim, page, body):
    """``paged_prefill`` runs the tensor-core body on bf16 activations at
    head_dim_store 128 (head_dim 96 pads to it) on pages of a multiple of 64
    tokens, for every payload; float32 activations, other stored widths
    (384) and pages of 8-48 tokens run the scalar body."""
    cfg = _cfg(payload, n_kv_heads=2, head_dim=head_dim, page_size=page)
    assert native.prefill_body(act, cfg) == body


def test_prefill_tc_shared_memory():
    """The tensor-core prefill's shared memory, pinned to the C
    ``tc::kPfSmem``: 1 KB of alignment, 16 KB of Q (64 rows), two 64-key
    stages of bf16 K and V (32 KB each), raw payload rows (16 KB) and
    scales (512 B), six barriers (the scalar body's guard at page 512 fits
    too)."""
    assert native.PREFILL_TC_SMEM == 116784 <= native.MAX_SMEM
    assert native.prefill_smem(128, 512) <= native.MAX_SMEM


def _card_cache(payload, page_size, n_kv, mapped, seed):
    """A bf16-activation cache filled as ``chip_smoke.py`` fills the card's:
    quantized payloads over their type's range, scales that bring every
    payload to int8's size, an unquantized cache N(0, 1); slot 0 maps
    ``mapped`` random pages."""
    gen = torch.Generator().manual_seed(seed)
    cfg = _cfg(payload, n_kv_heads=n_kv, head_dim=128, page_size=page_size,
               n_pages=mapped + 3, max_seqs=2, max_pages_per_seq=mapped)
    cache = PagedKVCache.create(cfg, "cpu")
    for pages in (cache.k_pages, cache.v_pages):
        if cfg.is_int4:
            pages.copy_(torch.randint(-128, 128, pages.shape, generator=gen))
        elif payload == "int8":
            pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen))
        elif cfg.quantized:
            qmax = _quant_max(cfg.quant_dtype)
            pages.copy_((torch.randn(pages.shape, generator=gen) * (qmax / 8)).clamp(-qmax, qmax))
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen))
    if cfg.quantized:
        unit = 127.0 / _quant_max(cfg.quant_dtype)
        for sc in (cache.k_scales, cache.v_scales):
            sc.copy_((0.005 + 0.02 * torch.rand(sc.shape, generator=gen)) * unit)
    cache.page_tables[0] = torch.randperm(cfg.n_pages - 1, generator=gen)[:mapped].int()
    return cache, cfg


def _stage_merge(state, s, v, vs, cdt):
    """The tensor-core body's merge: the reference's page step once every
    64-key stage of the page."""
    step = native.PREFILL_STAGE_KEYS
    for j in range(0, s.shape[-1], step):
        state = tdec._softmax_page(state, s[..., j:j + step], v[..., j:j + step, :],
                                   None if vs is None else vs[..., j:j + step], cdt)
    return state


def _page_merge_reordered(state, s, v, vs, cdt):
    """The reference's page merge (one maximum a page, so the same bf16 P) with
    l and P V summed a 64-key stage at a time: what a kernel that merges once
    a page would differ from the reference by (float32 order only)."""
    m, l, _ = state
    m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    zero = (l[..., :0].sum(dim=-1, keepdim=True), state[2] * 0)
    step = native.PREFILL_STAGE_KEYS
    l_add, pv = zero
    for j in range(0, s.shape[-1], step):
        # the page's maximum on each stage: the stage adds its p to l and P V
        _, l_j, pv_j = tdec._softmax_page((m_next, zero[0], zero[1]), s[..., j:j + step],
                                          v[..., j:j + step, :],
                                          None if vs is None else vs[..., j:j + step], cdt)
        l_add, pv = l_add + l_j, pv + pv_j
    alpha = torch.exp2(m - m_next)
    return m_next, alpha * l + l_add, state[2] * alpha + pv


def stage_merge_fractions(payload, page_size, rule=CausalRule(), stride=1, offset=0, seed=0,
                          start=640, chunk=128, merge=_stage_merge):
    """``merge``'s largest differences from the reference's page merge, each
    as a fraction of the card's gate: ``o`` (bf16, the kernel's output)
    within 2 bf16 ulps at the output's scale, l within 1e-5 relative, m
    within 1e-5 x max(1, |m|); ``o_f32`` is o's difference before its
    rounding to bf16 against the same gate.  A chunk of ``chunk`` rows at
    ``start`` of slot 0, GQA 8/2, D 128; a shard's pages of ``stride`` from
    ``offset``, key positions global."""
    total = start + chunk
    cache, cfg = _card_cache(payload, page_size, 2, -(-(-(-total // page_size)) // stride),
                             seed)
    gen = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((chunk, 8, 128), generator=gen).to(torch.bfloat16)
    # q prescaled and rounded to bf16, held in float32: the plain version's
    # arithmetic is the same, and its o stays float32
    qs = (q.float() * torch.tensor(128 ** -0.5 * LOG2E)).to(torch.bfloat16).float()
    args = (qs, cache, cfg, tpre.prefill_meta(cfg, 0, start, chunk, rule, stride)[offset], rule,
            True, stride)
    want = tpre._paged_prefill_plain(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpre, "_softmax_page", merge)
        got = tpre._paged_prefill_plain(*args)
    (o, l, m), (wo, wl, wm) = got, want
    assert torch.isfinite(o).all()
    assert torch.equal(wl == 0, l == 0)
    ob, wob = (x.to(torch.bfloat16).float() for x in (o, wo))
    gate = 2 * 2.0 ** -8 * float(wob.abs().max())
    return dict(
        o=float((ob - wob).abs().max()) / gate, o_f32=float((o - wo).abs().max()) / gate,
        l=float(((l - wl).abs() / wl.clamp_min(1e-30)).max()) / 1e-5,
        m=float(((m - wm).abs() / wm.abs().clamp_min(1.0)).max()) / 1e-5)


def _assert_within_gate(fractions):
    """Within every gate, and o before its rounding within half of it: below
    one bf16 ulp of the output's largest binade (2^-8 of its scale at least),
    so the rounded outputs differ by at most one ulp wherever the data
    puts them."""
    assert max(fractions.values()) <= 1.0 and fractions["o_f32"] <= 0.5, fractions


@pytest.mark.parametrize("page_size", [64, 256, 512])
@pytest.mark.parametrize("payload", list(PAYLOADS))
def test_stage_merge_within_card_gate(payload, page_size):
    """The tensor-core body merges once a 64-key stage where the reference
    merges once a page, so it rounds P = bf16(p x V scale) against the
    stage's maximum: the plain version with that merge stays within the
    card's gates of the plain version itself, for every payload and page
    size (causal, a 128-row chunk at 640, GQA 8/2, D 128)."""
    _assert_within_gate(stage_merge_fractions(payload, page_size))


@pytest.mark.parametrize("payload,page_size,rule,stride,offset", [
    ("int8", 256, CausalRule(), 4, 1), ("int4", 512, CausalRule(), 2, 1),
    ("e5m2", 64, CausalRule(), 4, 3), ("bf16", 256, CausalRule(), 2, 0),
    ("int8", 64, LocalRule(300, 0, True), 1, 0), ("e4m3", 64, LocalRule(200, 1, True), 1, 0)])
def test_stage_merge_within_card_gate_cp_and_window(payload, page_size, rule, stride, offset):
    """The same in the sequence-sharded form (a shard's pages of a stride,
    global key positions) and in local windows."""
    _assert_within_gate(stage_merge_fractions(payload, page_size, rule, stride, offset, seed=7))



def stage_merge_sweep(seeds=range(8), workers=4):
    """The largest fraction of each gate over ``seeds``, for every payload at
    pages 256 and 512 (at 64 a stage is a page), of the stage merge and of
    the page merge in another float32 order: a 128-row chunk at 640, phase
    3e's 512-row chunk at 12,288 and one at 15,488 (16k keys), flat and as
    each of 4 shards, causal and in a window of 1,024."""
    import concurrent.futures
    import itertools
    cases = [(merge, p, ps, rule, stride, offset, seed, start, chunk)
             for merge, p, ps, seed in itertools.product(("stage", "page"), PAYLOADS, (256, 512),
                                                         seeds)
             for start, chunk in ((640, 128), (12288, 512), (15488, 512))
             for rule, stride, offset in [(CausalRule(), 1, 0), (LocalRule(1024, 0, True), 1, 0)]
             + [(CausalRule(), 4, r) for r in range(4) if start > 640]]
    worst = {}
    with concurrent.futures.ProcessPoolExecutor(workers) as pool:
        for case, f in zip(cases, pool.map(_sweep_case, cases)):
            key = case[:3] + (case[7],)
            for gate, x in f.items():
                if x > worst.get(key + (gate,), (-1.0,))[0]:
                    worst[key + (gate,)] = (x, case[6], type(case[3]).__name__, case[4], case[5])
    return len(cases), worst


def _sweep_case(case):
    merge, p, ps, rule, stride, offset, seed, start, chunk = case
    torch.set_num_threads(2)
    return stage_merge_fractions(p, ps, rule, stride, offset, seed, start, chunk,
                                 _stage_merge if merge == "stage" else _page_merge_reordered)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_prefill.py (from the repo
    # root): one line a (merge, payload, page, chunk start, gate) with the
    # largest fraction and the case that reached it (seed, rule, stride,
    # offset), then each merge's largest fraction of each gate
    import json
    n_cases, worst = stage_merge_sweep()
    print(f"{n_cases} cases")
    for key, v in sorted(worst.items()):
        print(json.dumps(dict(merge=key[0], payload=key[1], page=key[2], start=key[3],
                              gate=key[4], fraction=v[0], seed=v[1], rule=v[2], stride=v[3],
                              offset=v[4])))
    for merge in ("stage", "page"):
        print(merge, "merge, largest fraction:", json.dumps(
            {g: max(v[0] for k, v in worst.items() if k[0] == merge and k[4] == g)
             for g in ("o", "o_f32", "l", "m")}))
