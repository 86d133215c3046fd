"""The port's paged decode attention against the JAX kernel, on the CPU.

The JAX side runs its Pallas decode kernel in interpret mode; the port
runs its plain PyTorch version (its CUDA kernel is checked against that
version on the card by ``chip_smoke.py``).  Single-token decode and
multi-token (speculative verification) decode, on every payload:
``quantized`` is False (unquantized), True (int8) or a payload name.
"""

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import decode as jdec
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.serving import decode as tdec

from _torch_parity import cache_cfgs, caches_from, one_torch_thread, random_state

# the split-merge models are many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 with an unquantized cache: only the summation order differs
TOL_F32 = 2e-5
# int8 cache: both round q, K, V and p to bf16 before the products; a p
# element whose float32 value differs in the last bit may round to the
# neighbouring bf16 value (2**-8 relative), which moves o by far less
TOL_INT8 = 1e-3
# fp8 and int4 caches: the same bf16 rounding, at outputs up to ~2.5 (the
# random fp8 payloads span the type's range); int4 sums its page as two
# halves in the reference, in token order here
TOL_Q = 2e-3
QUANTIZED = [False, True, "e4m3", "e5m2", "int4"]


def _tol(quantized):
    return TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q


def _run(quantized, n_q, lengths, rule_pair=(None, None), seed=0, gamma=None,
         page_size=64):
    """gamma None: single-token decode; else multi-token decode of gamma rows."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_cfgs(quantized, max_pages_per_seq=4, page_size=page_size)
    jc, tc = caches_from(random_state(tcfg, rng, lengths), jcfg, tcfg)
    shape = (len(lengths), n_q, 32) if gamma is None else (len(lengths), gamma, n_q, 32)
    q = rng.uniform(-1, 1, shape).astype(np.float32)
    jkw = {} if rule_pair[0] is None else {"rule": rule_pair[0]}
    tkw = {} if rule_pair[1] is None else {"rule": rule_pair[1]}
    jfn, tfn = ((jdec.paged_decode_attention, tdec.paged_decode_attention) if gamma is None
                else (jdec.paged_multitoken_decode, tdec.paged_multitoken_decode))
    want = np.asarray(jfn(q, jc, jcfg, interpret=True, **jkw))
    got = tfn(torch.from_numpy(q), tc, tcfg, **tkw).numpy()
    return got, want


# GQA (4 q / 2 kv heads), lengths off page multiples, one on a page
# boundary, and an empty slot; int4 at an odd length masks the last byte
# row's high nibble by position
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_paged_decode_matches_jax(quantized):
    got, want = _run(quantized, 4, [151, 64, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)      # empty slot: exact zeros


# gamma 1 to 4 drafts per slot, GQA 4/2, every payload; lengths count the
# drafts, one slot is empty
@pytest.mark.parametrize("gamma", [1, 2, 3, 4])
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_multitoken_decode_matches_jax(quantized, gamma):
    got, want = _run(quantized, 4, [151, 66, 0], seed=10 + gamma, gamma=gamma)
    assert got.shape == (3, gamma, 4, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("n_q", [2, 8])
def test_multitoken_decode_group_sizes(n_q):
    got, want = _run("int8", n_q, [1 + 3, 255, 97], seed=n_q, gamma=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8)


@pytest.mark.parametrize("quantized", [False, "int4"])
def test_multitoken_gamma_1_is_single_token_decode(quantized):
    rng = np.random.default_rng(7)
    jcfg, tcfg = cache_cfgs(quantized)
    _, tc = caches_from(random_state(tcfg, rng, [150, 3, 0]), jcfg, tcfg)
    q = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 32)).astype(np.float32))
    np.testing.assert_array_equal(
        tdec.paged_multitoken_decode(q[:, None], tc, tcfg)[:, 0].numpy(),
        tdec.paged_decode_attention(q, tc, tcfg).numpy())


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2)])
def test_multitoken_decode_local_rule(w, s):
    # the oldest draft row (at length - gamma) sets the first live page
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 4, [200, 90, 0], rules, seed=6, gamma=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("n_q", [2, 8])
def test_paged_decode_group_sizes(n_q):
    got, want = _run(False, n_q, [1, 255, 97], seed=n_q)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2)])
def test_paged_decode_local_rule(w, s):
    # window rules skip the pages below the oldest row's window
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 4, [200, 90, 0], rules, seed=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


def test_first_live_page_and_visibility_match_jax():
    lengths = np.array([0, 1, 63, 64, 65, 300], np.int32)
    for jr, tr in ((JLocalRule(8, 0, True), LocalRule(8, 0, True)),
                   (JLocalRule(4, 3, True), LocalRule(4, 3, True))):
        for gamma in (1, 4):
            want = np.asarray(jdec._first_live_page(jr, lengths, gamma, 64))
            got = tdec._first_live_page(tr, torch.from_numpy(lengths), gamma, 64).numpy()
            np.testing.assert_array_equal(got, want)
        q_pos, kv_pos = np.arange(70)[:, None], np.arange(70)[None, :]
        np.testing.assert_array_equal(
            tdec._rule_visible(tr, torch.from_numpy(q_pos), torch.from_numpy(kv_pos)).numpy(),
            np.asarray(jdec._rule_visible(jr, q_pos, kv_pos)))


def test_cpu_tensors_take_the_plain_version():
    from tf_flash_attention_tpu_torch import native
    before = dict(native.LAUNCHES)
    _run(False, 4, [10, 0, 0])
    _run("int4", 4, [10, 0, 0], gamma=2)
    assert native.LAUNCHES == before


# more than 16 query rows per kv head (GQA 8 at gamma 4, MQA 32/1) and a
# stored width above 256 (head_dim 320 stores 384): the CUDA kernel takes
# them in groups of rows; the plain version and JAX take them whole
@pytest.mark.parametrize("n_q,n_kv,gamma,head_dim,quantized",
                         [(16, 2, 4, 320, True), (32, 1, 1, 384, False), (32, 1, 2, 128, "int4")])
def test_decode_many_rows_and_wide_heads_match_jax(n_q, n_kv, gamma, head_dim, quantized):
    rng = np.random.default_rng(n_q + gamma)
    jcfg, tcfg = cache_cfgs(quantized, n_kv=n_kv, head_dim=head_dim, max_pages_per_seq=4)
    assert tcfg.head_dim_store == -(-head_dim // 128) * 128
    jc, tc = caches_from(random_state(tcfg, rng, [151, 70, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (3, gamma, n_q, head_dim)).astype(np.float32)
    want = np.asarray(jdec.paged_multitoken_decode(q, jc, jcfg, interpret=True))
    got = tdec.paged_multitoken_decode(torch.from_numpy(q), tc, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)


# ---- the tensor-core decode body's arithmetic (csrc/decode_tc.cuh) ----

from tf_flash_attention_tpu_torch import native  # noqa: E402
from tf_flash_attention_tpu_torch.mask_rules import CausalRule  # noqa: E402
from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E, NEG_INF_F32  # noqa: E402
from tf_flash_attention_tpu_torch.serving.kv_cache import (  # noqa: E402
    KVCacheConfig, PagedKVCache, _page_tokens, _quant_max)

# cache payloads by name: the quant_dtype, or None for an unquantized bf16 cache
PAYLOADS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
            "int4": "int4", "bf16": None}


def _card_cfg(payload, page_size, n_kv, max_pages, max_seqs, n_pages=None):
    qd = PAYLOADS[payload]
    return KVCacheConfig(n_kv_heads=n_kv, head_dim=128, page_size=page_size,
                         n_pages=n_pages or max_seqs * max_pages + 1, max_seqs=max_seqs,
                         max_pages_per_seq=max_pages, quantized=qd is not None,
                         quant_dtype=torch.int8 if qd is None else qd, dtype=torch.bfloat16)


def _card_cache(payload, page_size, n_kv, lengths, seed):
    """bf16-activation caches filled as ``chip_smoke.py`` fills the card's
    (quantized payloads over their type's range, scales that bring each to
    int8's size, an unquantized cache N(0, 1)), every slot's pages mapped at
    random, and the same global sequences cut into 4 shards (global page
    j on shard j % 4): ``(flat, shards)``, each a (cache, cfg, global
    lengths or None)."""
    gen = torch.Generator().manual_seed(seed)
    S, mp = len(lengths), max(1, -(-max(lengths) // page_size))
    cfg = _card_cfg(payload, page_size, n_kv, mp, S)
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
    cache.page_tables.copy_(torch.randperm(cfg.n_pages - 1, generator=gen)[:S * mp]
                            .reshape(S, mp).int())
    glob = torch.tensor(lengths, dtype=torch.int32)
    cache.lengths.copy_(glob)
    shards = []
    smp = -(-mp // 4)
    for r in range(4):
        scfg = _card_cfg(payload, page_size, n_kv, smp, S, n_pages=cfg.n_pages)
        table = torch.zeros((S, smp), dtype=torch.int32)
        own = cache.page_tables[:, r::4]
        table[:, :own.shape[1]] = own
        local = torch.tensor([sum(min(page_size, max(0, n - gp * page_size))
                                  for gp in range(r, mp, 4)) for n in lengths], dtype=torch.int32)
        shards.append((PagedKVCache(cache.k_pages, cache.v_pages, cache.k_scales,
                                    cache.v_scales, table, local), scfg, glob))
    return (cache, cfg, None), shards


def split_merge_model(q, cache, cfg, rule, page_stride=1, page_offset=0, global_lengths=None):
    """A float32 model of the tensor-core decode's arithmetic (the plain
    version's reference step, ``_softmax_page``, in the kernel's order):
    q (S, gamma, n_q, d) bf16 values in float32.  Each slot's live pages are
    cut into ``native.decode_plan``'s runs; a run merges once every
    ``native.decode_merge_keys`` keys (a page or a 64-key stage) from a fresh
    state, rounding P = bf16(p x V scale) against its own running maximum;
    the runs' (acc, m, l) then merge in run order.  Returns o (float32, before
    the output's rounding), l and m, (S, gamma, n_q)."""
    S, gamma, n_q, d = q.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g, rows = n_q // n_kv, n_q // n_kv * gamma
    plan = native.decode_plan(S, n_q, gamma, cfg)
    merge = native.decode_merge_keys(ps, min(rows, native.DECODE_CTA_ROWS))
    cdt = torch.bfloat16 if cfg.quantized else cache.k_pages.dtype
    qg = q.reshape(S, gamma, n_kv, g, d).permute(0, 2, 3, 1, 4).reshape(S, n_kv, rows, d)
    qg = torch.nn.functional.pad(qg, (0, D - d)).to(cdt).float()
    c = torch.tensor(128 ** -0.5 * LOG2E, dtype=torch.float32) if d == 128 else \
        torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    lengths = cache.lengths.long()
    glob = lengths if global_lengths is None else global_lengths.long()
    firsts = tdec._first_live_page(rule, glob, gamma, ps, page_stride, page_offset)
    per_unit = 1 if ps >= native.DECODE_STAGE_KEYS else native.DECODE_STAGE_KEYS // ps
    o = torch.zeros((S, n_kv, rows, D))
    l = torch.zeros((S, n_kv, rows, 1))
    m = torch.full((S, n_kv, rows, 1), NEG_INF_F32)
    for b in range(S):
        count, first = -(-int(lengths[b]) // ps), int(firsts[b])
        units = -(-max(0, count - first) // per_unit)
        per = -(-units // plan["splits"])
        q_pos = int(glob[b]) - gamma + torch.arange(rows) % gamma
        parts = []
        for run in range(-(-units // per) if per else 0):
            lps = range(first + run * per * per_unit, min(first + (run + 1) * per * per_unit,
                                                         count))
            phys = cache.page_tables[b, [lp % mp for lp in lps]].long()
            kv = [_page_tokens(pages[:, phys], None if sc is None else sc[:, phys], cfg)
                  for pages, sc in ((cache.k_pages, cache.k_scales),
                                    (cache.v_pages, cache.v_scales))]
            (k, ks), (v, vs) = ((x.reshape(n_kv, -1, D).to(cdt).float(),
                                 None if s is None else s.reshape(n_kv, -1)) for x, s in kv)
            kv_pos = torch.cat([(lp * page_stride + page_offset) * ps + torch.arange(ps)
                                for lp in lps])
            state = (torch.full((n_kv, rows, 1), NEG_INF_F32), torch.zeros((n_kv, rows, 1)),
                     torch.zeros((n_kv, rows, D)))
            for j in range(0, kv_pos.numel(), merge):
                sl = slice(j, j + merge)
                s = qg[b] @ k[:, sl].transpose(-1, -2)
                s = s * (ks[:, None, sl] * c) if cfg.quantized else s * c
                vis = tdec._rule_visible(rule, q_pos[:, None], kv_pos[None, sl])
                s = s.masked_fill(~vis, NEG_INF_F32)
                state = tdec._softmax_page(state, s, v[:, sl],
                                           None if vs is None else vs[:, None, sl], cdt)
            parts.append(state)
        if parts:
            M = torch.stack([p[0] for p in parts]).amax(dim=0)
            L, O = torch.zeros_like(M), torch.zeros_like(o[b])
            for pm, pl, pacc in parts:
                f = torch.exp2(pm - M)
                L, O = L + pl * f, O + pacc * f
            o[b] = O / torch.where(L == 0.0, torch.ones_like(L), L)
            l[b], m[b] = L, M

    def split(x):     # (S, n_kv, rows, w) -> (S, gamma, n_q, w)
        w = x.shape[-1]
        return x.reshape(S, n_kv, g, gamma, w).permute(0, 3, 1, 2, 4).reshape(S, gamma, n_q, w)

    return split(o[..., :d]), split(l)[..., 0], split(m)[..., 0]


def split_merge_fractions(payload, page_size, gamma, g, rule=CausalRule(), seed=0,
                          lengths=(3100, 1500, 700, 1)):
    """The split merge's largest differences from the plain version (the
    reference's one page merge), each as a fraction of the card's gate
    (``chip_smoke.py``: o within 2 bf16 ulps at the output's scale, l within
    1e-5 relative, m within 1e-5 x max(1, |m|)), flat and on each of 4
    shards: ``o`` after the output's rounding to bf16, ``o_f32`` before it.
    GQA g over 2 kv heads, D 128, bf16 activations."""
    (flat, shards) = _card_cache(payload, page_size, 2, list(lengths), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((len(lengths), gamma, 2 * g, 128), generator=gen).to(torch.bfloat16).float()
    worst = dict(o=0.0, o_f32=0.0, l=0.0, m=0.0)
    for r, (cache, cfg, glob) in enumerate([flat] + shards):
        stride, offset = (1, 0) if r == 0 else (4, r - 1)
        got = split_merge_model(q, cache, cfg, rule, stride, offset, glob)
        want = tdec._paged_multitoken_decode_plain(q, cache, cfg, 128 ** -0.5, rule, True,
                                                   stride, offset, glob)
        (o, l, m), (wo, wl, wm) = got, want
        assert torch.isfinite(o).all()
        assert torch.equal(wl == 0, l == 0)
        ob, wob = (x.to(torch.bfloat16).float() for x in (o, wo))
        gate = 2 * 2.0 ** -8 * max(float(wob.abs().max()), 1e-30)
        for key, x in (("o", float((ob - wob).abs().max()) / gate),
                       ("o_f32", float((o - wo).abs().max()) / gate),
                       ("l", float(((l - wl).abs() / wl.clamp_min(1e-30)).max()) / 1e-5),
                       ("m", float(((m - wm).abs() / wm.abs().clamp_min(1.0)).max()) / 1e-5)):
            worst[key] = max(worst[key], x)
    return worst


def _assert_within_gate(fractions):
    """Within every gate, and o before its rounding within half of it."""
    assert max(fractions.values()) <= 1.0 and fractions["o_f32"] <= 0.5, fractions


@pytest.mark.parametrize("gamma,g", [(1, 1), (4, 4)])
@pytest.mark.parametrize("page_size", [16, 256, 512])
@pytest.mark.parametrize("payload", list(PAYLOADS))
def test_split_merge_within_card_gate(payload, page_size, gamma, g):
    """The tensor-core decode cuts a slot's pages over CTAs and merges their
    partials (and, at 64 rows of page 512 or pages of 16, merges once a
    64-key stage): its float32 model stays within the card's gates of the
    plain version, before the output's rounding within half of them, flat
    and on each of 4 shards, for every payload."""
    _assert_within_gate(split_merge_fractions(payload, page_size, gamma, g))


@pytest.mark.parametrize("payload,page_size,rule", [
    ("int8", 256, LocalRule(1024, 0, True)), ("int4", 16, LocalRule(300, 0, True)),
    ("e4m3", 512, LocalRule(200, 1, True))])
def test_split_merge_within_card_gate_window(payload, page_size, rule):
    """The same under a window (the first live page skipped on the
    device)."""
    _assert_within_gate(split_merge_fractions(payload, page_size, 4, 1, rule, seed=3))


def test_split_merge_model_takes_several_runs():
    """The sweep's shapes cut slots into several runs, and the stage merge
    is reached (64 rows at page 512, pages of 16)."""
    cfg = _card_cfg("int8", 256, 2, 13, 4)
    assert native.decode_plan(4, 2, 1, cfg)["splits"] == 13      # a run a page
    assert native.decode_plan(4, 2, 4, cfg)["splits"] == 13
    assert native.decode_merge_keys(512, 64) == 64 and native.decode_merge_keys(512, 32) == 512
    assert native.decode_merge_keys(16, 1) == 64 and native.decode_merge_keys(256, 64) == 256


def test_decode_plan_reads_no_length(monkeypatch):
    """The split count, workspace and tickets come from the shapes and the
    cache's configuration alone: no tensor is read on the host (every
    tensor read raises here), so a decode step needs no device sync."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plan read a tensor")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    cfg = _card_cfg("int8", 256, 8, 64, 16)
    plan = native.decode_plan(16, 8, 1, cfg)
    assert plan == dict(body="tensor-core", splits=4, row_groups=1, ctas=512,
                        smem=native.decode_tc_smem(cfg, 1), tickets=128,
                        workspace=128 * 4 * 64 * 130)
    import inspect
    assert list(inspect.signature(native.decode_plan).parameters) == [
        "S", "n_q", "gamma", "cfg", "act_dtype"]


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("act,page,head_dim,body", [
    (torch.bfloat16, 256, 128, "tensor-core"), (torch.bfloat16, 512, 96, "tensor-core"),
    (torch.bfloat16, 16, 128, "tensor-core"), (torch.bfloat16, 32, 128, "tensor-core"),
    (torch.bfloat16, 64, 128, "tensor-core"), (torch.bfloat16, 8, 128, "scalar"),
    (torch.bfloat16, 48, 128, "scalar"), (torch.bfloat16, 256, 384, "scalar"),
    (torch.float32, 256, 128, "scalar")])
def test_decode_body(payload, act, page, head_dim, body):
    """The decodes run the tensor-core body on bf16 activations at
    head_dim_store 128 on pages of 16, 32 or a multiple of 64 tokens, for
    every payload; float32 activations, other stored widths (384) and
    other pages on the scalar body."""
    cfg = _card_cfg(payload, page, 2, 4, 2) if head_dim == 128 else KVCacheConfig(
        n_kv_heads=2, head_dim=head_dim, page_size=page, quantized=PAYLOADS[payload] is not None,
        quant_dtype=PAYLOADS[payload] or torch.int8, dtype=torch.bfloat16)
    assert native.decode_body(act, cfg) == body


@pytest.mark.parametrize("payload,page,rows,smem", [
    ("int8", 256, 1, 77216), ("bf16", 256, 64, 188752), ("int4", 512, 32, 130256),
    ("e4m3", 512, 64, 106832), ("int8", 16, 1, 76448)])
def test_decode_tc_shared_memory(payload, page, rows, smem):
    """The tensor-core decode's shared memory (C ``dc_smem``) for a CTA of
    ``rows`` query rows, every case within a block of the H100; one row of
    a one-byte payload fits two CTAs an SM."""
    cfg = _card_cfg(payload, page, 2, 4, 2)
    assert native.decode_tc_smem(cfg, rows) == smem <= native.MAX_SMEM
    if rows == 1:
        assert 2 * (smem + 1024) <= 228 * 1024


def decode_merge_sweep(seeds=range(4), workers=4):
    """The largest fraction of each gate over ``seeds`` × every payload ×
    pages 16, 256, 512 × gamma 1, 4 × g 1, 4 × causal and a 1,024 window,
    each case flat and on each of 4 shards."""
    import concurrent.futures
    import itertools
    cases = list(itertools.product(PAYLOADS, (16, 256, 512), (1, 4), (1, 4),
                                   ("causal", "window"), seeds))
    worst = {}
    with concurrent.futures.ProcessPoolExecutor(workers) as pool:
        for case, f in zip(cases, pool.map(_sweep_case, cases)):
            for gate, x in f.items():
                key = (case[0], case[1], gate)
                if x > worst.get(key, (-1.0,))[0]:
                    worst[key] = (x,) + case[2:]
    return len(cases), worst


def _sweep_case(case):
    payload, page, gamma, g, rule, seed = case
    torch.set_num_threads(2)
    return split_merge_fractions(payload, page, gamma, g,
                                 CausalRule() if rule == "causal" else LocalRule(1024, 0, True),
                                 seed)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_decode.py (from the repo
    # root): one line a (payload, page, gate) with the largest fraction and
    # the case that reached it, then the largest fraction of each gate
    import json
    n_cases, worst = decode_merge_sweep()
    print(f"{n_cases} cases, each flat and on 4 shards")
    for key, v in sorted(worst.items()):
        print(json.dumps(dict(payload=key[0], page=key[1], gate=key[2], fraction=v[0],
                              gamma=v[1], g=v[2], rule=v[3], seed=v[4])))
    print("largest fraction:", json.dumps(
        {g: max(v[0] for k, v in worst.items() if k[2] == g) for g in ("o", "o_f32", "l", "m")}))
