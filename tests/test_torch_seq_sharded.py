"""Sequence-sharded (context-parallel) serving of the port against the JAX
package, on the CPU.

Each shard ``r`` of a 4-shard layout holds every 4th global page from
``r``: the port's plain versions of the decode, multi-token decode and
prefill kernels with ``returning_l_m``, ``page_stride`` and ``page_offset``
(and the global lengths) against JAX's Pallas kernels in interpret mode;
the strided chunk writes bit for bit against JAX's; and the port's sharded
functions on a mesh of four ``"cpu"`` devices against JAX's ``shard_map``
versions on four virtual CPU devices.  ``quantized`` is False
(unquantized), True (int8) or a payload name of ``_torch_parity``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import decode as jdec
from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu.serving import prefill as jpre
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
from tf_flash_attention_tpu_torch.serving import decode as tdec
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv
from tf_flash_attention_tpu_torch.serving import prefill as tpre
from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd

from _torch_parity import (assert_same_cache, cache_cfgs, caches_from, one_torch_thread,
                           random_state, raw)

# many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4                      # shards
# o: float32 with an unquantized cache differs by summation order only; a
# quantized cache rounds p to bf16 on both sides, and an element whose
# float32 value differs in the last bit may round the other way (int8), at
# outputs up to ~2.5 for fp8 and int4
TOL_O = {False: 2e-5, True: 1e-3, "e4m3": 2e-3, "int4": 2e-3}
# l sums the unrounded p of both sides, m is the running max of the same
# float32 logits: both differ by summation order only
TOL_L = 1e-5               # relative
TOL_M = 1e-5               # relative, and absolute below |m| = 1
PAYLOADS = [False, True, "e4m3", "int4"]
RULES = {"local_100": (JLocalRule(100, 0, True), LocalRule(100, 0, True)),
         "local_8_stride_4": (JLocalRule(8, 2, True), LocalRule(8, 2, True))}


def _owned(total, ps, r):
    return tkv._owned_token_count(total, ps, N, r)


def _close_lm(got, want):
    np.testing.assert_allclose(got[1], want[1], rtol=TOL_L, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=TOL_M, atol=TOL_M)


def test_owned_token_count_matches_jax():
    for ps in (16, 64):
        for stride in (1, 2, 4):
            for offset in range(stride):
                for total in range(0, 9 * ps, 7):
                    want = int(jkv._owned_token_count(total, ps, stride, offset))
                    assert tkv._owned_token_count(total, ps, stride, offset) == want
    # the shards' counts add up to the global length
    assert sum(_owned(1000, 64, r) for r in range(N)) == 1000


def test_first_live_page_strided_matches_jax():
    lengths = np.array([0, 1, 300, 700, 1023], np.int32)
    for jr, tr in RULES.values():
        for gamma in (1, 3):
            for r in range(N):
                want = np.asarray(jdec._first_live_page(jr, lengths, gamma, 64, N, r))
                got = tdec._first_live_page(tr, torch.from_numpy(lengths), gamma, 64, N, r)
                np.testing.assert_array_equal(got.numpy(), want)


# global lengths 700 (11 pages, every shard holds some) and 130 (3 pages:
# shard 3 holds none, so its partial is o = 0, l = 0, m = NEG_INF), and an
# empty slot; with gamma the lengths count the drafts
GLOBAL = [700, 130, 0]


def _decode_shard(quantized, r, gamma, rules=(None, None), seed=0):
    """(port, JAX) (o, l, m) of shard r as numpy."""
    rng = np.random.default_rng(seed + r)
    jcfg, tcfg = cache_cfgs(quantized)
    local = [_owned(n, tcfg.page_size, r) for n in GLOBAL]
    jc, tc = caches_from(random_state(tcfg, rng, local), jcfg, tcfg)
    glob = np.asarray(GLOBAL, np.int32)
    shape = (3, 4, 32) if gamma is None else (3, gamma, 4, 32)
    q = rng.uniform(-1, 1, shape).astype(np.float32)
    jkw = {} if rules[0] is None else {"rule": rules[0]}
    tkw = {} if rules[1] is None else {"rule": rules[1]}
    jfn, tfn = ((jdec.paged_decode_attention, tdec.paged_decode_attention) if gamma is None
                else (jdec.paged_multitoken_decode, tdec.paged_multitoken_decode))
    want = jfn(q, jc, jcfg, returning_l_m=True, page_stride=N, page_offset=r,
               global_lengths=jnp.asarray(glob), interpret=True, **jkw)
    got = tfn(torch.from_numpy(q), tc, tcfg, returning_l_m=True, page_stride=N, page_offset=r,
              global_lengths=torch.from_numpy(glob), **tkw)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("gamma", [None, 3], ids=["decode", "gamma3"])
@pytest.mark.parametrize("quantized", PAYLOADS)
def test_decode_shards_match_jax(quantized, gamma):
    for r in range(N):
        got, want = _decode_shard(quantized, r, gamma)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_O[quantized])
        _close_lm(got, want)
        assert got[1].dtype == got[2].dtype == np.float32
        np.testing.assert_array_equal(got[0][2], 0.0)        # empty slot
        np.testing.assert_array_equal(got[1][2], 0.0)
        if r == 3:                                            # no local page of slot 1
            np.testing.assert_array_equal(got[0][1], 0.0)
            np.testing.assert_array_equal(got[1][1], 0.0)


@pytest.mark.parametrize("gamma", [None, 3], ids=["decode", "gamma3"])
@pytest.mark.parametrize("rule", list(RULES))
def test_decode_shards_local_rule_match_jax(rule, gamma):
    """Window rules on global positions: each shard skips its pages below
    the oldest row's window before any load."""
    for r in range(N):
        got, want = _decode_shard(False, r, gamma, RULES[rule], seed=5)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_O[False])
        _close_lm(got, want)


def _prefill_shard(quantized, r, start, chunk, true_len, rules=(None, None), seed=0):
    rng = np.random.default_rng(seed + r)
    jcfg, tcfg = cache_cfgs(quantized)
    total = start + true_len
    jc, tc = caches_from(random_state(tcfg, rng, [0, _owned(total, tcfg.page_size, r), 0]),
                         jcfg, tcfg)
    q = rng.uniform(-1, 1, (chunk, 4, 32)).astype(np.float32)
    jkw = {} if rules[0] is None else {"rule": rules[0]}
    tkw = {} if rules[1] is None else {"rule": rules[1]}
    want = jpre.paged_prefill_attention(q, jc, jcfg, 1, start, true_len, returning_l_m=True,
                                        page_stride=N, page_offset=r, interpret=True, **jkw)
    got = tpre.paged_prefill_attention(torch.from_numpy(q), tc, tcfg, 1, start, true_len,
                                       returning_l_m=True, page_stride=N, page_offset=r, **tkw)
    # rows past true_len are padding on both sides
    return ([x.numpy()[:true_len] for x in got], [np.asarray(x)[:true_len] for x in want])


# a 48-row chunk, 40 of them real, at position 600 of a 640-token sequence:
# global pages 0-9 (shards 0 and 1 hold 3 of them, shards 2 and 3 hold 2);
# the chunk's own rows sit on page 9, shard 1's
@pytest.mark.parametrize("quantized", PAYLOADS)
def test_prefill_shards_match_jax(quantized):
    for r in range(N):
        got, want = _prefill_shard(quantized, r, 600, 48, 40)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_O[quantized])
        _close_lm(got, want)


@pytest.mark.parametrize("rule", list(RULES))
def test_prefill_shards_local_rule_match_jax(rule):
    for r in range(N):
        got, want = _prefill_shard(False, r, 560, 64, 64, RULES[rule], seed=3)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_O[False])
        _close_lm(got, want)


# a 201-token prompt in chunks of 32 over pages of 16 (13 global pages, the
# last chunk 9 rows: odd, so an int4 byte row is half padding), written by
# every shard with its stride and offset
@pytest.mark.parametrize("quantized", [False, True, "e4m3", "e5m2", "int4"])
def test_write_tokens_at_strided_matches_jax(quantized):
    jcfg, tcfg = cache_cfgs(quantized, page_size=16)
    trash = tcfg.n_pages - 1
    for r in range(N):
        rng = np.random.default_rng(20 + r)
        jc, tc = caches_from(random_state(tcfg, rng, [0, 0, 0]), jcfg, tcfg)
        start, total = 0, 201
        while start < total:
            n = min(32, total - start)
            k = rng.uniform(-2, 2, (2, 32, 32)).astype(np.float32)
            v = rng.uniform(-2, 2, (2, 32, 32)).astype(np.float32)
            jc = jkv.write_tokens_at(jc, jcfg, 2, start, jnp.asarray(k), jnp.asarray(v), n,
                                     trash, page_stride=N, page_offset=r)
            tkv.write_tokens_at(tc, tcfg, 2, start, torch.from_numpy(k), torch.from_numpy(v),
                                n, trash, page_stride=N, page_offset=r)
            start += n
        assert int(tc.lengths[2]) == _owned(total, 16, r)
        assert_same_cache(jc, tc, trash)


# global lengths: odd and even (int4 byte rows half full or empty), slot 1
# two tokens short of a page, slot 2 inactive; pages of 16 tokens
APPEND_GLOBAL = [13, 30, 47, 58]
APPEND_ACTIVE = [True, True, False, True]


@pytest.mark.parametrize("T", [1, 2, 4, 5])
@pytest.mark.parametrize("quantized", [False, True, "e4m3", "e5m2", "int4"])
def test_owner_masked_appends_match_jax(quantized, T):
    """One append of T tokens a slot (the speculative step's gamma), flat
    and on every shard of strides 2 and 4, against JAX's T ordered
    append_tokens_batched calls with the engine's masks ``mine = active &
    (owner == me)``: the same pages, scales and local lengths."""
    jcfg, tcfg = cache_cfgs(quantized, page_size=16, n_pages=20, max_seqs=4,
                            max_pages_per_seq=4)
    trash = tcfg.n_pages - 1
    glob = np.asarray(APPEND_GLOBAL, np.int32)
    active = np.asarray(APPEND_ACTIVE)
    for stride in (1, 2, 4):
        for r in range(stride):
            rng = np.random.default_rng(100 * stride + 10 * r + T)
            local = [tkv._owned_token_count(int(g), 16, stride, r) for g in glob]
            jc, tc = caches_from(random_state(tcfg, rng, local), jcfg, tcfg)
            k = rng.uniform(-2, 2, (4, T, 2, 32)).astype(np.float32)
            v = rng.uniform(-2, 2, (4, T, 2, 32)).astype(np.float32)
            for i in range(T):
                mine = active & ((glob + i) // 16 % stride == r)
                jc = jkv.append_tokens_batched(jc, jcfg, jnp.asarray(k[:, i]),
                                               jnp.asarray(v[:, i]), jnp.asarray(mine), trash)
            tkv.append_tokens_batched(tc, tcfg, torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(active), trash,
                                      global_lengths=torch.from_numpy(glob),
                                      page_stride=stride, page_offset=r)
            assert_same_cache(jc, tc, trash)
            want = [tkv._owned_token_count(int(g) + T * a, 16, stride, r)
                    for g, a in zip(glob, active)]
            np.testing.assert_array_equal(tc.lengths.numpy(), want)


def _plain_stored_tokens(tcfg, start, true_len, chunk, stride, offset):
    """The chunk tokens ``_write_tokens_plain`` stores outside the trash
    page: token t's rows carry t + 1 (unquantized) or a scale of (t + 1) / 7
    (int4, read from its byte row's even token)."""
    cache = tkv.PagedKVCache.create(tcfg, "cpu")
    if cache.k_scales is not None:
        cache.k_scales.zero_()
    cache.page_tables.copy_(torch.arange(8, dtype=torch.int32)[None])
    k = (torch.arange(chunk, dtype=torch.float32) + 1)[None, :, None].expand(2, chunk, 32)
    meta = tkv.chunk_write_meta(0, start, true_len, tcfg.n_pages - 1, stride)[offset]
    tkv._write_tokens_plain(cache, tcfg, meta, k, k, stride)
    kept = cache.k_pages[0, :-1] if tcfg.tok_pack == 1 else cache.k_scales[0, :-1, 0] * 7
    vals = kept[..., 0] if tcfg.tok_pack == 1 else kept
    return sorted(int(x) - 1 for x in torch.round(vals).flatten() if x > 0)


@pytest.mark.parametrize("quantized", [False, "int4"], ids=["token_rows", "int4_byte_rows"])
def test_owned_rows_match_the_plain_mask(quantized):
    """The run of local positions a chunk write keeps (``_owned_rows``, the
    kernel's grid), mapped back to global positions as the kernel maps them,
    lists exactly the rows ``_write_tokens_plain`` stores outside the trash
    page, over a grid of start, true_len, stride and offset; its length is
    JAX's owned-token count."""
    _, tcfg = cache_cfgs(quantized, page_size=16, n_pages=10, max_seqs=1, max_pages_per_seq=8)
    pack, chunk = tcfg.tok_pack, 32
    for start in (0, 6, 16, 30, 48):
        for true_len in (0, 1, 7, 16, 17, 31, 32):
            for stride in (1, 2, 4):
                for offset in range(stride):
                    local0, rows, length = tkv._owned_rows(tcfg, start, true_len, stride,
                                                           offset)
                    got = [((lp // 16) * stride + offset) * 16 + lp % 16 - start
                           for lp in range(local0, local0 + pack * rows, pack)]
                    want = _plain_stored_tokens(tcfg, start, true_len, chunk, stride, offset)
                    assert got == want, (start, true_len, stride, offset)
                    assert length == int(jkv._owned_token_count(start + true_len, 16, stride,
                                                                offset))


def _mesh_pair():
    from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
    return (jmake_mesh((N,), ("seq",), jax.devices()[:N]),
            make_mesh((N,), ("seq",), ["cpu"] * N))


@pytest.mark.parametrize("quantized", [True, "int4"])
def test_sharded_cache_layout_matches_jax(quantized):
    """create_seq_sharded_cache + write_prompt_seq_sharded: each shard of the
    port equals JAX's slice [r] (pages, scales, tables, lengths)."""
    from tf_flash_attention_tpu.serving import seq_sharded_decode as jsd
    jmesh, tmesh = _mesh_pair()
    jcfg, tcfg = cache_cfgs(quantized, page_size=32, n_pages=8, max_seqs=2)
    rng = np.random.default_rng(31)
    t = 7 * 32 + 9                      # 8 global pages, the last partial
    k = rng.uniform(-1, 1, (2, t, 32)).astype(np.float32)
    v = rng.uniform(-1, 1, (2, t, 32)).astype(np.float32)
    per_shard = [[3, 6], [1, 2], [5, 0], [4, 6]]
    jc = jsd.create_seq_sharded_cache(jcfg, jmesh, "seq")
    jc = jsd.write_prompt_seq_sharded(jc, jcfg, jmesh, "seq", 1, per_shard, jnp.asarray(k),
                                      jnp.asarray(v))
    tc = tsd.create_seq_sharded_cache(tcfg, tmesh, "seq")
    tsd.write_prompt_seq_sharded(tc, tcfg, tmesh, "seq", 1, per_shard, torch.from_numpy(k),
                                 torch.from_numpy(v))
    assert len(tc) == N
    for r in range(N):
        for name in ("k_pages", "v_pages", "k_scales", "v_scales", "page_tables", "lengths"):
            np.testing.assert_array_equal(raw(getattr(tc[r], name)),
                                          raw(np.asarray(getattr(jc, name))[r]), err_msg=name)


def test_sharded_decode_prefill_and_appends_match_jax():
    """The sharded functions on 4 x "cpu" against JAX's shard_map versions on
    4 CPU devices (int8 cache): decode, appends that cross into a page of
    another shard, decode again, and a prefill chunk; local lengths sum to
    the global length."""
    from tf_flash_attention_tpu.serving import seq_sharded_decode as jsd
    jmesh, tmesh = _mesh_pair()
    jcfg, tcfg = cache_cfgs(True, page_size=32, n_pages=8, max_seqs=2,
                            max_pages_per_seq=6)
    rng = np.random.default_rng(41)
    t = 7 * 32 + 20                     # global page 7 (shard 3) is the tail
    k = rng.uniform(-1, 1, (2, t, 32)).astype(np.float32)
    v = rng.uniform(-1, 1, (2, t, 32)).astype(np.float32)
    per_shard = [[0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 2]]
    jc = jsd.write_prompt_seq_sharded(jsd.create_seq_sharded_cache(jcfg, jmesh, "seq"), jcfg,
                                      jmesh, "seq", 0, per_shard, jnp.asarray(k),
                                      jnp.asarray(v))
    tc = tsd.write_prompt_seq_sharded(tsd.create_seq_sharded_cache(tcfg, tmesh, "seq"), tcfg,
                                      tmesh, "seq", 0, per_shard, torch.from_numpy(k),
                                      torch.from_numpy(v))
    q = rng.uniform(-1, 1, (2, 4, 32)).astype(np.float32)
    jdecode = jsd.seq_sharded_paged_decode(jmesh, jcfg, "seq", interpret=True)
    tdecode = tsd.seq_sharded_paged_decode(tmesh, tcfg, "seq")
    # the merge of per-shard partials at bf16-rounded p: parity at that level
    np.testing.assert_allclose(tdecode(torch.from_numpy(q), tc).numpy(),
                               np.asarray(jdecode(jnp.asarray(q), jc)), rtol=0, atol=1e-3)
    # appends at positions 244 .. 255 and 256 .. 259: global page 8 is shard
    # 0's local page 2, mapped before the appends (page 3 of shard 0)
    tables = np.array(jc.page_tables)
    tables[0, 0, 2] = 3
    jc = dataclasses.replace(jc, page_tables=jnp.asarray(tables))
    tc[0].page_tables[0, 2] = 3
    japp = jsd.seq_sharded_append(jmesh, jcfg, "seq", trash_page=jcfg.n_pages - 1,
                                  interpret=True)
    tapp = tsd.seq_sharded_append(tmesh, tcfg, "seq", trash_page=tcfg.n_pages - 1)
    active = np.array([True, False])
    for _ in range(16):
        kn = np.zeros((2, 2, 32), np.float32)
        kn[0] = rng.uniform(-1, 1, (2, 32))
        jc = japp(jc, jnp.asarray(kn), jnp.asarray(-kn), jnp.asarray(active))
        tapp(tc, torch.from_numpy(kn), torch.from_numpy(-kn), torch.from_numpy(active))
    for r in range(N):
        for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
            a, b = raw(getattr(tc[r], name)), raw(np.asarray(getattr(jc, name))[r])
            if name != "lengths":
                a, b = a[:, :tcfg.n_pages - 1], b[:, :tcfg.n_pages - 1]
            np.testing.assert_array_equal(a, b, err_msg=f"shard {r} {name}")
    assert sum(int(c.lengths[0]) for c in tc) == t + 16
    np.testing.assert_allclose(tdecode(torch.from_numpy(q), tc).numpy(),
                               np.asarray(jdecode(jnp.asarray(q), jc)), rtol=0, atol=1e-3)
    # a prefill chunk over the last 40 tokens, 8 rows of padding
    qp = rng.uniform(-1, 1, (48, 4, 32)).astype(np.float32)
    start = t + 16 - 40
    jprefill = jsd.seq_sharded_paged_prefill(jmesh, jcfg, "seq", interpret=True)
    tprefill = tsd.seq_sharded_paged_prefill(tmesh, tcfg, "seq")
    want = np.asarray(jprefill(jnp.asarray(qp), jc, jnp.asarray(0), jnp.asarray(start),
                               jnp.asarray(40)))
    got = tprefill(torch.from_numpy(qp), tc, 0, start, 40).numpy()
    np.testing.assert_allclose(got[:40], want[:40], rtol=0, atol=1e-3)


def test_merge_of_shards_equals_flat_decode():
    """Four shards' merged decode against the flat decode of the same tokens
    in one cache (float32, unquantized: exact up to summation order)."""
    rng = np.random.default_rng(9)
    _, flat_cfg = cache_cfgs(False, page_size=16, n_pages=40, max_seqs=2,
                             max_pages_per_seq=16)
    _, cfg = cache_cfgs(False, page_size=16, n_pages=8, max_seqs=2)
    mesh = make_mesh((N,), ("seq",), ["cpu"] * N)
    t = 150
    k = torch.from_numpy(rng.uniform(-1, 1, (2, t, 32)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (2, t, 32)).astype(np.float32))
    flat = tkv.PagedKVCache.create(flat_cfg, "cpu")
    tkv.write_prompt(flat, flat_cfg, 1, list(range(10)), k, v)
    shards = tsd.write_prompt_seq_sharded(tsd.create_seq_sharded_cache(cfg, mesh, "seq"), cfg,
                                          mesh, "seq", 1, [[0, 1, 2]] * N, k, v)
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 32)).astype(np.float32))
    got = tsd.seq_sharded_paged_decode(mesh, cfg, "seq")(q, shards)
    want = tdec.paged_decode_attention(q, flat, flat_cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
