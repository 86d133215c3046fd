"""The experiment tools' decode kernels, ported, against the tools on the CPU.

``tools/exp_int4_unpack.py`` (its six kernels) and ``tools/exp_decode.py``
(five variants of its paged decode kernel) run their Pallas kernels in
interpret mode at small sizes, with the module's sizes set by
``monkeypatch`` and a spy in place of its ``device_time`` that keeps each
kernel's inputs and output.  The port's plain versions take the same
inputs; its CUDA kernels are held against those plain versions on the card
(``chip_smoke.py`` phase 8, ``test_torch_cuda.py``).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tf_flash_attention_tpu_torch.experiments import exp_decode as tdec
from tf_flash_attention_tpu_torch.experiments import exp_int4_unpack as tint4

from _torch_parity import cache_cfgs, caches_from, one_torch_thread, random_state

# the split-merge models are many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"

# Both sides round p to bf16 after the same float32 steps and o to bf16
# once (they agree bit for bit at these sizes); they may part where exp2
# (XLA's against PyTorch's) or a summation order moves a float32 value
# across a bf16 rounding boundary: one p element by 2**-8 relative, or an
# output by one ulp.  Bound: two bf16 ulps at the output's scale.
ULPS = 2
# int8mm: a p code may also differ by one where pw / ps lies next to a
# half; bitcast rounds each half and their sum (three roundings)
ULPS_CODES = 3


def _close(got, want, ulps):
    np.testing.assert_allclose(got, want, atol=ulps * 2.0 ** -8 * np.abs(want).max(), rtol=0)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32 if dtype == torch.bfloat16 else None).copy())
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def int4_runs():
    """{runner: (inputs as numpy, output)} of the tool's main at B 2, CTX
    1024 (4 pages of 256, so that fourpage has a step), 2 kv heads."""
    mp = pytest.MonkeyPatch()
    try:
        _interpret(mp)
        tool = _load("exp_int4_unpack")
        for name, value in dict(B=2, CTX=1024, PAGE=256, N_KV=2, D=128, G=8, PAGES=4,
                                ROWS=128).items():
            mp.setattr(tool, name, value)
        runs = []

        def spy(fn, args, **kw):
            runs.append(([np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
                          for a in args], np.asarray(fn(*args).astype(jnp.float32))))
            return 1.0

        mp.setattr(tool, "device_time", spy)
        tool.main()
    finally:
        mp.undo()
    return dict(zip(tint4.KERNELS, runs))


@pytest.mark.parametrize("name", list(tint4.KERNELS))
def test_int4_unpack_kernel_matches_tool(int4_runs, name):
    assert len(int4_runs) == len(tint4.KERNELS), "a runner of the tool failed"
    args, want = int4_runs[name]
    if name == "bitcast":   # the tool's zero-stuffed queries: the port takes q
        args = [int4_runs["s32"][0][0]] + args[1:]
    q, k, ks, v, vs = _t(args[0], torch.bfloat16), *(_t(a) for a in args[1:])
    got = tint4.int4_decode(tint4.KERNELS[name], q, k, ks, v, vs).float().numpy()
    assert got.shape == want.shape
    _close(got, want, ULPS_CODES if name == "bitcast" else ULPS)


def test_int4_quantizers_match_tool():
    """The port's q4/q8 give the payloads and scales of the tool's ``q4``
    and ``q8`` (exp_int4_unpack.py:206-222, inside its jitted set-up, here
    in numpy) bit for bit."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, 512, 128)).astype(np.float32)
    k4, ks4, kd = tint4.quantize_int4(torch.from_numpy(x))
    k8, ks8 = tint4.quantize_int8(torch.from_numpy(x))
    amax = np.abs(x).max(-1, keepdims=True)
    sc4, sc8 = np.where(amax == 0, 1, amax / np.float32(7)), np.where(amax == 0, 1,
                                                                     amax / np.float32(127))
    q4 = np.clip(np.round(x / sc4), -7, 7).astype(np.int32)
    packed = ((q4[:, 0::2] & 0xF) | ((q4[:, 1::2] & 0xF) << 4)).astype(np.int8)
    np.testing.assert_array_equal(k4.numpy(), packed.reshape(2, 2, 128, 128))
    np.testing.assert_array_equal(ks4.numpy()[:, :, 0], sc4[:, 0::2, 0].reshape(2, 2, 128))
    np.testing.assert_array_equal(ks4.numpy()[:, :, 1], sc4[:, 1::2, 0].reshape(2, 2, 128))
    np.testing.assert_array_equal(
        k8.numpy(), np.clip(np.round(x / sc8), -127, 127).astype(np.int8).reshape(2, 2, 256, 128))
    np.testing.assert_array_equal(ks8.numpy(), sc8[..., 0].reshape(2, 2, 1, 256))
    np.testing.assert_array_equal(kd.numpy(), (q4 * sc4).astype(np.float32))


# ---- the tool's sites on the decode's tensor-core body (decode_tc.cuh) ----

def _int4_state(kernel, q, k, ks, v, vs):
    """The plain version's running state over the pages of k, v, in its
    order (``int4_decode_plain``'s loop, a merge each npg pages): (acc,
    acc_odd, m, l), float32; acc_odd is bitcast's odd keys' (else zero)."""
    npg, pack = tint4.native.INT4_NPG[kernel], tint4.native._tool_pack(kernel)
    n_kv, pages, rows, d = k.shape
    c = 1.0 / np.sqrt(d) * tint4.LOG2E
    (kt, kst), (vt, vst) = tint4._tokens(k, ks, pack), tint4._tokens(v, vs, pack)
    T = npg * pack * rows
    kt, vt = kt.reshape(n_kv, pages // npg, T, d), vt.reshape(n_kv, pages // npg, T, d)
    kst, vst = kst.reshape(n_kv, pages // npg, T), vst.reshape(n_kv, pages // npg, T)
    qf = q.float()
    m = torch.full((*q.shape[:3], 1), tint4.NEG_INF_F32)
    l = torch.zeros_like(m)
    acc, acc_odd = torch.zeros(q.shape), torch.zeros(q.shape)
    odd = (torch.arange(T) // rows) % 2 == 1
    split = kernel == "exp_int4_bitcast"
    for st in range(pages // npg):
        s = torch.einsum("bhgd,htd->bhgt", qf, kt[:, st]) * (kst[:, st] * c)[None, :, None, :]
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        pw = torch.exp2(s - m_next)
        l = alpha * l + pw.sum(-1, keepdim=True)
        p = tint4.bf16r(pw * vst[:, st][None, :, None, :])
        if split:
            acc = acc * alpha + torch.einsum("bhgt,htd->bhgd", p * ~odd, vt[:, st])
            acc_odd = acc_odd * alpha + torch.einsum("bhgt,htd->bhgd", p * odd, vt[:, st])
        else:
            acc = acc * alpha + torch.einsum("bhgt,htd->bhgd", p, vt[:, st])
        m = m_next
    return acc, acc_odd, m, l


def int4_split_model(kernel, q, k, ks, v, vs, splits):
    """The tensor-core body's arithmetic for one of the tool's sites: each
    (row, kv head)'s merges of npg pages cut into ``splits`` runs
    (``decode_tc_kernel``: ceil(units / splits) a run, the empty ones
    dropped), each run's state from a fresh start, the partials merged as
    the last CTA merges them (in run order: M the largest m, each scaled by
    exp2(m - M)), then the finish (bitcast: each half over l rounded to
    bf16, the halves summed) -> o bf16."""
    npg = tint4.native.INT4_NPG[kernel]
    units = k.shape[1] // npg
    per = -(-units // splits)
    parts = [_int4_state(kernel, q, *(x[:, r * per * npg:(r + 1) * per * npg] for x in (k, ks)),
                         *(x[:, r * per * npg:(r + 1) * per * npg] for x in (v, vs)))
             for r in range(-(-units // per))]
    M = torch.stack([p[2] for p in parts]).amax(0)
    O, O_odd, L = torch.zeros(q.shape), torch.zeros(q.shape), torch.zeros_like(M)
    for acc, acc_odd, m, l in parts:
        f = torch.exp2(m - M)
        O, O_odd, L = O + acc * f, O_odd + acc_odd * f, L + l * f
    div = torch.where(L == 0, torch.ones_like(L), L)
    if kernel == "exp_int4_bitcast":
        return (tint4.bf16r(O / div) + tint4.bf16r(O_odd / div)).to(torch.bfloat16)
    return (O / div).to(torch.bfloat16)


INT4_TC = list(tint4.native.INT4_TC_UNPACK)
# (B, ctx, n_kv): the tool's shape (16 rows of 8 kv heads over 8,192 keys:
# 4 splits) and int4_runs' small one (2 rows, 2 kv heads, 1,024 keys: a run
# a merge unit)
INT4_SHAPES = {"tool": (16, 8192, 8), "small": (2, 1024, 2)}


def _tool_kv(kernel, kv):
    """The tool's payload of float32 kv (2, n_kv, ctx, d): (k, ks, v, vs)."""
    if tint4.native._tool_pack(kernel) == 1:
        return (*tint4.quantize_int8(kv[0]), *tint4.quantize_int8(kv[1]))
    (k, ks, _), (v, vs, _) = tint4.quantize_int4(kv[0]), tint4.quantize_int4(kv[1])
    return k, ks, v, vs


@pytest.mark.parametrize("shape", list(INT4_SHAPES))
@pytest.mark.parametrize("kernel", INT4_TC)
def test_int4_split_merge_within_card_gate(kernel, shape):
    """The tool's six sites cut a (row, kv head)'s merges over CTAs
    (``native.exp_int4_plan``) and merge the runs' partials in the launch:
    that model stays within phase 8's gate of the unsplit plain version (2
    bf16 ulps at the output's scale, bitcast 3 with both halves merged), on
    several seeds; with one run it is the plain version bit for bit."""
    B, ctx, n_kv = INT4_SHAPES[shape]
    ulps = ULPS_CODES if kernel == "exp_int4_bitcast" else ULPS
    for seed in range(2 if shape == "tool" else 4):
        gen = torch.Generator().manual_seed(seed)
        kv = torch.rand((2, n_kv, ctx, 128), generator=gen) * 2 - 1
        k, ks, v, vs = _tool_kv(kernel, kv)
        q = (torch.rand((B, n_kv, 8, 128), generator=gen) * 2 - 1).to(torch.bfloat16)
        want = tint4.int4_decode_plain(kernel, q, k, ks, v, vs)
        splits = tint4.native.exp_int4_plan(kernel, B, n_kv, 8, k.shape[1], k.shape[2])["splits"]
        assert splits == (4 if shape == "tool" else k.shape[1] // tint4.native.INT4_NPG[kernel])
        got = int4_split_model(kernel, q, k, ks, v, vs, splits)
        _close(got.float().numpy(), want.float().numpy(), ulps)
        if seed == 0:
            assert torch.equal(int4_split_model(kernel, q, k, ks, v, vs, 1), want)


def test_bitcast_even_odd_tile_order():
    """bitcast's stage layout (``decode_tc.cuh``, SPLIT): column c of a
    64-key stage is key 2 (c % 32) + c / 32, nibble c / 32 of the stage's
    byte row c % 32, scaled by the ring's c-th K and V scale (a piece's even
    tokens' scales first); the widened V tile holds column c's values in row
    c, so k-steps 0-1 (rows 0-31) sum the even keys and 2-3 (rows 32-63) the
    odd ones.  Column by column the model reads the token the key names, and
    its two half-sums equal the plain version's masked ones (float64)."""
    gen = torch.Generator().manual_seed(7)
    kv = torch.rand((2, 2, 512, 128), generator=gen) * 2 - 1
    (k, ks, _), (v, vs, _) = tint4.quantize_int4(kv[0]), tint4.quantize_int4(kv[1])
    n_kv, pages, rows, d = v.shape
    lo, hi = tint4._unpack_nibbles(v)                     # (n_kv, pages, rows, d) each
    natural = torch.stack([lo, hi], 3).reshape(n_kv, pages, 2 * rows, d).double()
    p_nat = torch.rand((n_kv, pages, 2 * rows), generator=gen, dtype=torch.float64)
    even_m = odd_m = 0
    for page in range(pages):
        for t0 in range(0, 2 * rows, 64):
            c = torch.arange(64)
            key = t0 + 2 * (c % 32) + c // 32
            brow, nib = t0 // 2 + c % 32, c // 32
            ring = [torch.cat([sc[:, page, 0, t0 // 2:t0 // 2 + 32],
                               sc[:, page, 1, t0 // 2:t0 // 2 + 32]], 1) for sc in (ks, vs)]
            tile = torch.where(nib[None, :, None] == 0, lo[:, page, brow], hi[:, page, brow])
            assert torch.equal(tile.double(), natural[:, page, key])
            for r, sc in zip(ring, (ks, vs)):
                assert torch.equal(r, sc[:, page].permute(0, 2, 1).reshape(n_kv, -1)[:, key])
            pv = p_nat[:, page, key, None] * tile.double()
            even_m, odd_m = even_m + pv[:, :32].sum(1), odd_m + pv[:, 32:].sum(1)
    # the plain version's order and masks (int4_decode_plain): nibble-major
    # tokens a page, the odd ones where (t // rows) is odd
    vt, _ = tint4._tokens(v, vs, 2)
    p_nm = torch.cat([p_nat[..., 0::2], p_nat[..., 1::2]], 2)
    odd = (torch.arange(2 * rows) // rows) % 2 == 1
    even_p = (p_nm * ~odd)[..., None] * vt.double()
    odd_p = (p_nm * odd)[..., None] * vt.double()
    torch.testing.assert_close(even_m, even_p.sum((1, 2)), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(odd_m, odd_p.sum((1, 2)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel,B,n_kv,G,pages,want", [
    # the tool's shape: 128 cells, two CTAs an SM (67-95 KB), 4 splits
    ("exp_int4_s32", 16, 8, 8, 32, dict(merge_keys=256, splits=4, ctas=512, smem=67088,
                                        workspace=128 * 4 * 64 * 130)),
    ("exp_int4_twopage", 16, 8, 8, 32, dict(merge_keys=512, splits=4, ctas=512, smem=76304,
                                            workspace=128 * 4 * 64 * 130)),
    ("exp_int4_fourpage", 16, 8, 8, 32, dict(merge_keys=1024, splits=4, ctas=512, smem=94736,
                                             workspace=128 * 4 * 64 * 130)),
    ("exp_int4_bitcast", 16, 8, 8, 32, dict(merge_keys=256, splits=4, ctas=512, smem=67088,
                                            workspace=128 * 4 * 64 * 258)),
    # 48 cells: 11 splits of 32 units (3 a run, the last 2); 16 rows
    ("exp_int4_s32", 6, 8, 16, 32, dict(merge_keys=256, splits=11, ctas=528, smem=75408,
                                        workspace=48 * 11 * 64 * 130)),
    # one unit: one run, no workspace
    ("exp_int4_fourpage", 1, 1, 1, 4, dict(merge_keys=1024, splits=1, ctas=1, smem=65952,
                                           workspace=0)),
    # the int8 sites (pages of 256 rows, 256 keys): a ring item of 64 keys'
    # 8,192 bytes; 83-93 KB, still two CTAs an SM
    ("exp_int4_int8ref", 16, 8, 8, 32, dict(merge_keys=256, splits=4, ctas=512, smem=83472,
                                            workspace=128 * 4 * 64 * 130)),
    ("exp_int4_int8_2pg", 16, 8, 8, 32, dict(merge_keys=512, splits=4, ctas=512, smem=92688,
                                             workspace=128 * 4 * 64 * 130)),
    # G 16: 16 rows of scores (4 x 8,704 ring + 4,224 Q + 34,816 V tiles +
    # 16 x 516 x 4 + 2,048 + 192 + 80); 6 rows x 8 kv heads, 11 splits of 16
    # units
    ("exp_int4_int8_2pg", 6, 8, 16, 32, dict(merge_keys=512, splits=11, ctas=528,
                                             smem=109200, workspace=48 * 11 * 64 * 130)),
])
def test_int4_plan_mirrors_c(kernel, B, n_kv, G, pages, want):
    """``native.exp_int4_plan`` mirrors the C rule (``decode_tc_tool``,
    ``dc_smem`` with the policy's cap of npg x 256 keys and a ring item of
    64 keys of the site's payload, ``dc_partial`` with both accumulators
    for bitcast): merge, splits, CTAs, shared memory within a block of the
    H100, workspace and tickets; the int8 sites' pages hold ``rows`` keys,
    the int4 sites' 2 ``rows``."""
    rows = 256 if kernel.startswith("exp_int4_int8") else 128
    plan = tint4.native.exp_int4_plan(kernel, B, n_kv, G, pages, rows)
    assert plan == dict(body="tensor-core", tickets=B * n_kv, **want)
    assert plan["smem"] <= tint4.native.MAX_SMEM


def test_serving_decode_on_the_tools_pages_matches_s32():
    """The yardstick: the serving decode on the tool's int4 K/V laid out as
    a cache whose slots share its pages computes s32's function (one page a
    merge, scales on s and p); on the CPU its plain version gives the s32
    plain version's bits, and the int8 inputs int8ref's."""
    gen = torch.Generator().manual_seed(5)
    kv = torch.rand((2, 2, 1024, 128), generator=gen) * 2 - 1
    q = (torch.rand((3, 2, 4, 128), generator=gen) * 2 - 1).to(torch.bfloat16)
    (k, ks, _), (v, vs, _) = tint4.quantize_int4(kv[0]), tint4.quantize_int4(kv[1])
    assert torch.equal(tint4.serving_decode(q, k, ks, v, vs),
                       tint4.int4_decode_plain("exp_int4_s32", q, k, ks, v, vs))
    (k, ks), (v, vs) = tint4.quantize_int8(kv[0]), tint4.quantize_int8(kv[1])
    assert torch.equal(tint4.serving_decode(q, k, ks, v, vs),
                       tint4.int4_decode_plain("exp_int4_int8ref", q, k, ks, v, vs))


# ---- exp_decode: the paged int8 decode, five variants ----

@pytest.fixture(scope="module")
def decode_case():
    """3 slots (lengths 300, 512 and 0) of an int8 cache, page 128, 4 pages
    a slot, GQA 4 q / 2 kv heads, d 128."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = cache_cfgs("int8", n_kv=2, head_dim=128, page_size=128, n_pages=14,
                            max_seqs=3, max_pages_per_seq=4, dtype=jnp.bfloat16)
    jc, tc = caches_from(random_state(tcfg, rng, [300, 512, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (3, 4, 128)).astype(np.float32)
    return jcfg, jc, tc, q


@pytest.mark.parametrize("variant", tdec.VARIANTS)
def test_paged_decode_variant_matches_tool(monkeypatch, decode_case, variant):
    jcfg, jc, tc, q = decode_case
    _interpret(monkeypatch)
    tool = _load("exp_decode")
    monkeypatch.setattr(tool, "device_time", lambda *a, **kw: 1.0)
    # the tool reads page-major scales (n_kv, n_pages, page, 1); the cache
    # stores (n_kv, n_pages, 1, page)
    jpm = dataclasses.replace(jc, k_scales=jnp.swapaxes(jc.k_scales, 2, 3),
                              v_scales=jnp.swapaxes(jc.v_scales, 2, 3))
    want, _ = tool.run_variant(variant, jnp.asarray(q, jnp.bfloat16), jpm, jcfg, 3)
    want = np.asarray(want.astype(jnp.float32))
    scales = ((tc.k_scales, tc.v_scales) if variant.endswith("_t")
              else (tdec.page_major(tc.k_scales), tdec.page_major(tc.v_scales)))
    got = tdec.paged_decode(variant, _t(q, torch.bfloat16), tc.k_pages, tc.v_pages, *scales,
                            tc.page_tables, tc.lengths).float().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert not got[2].any()     # the empty slot
    _close(got, want, ULPS_CODES if "int8mm" in variant else ULPS)


def test_paged_decode_int8mm_codes(decode_case):
    """q codes round half to even at max|q| / 127; the integer scores are
    the codes' exact products; p codes lie in [0, 127] and are 0 past the
    live pages; the output equals int8mm's without codes."""
    _, _, tc, q = decode_case
    qt = _t(q, torch.bfloat16)
    args = ("int8mm_t", qt, tc.k_pages, tc.v_pages, tc.k_scales, tc.v_scales, tc.page_tables,
            tc.lengths)
    o, qc, si, pc = tdec.paged_decode(*args, codes=True)
    assert torch.equal(o, tdec.paged_decode(*args))
    qf = qt.float()
    qs = qf.abs().amax(-1, keepdim=True) / 127.0
    np.testing.assert_array_equal(qc.numpy(), np.round(qf.numpy() / qs.numpy()).astype(np.int8))
    k = tc.k_pages[:, tc.page_tables[0, :3].long()].reshape(2, 3 * 128, 128).long()
    want = torch.einsum("hgd,htd->hgt", qc[0].reshape(2, 2, 128).long(), k)
    assert torch.equal(si[0].reshape(2, 2, -1)[..., :384], want.to(torch.int32))
    assert int(pc.min()) >= 0 and int(pc.max()) == 127
    assert not si[0, :, 384:].any() and not pc[2].any() and not si[2].any()


def test_paged_decode_rejects_the_other_layout(decode_case):
    _, _, tc, q = decode_case
    with pytest.raises(ValueError, match="reads scales"):
        tdec.paged_decode("postscale", _t(q, torch.bfloat16), tc.k_pages, tc.v_pages,
                          tc.k_scales, tc.v_scales, tc.page_tables, tc.lengths)


# ---- exp_decode on the decode's tensor-core body (decode_tc.cuh) ----

def paged_split_model(variant, q, k_pages, v_pages, k_scales, v_scales, tables, lengths, splits):
    """The tensor-core body's arithmetic for ``postscale`` and ``current``:
    each slot's live pages (ceil(length / page)) cut into ``splits`` runs
    (``decode_tc_kernel``: ceil(count / splits) pages a run, the empty ones
    dropped), each run's state from a fresh start (``decode_walk`` over the
    run's pages, the lengths shifted with them; the r-th runs of all slots
    in one walk), the partials merged in run order as the last CTA merges
    them (M the largest m, each scaled by exp2(m - M)); a single run writes
    o from its own state -> o bf16."""
    S, n_q, d = q.shape
    page = k_pages.shape[2]
    counts = [-(-int(n) // page) for n in lengths]
    per = [-(-c // splits) for c in counts]
    runs = [-(-c // p) if p else 0 for c, p in zip(counts, per)]
    parts = []
    for r in range(max(max(runs), 1)):
        tb = torch.zeros((S, max(max(per), 1)), dtype=torch.int32)
        ln = torch.zeros(S, dtype=torch.int32)
        for b in range(S):
            if r < runs[b]:
                seg = tables[b, r * per[b]:(r + 1) * per[b]]
                tb[b, :len(seg)] = seg
                ln[b] = min(max(int(lengths[b]) - r * per[b] * page, 0), per[b] * page)
        parts.append(tdec.decode_walk(variant.removesuffix("_t"), q, k_pages, v_pages, k_scales,
                                      v_scales, tb, ln)[:3])
    m, l, acc = parts[0]
    O, L = acc.clone(), l.clone()
    for b in range(S):
        if runs[b] > 1:
            M = torch.stack([p[0][b] for p in parts[:runs[b]]]).amax(0)
            O[b], L[b] = 0, 0
            for m_r, l_r, acc_r in parts[:runs[b]]:
                f = torch.exp2(m_r[b] - M)
                O[b], L[b] = O[b] + acc_r[b] * f, L[b] + l_r[b] * f
    return (O / torch.where(L == 0, torch.ones_like(L), L)).to(q.dtype).reshape(S, n_q, d)


def _int8_cache(rng, S, n_kv, page, max_pages, lengths):
    """An int8 cache's tensors (random payload and scales, each slot's pages
    drawn at random) with the given lengths: (k_pages, v_pages, k_scales,
    v_scales (n_kv, n_pages, 1, page), tables, lengths)."""
    n_pages = S * max_pages + 1
    pages = [torch.from_numpy(rng.integers(-127, 128, (n_kv, n_pages, page, 128)).astype(np.int8))
             for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(0.005, 0.02, (n_kv, n_pages, 1, page))
                               .astype(np.float32)) for _ in range(2)]
    tables = torch.from_numpy(rng.permutation(n_pages)[:S * max_pages].reshape(S, max_pages)
                              .astype(np.int32))
    return (*pages, *scales, tables, torch.tensor(lengths, dtype=torch.int32))


# (S, n_kv, n_q, page, max_pages, lengths): decode_case's shape (every live
# page a run of its own), and 45 slots x 2 kv heads (5 splits: runs of 4 of
# 16 pages of 64 keys) at ragged lengths, empty and full slots among them
PAGED_SHAPES = {
    "small": (3, 2, 4, 128, 4, [300, 512, 0]),
    "runs": (45, 2, 8, 64, 16,
             [0, 1024, 1, 63, 64, 65, 700] + [(37 * i) % 1025 for i in range(38)]),
}


@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
@pytest.mark.parametrize("variant", ["postscale", "current"])
def test_paged_split_merge_within_card_gate(variant, shape):
    """``postscale`` and ``current`` cut a slot's live pages over CTAs as
    the serving decode does (``native.exp_decode_plan``) and merge the
    runs' partials in the launch: that model stays within phase 8's gate of
    the unsplit plain version (2 bf16 ulps at the output's scale) over
    paged, ragged slots on several seeds; with one run it is the plain
    version bit for bit."""
    S, n_kv, n_q, page, max_pages, lengths = PAGED_SHAPES[shape]
    splits = tdec.native.exp_decode_plan(variant, S, n_q, n_kv, page, max_pages)["splits"]
    assert splits == (4 if shape == "small" else 5)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        k, v, ks, vs, tables, lens = _int8_cache(rng, S, n_kv, page, max_pages, lengths)
        q = _t(rng.uniform(-1, 1, (S, n_q, 128)), torch.bfloat16)
        args = (q, k, v, tdec.page_major(ks), tdec.page_major(vs), tables, lens)
        want = tdec.paged_decode_plain(variant, *args)
        got = paged_split_model(variant, *args, splits)
        assert not got[lens == 0].any()
        _close(got.float().numpy(), want.float().numpy(), ULPS)
        if seed == 0:
            assert torch.equal(paged_split_model(variant, *args, 1), want)


def test_serving_decode_matches_postscale():
    """``postscale`` is the serving decode's int8 instantiation: on the
    CPU the serving plain decode (causal, scale 1/sqrt(d)) gives
    ``paged_decode_plain("postscale", ...)``'s bits on decode_case's
    cache and on ragged slots of pages of 64."""
    from tf_flash_attention_tpu_torch.serving.decode import paged_decode_attention
    from tf_flash_attention_tpu_torch.serving.kv_cache import KVCacheConfig, PagedKVCache
    for shape in PAGED_SHAPES.values():
        S, n_kv, n_q, page, max_pages, lengths = shape
        rng = np.random.default_rng(9)
        k, v, ks, vs, tables, lens = _int8_cache(rng, S, n_kv, page, max_pages, lengths)
        q = _t(rng.uniform(-1, 1, (S, n_q, 128)), torch.bfloat16)
        cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=128, page_size=page, n_pages=k.shape[1],
                            max_seqs=S, max_pages_per_seq=max_pages, quantized=True)
        got = paged_decode_attention(q, PagedKVCache(k, v, ks, vs, tables, lens), cfg)
        assert torch.equal(got, tdec.paged_decode_plain("postscale_t", q, k, v, ks, vs, tables,
                                                        lens))


# ---- int8mm on the integer mma (kDcS8) ----

def dc_s8_pos(k):
    """decode_tc.cuh's dc_s8_pos: the byte of a 32-key step's p code row
    that holds key k."""
    return (k & 16) | ((k & 6) << 1) | ((k & 8) >> 2) | (k & 1)


def _b_bytes(word):
    return [(word >> (8 * i)) & 0xFF for i in range(4)]


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: result byte i is byte (sel >> 4 i) & 7 of y:x."""
    src = _b_bytes(x) + _b_bytes(y)
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _word(bs):
    return sum((int(b) & 0xFF) << (8 * i) for i, b in enumerate(bs))


def _s8(word):
    return [((b + 128) & 0xFF) - 128 for b in _b_bytes(word)]


def _mma_s8(a, b):
    """mma.sync m16n8k32 s8 on one warp's registers: a[lane] (a0..a3),
    b[lane] (b0, b1) -> d (16, 8), by the PTX fragment layouts."""
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for lane in range(32):
        gq, t = lane >> 2, lane & 3
        for reg, (row, k0) in enumerate(((gq, 0), (gq + 8, 0), (gq, 16), (gq + 8, 16))):
            A[row, k0 + 4 * t:k0 + 4 * t + 4] = _s8(a[lane][reg])
        for reg, k0 in enumerate((0, 16)):
            B[k0 + 4 * t:k0 + 4 * t + 4, gq] = _s8(b[lane][reg])
    return A @ B


def test_int8mm_fragment_orders():
    """kDcS8's products on one 64-key stage, lane by lane as
    ``decode_tc_kernel`` builds them: S = Q K^T with each lane's q codes and
    raw K bytes at d 32 t + 8 ks .. (k-step ks), and O = P V with the p codes
    in dc_s8_pos's order and V from ldmatrix.trans of the restaged tile (a
    lane gets keys 2t, 2t + 1 (+ 8 i in matrix i) of its column pair in
    b16 pairs), sorted by __byte_perm 0x6420 (even column) and 0x7531 (odd
    column), the output column of n-tile nt, element e 16 w + 4 t + 2 e + nt:
    both equal the plain integer products."""
    rng = np.random.default_rng(2)
    qc = rng.integers(-127, 128, (16, 128))
    k = rng.integers(-127, 128, (64, 128))
    v = rng.integers(-127, 128, (64, 128))
    pc = rng.integers(0, 128, (16, 64))
    # scores: warp w's n-tile is keys 8 w .. 8 w + 7
    for w in range(8):
        d = np.zeros((16, 8), np.int64)
        for ks in range(4):
            a = [[_word(qc[r, 32 * (l & 3) + 8 * ks + o:32 * (l & 3) + 8 * ks + o + 4])
                  for r, o in ((l >> 2, 0), ((l >> 2) + 8, 0), (l >> 2, 4), ((l >> 2) + 8, 4))]
                 for l in range(32)]
            b = [[_word(k[8 * w + (l >> 2), 32 * (l & 3) + 8 * ks + o:
                          32 * (l & 3) + 8 * ks + o + 4]) for o in (0, 4)] for l in range(32)]
            d += _mma_s8(a, b)
        np.testing.assert_array_equal(d, qc @ k[8 * w:8 * w + 8].T)
    # p codes as the merge stores them: key 32 i + k at byte 32 i + dc_s8_pos(k)
    stored = np.zeros_like(pc)
    for key in range(64):
        stored[:, (key & ~31) + dc_s8_pos(key & 31)] = pc[:, key]
    ub = (v & 0xFF).astype(np.int64)                 # the restaged tile's bytes
    for w in range(8):
        out = np.zeros((16, 16), np.int64)
        for kk in range(2):
            x = [[0] * 4 for _ in range(32)]
            for l in range(32):
                gq, t = l >> 2, l & 3
                for mi in range(4):          # matrix mi: keys 32 kk + 8 mi .. + 7
                    k0 = 32 * kk + 8 * mi + 2 * t
                    c = 16 * w + 2 * gq
                    x[l][mi] = _word([ub[k0, c], ub[k0, c + 1], ub[k0 + 1, c], ub[k0 + 1, c + 1]])
            a = [[_word(stored[r, 32 * kk + o + 4 * (l & 3):32 * kk + o + 4 * (l & 3) + 4])
                  for r, o in ((l >> 2, 0), ((l >> 2) + 8, 0), (l >> 2, 16), ((l >> 2) + 8, 16))]
                 for l in range(32)]
            for nt, sel in ((0, 0x6420), (1, 0x7531)):
                b = [[_byte_perm(x[l][0], x[l][1], sel), _byte_perm(x[l][2], x[l][3], sel)]
                     for l in range(32)]
                d = _mma_s8(a, b)
                for n in range(8):   # lane (n / 2)'s element n % 2: column 16 w + 2 n + nt
                    out[:, 4 * (n >> 1) + 2 * (n & 1) + nt] += d[:, n]
        np.testing.assert_array_equal(out, pc @ v[:, 16 * w:16 * w + 16])


def int8mm_walk_model(q, k_pages, v_pages, k_scales, v_scales, tables, lengths):
    """kDcS8's walk: one CTA a (slot, kv head), its live pages in order, a
    page a merge: q codes (max |q| / 127, IEEE; rint), per 64-key stage the
    integer scores (the order of d does not change an integer sum) and s =
    si x ((qs x ks) x c); at the page's merge m, p = exp2(s - m), y = p x V
    scale, ps = max y / 127 and the codes rint(y / ps); the page's integer
    P V over its stages, acc = acc x alpha + float(sum) x ps -> (o, q codes,
    integer scores, p codes) as ``paged_decode_plain(..., codes=True)``."""
    S, n_q, d = q.shape
    n_kv, _, page, _ = k_pages.shape
    G, max_pages = n_q // n_kv, tables.shape[1]
    c = torch.tensor(1.0 / np.sqrt(d) * tint4.LOG2E, dtype=torch.float32)
    ks, vs = k_scales.reshape(n_kv, -1, page), v_scales.reshape(n_kv, -1, page)
    o = torch.zeros((S, n_kv, G, d), dtype=q.dtype)
    qcodes = torch.zeros((S, n_kv, G, d), dtype=torch.int8)
    s_int = torch.zeros((S, n_kv, G, max_pages * page), dtype=torch.int32)
    p_codes = torch.zeros((S, n_kv, G, max_pages * page), dtype=torch.int8)
    neg = torch.tensor(tint4.NEG_INF_F32)
    for b in range(S):
        count = -(-int(lengths[b]) // page)
        for h in range(n_kv):
            qf = q[b].float().reshape(n_kv, G, d)[h]
            qs = qf.abs().amax(-1, keepdim=True) / torch.tensor(127.0)
            qs = torch.where(qs == 0, torch.ones_like(qs), qs)
            qc = torch.round(qf / qs)
            qcodes[b, h] = qc.to(torch.int8)
            m, l, acc = torch.full((G, 1), neg.item()), torch.zeros((G, 1)), torch.zeros((G, d))
            for p in range(count):
                phys = int(tables[b, p])
                kk, vv = k_pages[h, phys].long(), v_pages[h, phys].long()
                si = torch.cat([qc.long() @ kk[st:st + 64].T for st in range(0, page, 64)], 1)
                s = si.float() * ((qs * ks[h, phys][None, :]) * c)
                pos = p * page + torch.arange(page)
                s = torch.where(pos[None, :] < lengths[b], s, neg)
                s_int[b, h, :, p * page:(p + 1) * page] = si.to(torch.int32)
                m_next = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_next)
                y = torch.exp2(s - m_next)
                l = alpha * l + y.sum(-1, keepdim=True)
                y = y * vs[h, phys][None, :]
                ps = y.amax(-1, keepdim=True) / torch.tensor(127.0)
                ps = torch.where(ps == 0, torch.ones_like(ps), ps)
                pc = torch.round(y / ps)
                p_codes[b, h, :, p * page:(p + 1) * page] = pc.to(torch.int8)
                pv = sum(pc[:, st:st + 64].long() @ vv[st:st + 64] for st in range(0, page, 64))
                acc = acc * alpha + pv.float() * ps
                m = m_next
            o[b, h] = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    return (o.reshape(S, n_q, d), qcodes.reshape(S, n_q, d), s_int.reshape(S, n_q, -1),
            p_codes.reshape(S, n_q, -1))


@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
def test_int8mm_page_order_walk(shape):
    """int8mm's one-CTA walk in page order takes each page's running
    maximum, so its q codes, integer scores and p codes are the plain
    version's bit for bit (``native.exp_decode_plan`` gives it one split),
    and its o is within the 2-ulp gate."""
    S, n_kv, n_q, page, max_pages, lengths = PAGED_SHAPES[shape]
    S, lengths = min(S, 9), lengths[:9]
    assert tdec.native.exp_decode_plan("int8mm", S, n_q, n_kv, page, max_pages)["splits"] == 1
    rng = np.random.default_rng(4)
    k, v, ks, vs, tables, lens = _int8_cache(rng, S, n_kv, page, max_pages, lengths)
    q = _t(rng.uniform(-1, 1, (S, n_q, 128)), torch.bfloat16)
    want = tdec.paged_decode_plain("int8mm_t", q, k, v, ks, vs, tables, lens, codes=True)
    got = int8mm_walk_model(q, k, v, ks, vs, tables, lens)
    for name, a, b in zip(("q codes", "scores", "p codes"), got[1:], want[1:]):
        assert torch.equal(a, b), name
    _close(got[0].float().numpy(), want[0].float().numpy(), ULPS)
