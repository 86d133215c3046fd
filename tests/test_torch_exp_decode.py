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

from _torch_parity import cache_cfgs, caches_from, random_state

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
