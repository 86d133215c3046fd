"""The window kernels' host tables and bodies, on the CPU.

The tensor-core window walks (``window_fwd``, ``window_bwd`` on bf16 and
fp16) are the banded walk over blocks of 128: for each 128-row tile the
host gives its sub-block's band as four ints ``[start, i0, i1, end)``,
whose interior ``[i0, i1)`` runs the body compiled without the rule
predicate (``ops/forward.py::window_segments``).  These tests hold those
segments and the scalar bodies' band starts against the numpy mask
(``build_mask``), hold the port's plain window path against JAX's
``_window_kernel`` and ``_fused_window_kernel`` in bf16, and check that
``native.fwd_body`` and ``native.bwd_body`` name the body the C dispatch of
each window launch picks.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.ops import backward as jbwd
from tf_flash_attention_tpu.ops import forward as jfwd
from tf_flash_attention_tpu.sync_modes import make_sync_pack as jpack
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.block_sizes import BlockConfig, choose_block_config
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.ops import backward as tbwd
from tf_flash_attention_tpu_torch.ops import forward as tfwd
from tf_flash_attention_tpu_torch.ops.reference import build_mask
from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack as tpack

from test_kernels import SMALL_BLOCKS
from test_torch_attention import _c_function, _jax_bodies, _np

BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
LANE = 128

# (rule, sync, q_seq, k_seq, d): the window rules of the card tests'
# OP_CASES, the two measured shapes cut to size (a 32 x 32 image at window
# 8; 2,048 tokens at window 512), ragged lengths, and a band with no masked
# element (a non-causal window wider than both sequences)
WINDOW_CASES = {
    "local_stride_1d": (LocalRule(5, 1, True), "scale_front", (220,), (310,), 24),
    "local_2d": (LocalRule(7, 0, False), "scale_end", (10, 22), (20, 11), 24),
    "wide_heads_local": (LocalRule(5, 0, False), "none_front", (260,), (300,), 256),
    "local2d_w8": (LocalRule(8, 0, True), "none_front", (32, 32), (32, 32), 128),
    "local1d_w512": (LocalRule(512, 0, True), "none_front", (2048,), (2048,), 128),
    "ragged": (LocalRule(64, 0, True), "scale_end", (300,), (520,), 128),
    "unmasked": (LocalRule(1000, 0, False), "none_front", (512,), (512,), 128),
}


def _walk_checks(mask, starts, seg, band, sub, stages, other_len):
    """The kernels' walks over ``mask`` (rows: the walking sequence,
    columns: the other): every visible element lies in its row's band
    (``starts``, the scalar bodies') and in its tile's segments (``seg``,
    the tensor-core bodies', walked as kBanded walks them: blocks of 128 cut
    at ``other_len``, each in stages of ``bn``), which lie inside the band,
    and every stage of a block inside ``[i0, i1)`` holds only visible
    elements of rows and columns in bounds.  Returns (interior stages, stages) over all tiles at the first
    stage width."""
    n_rows = mask.shape[0]
    n_tiles, n_other = -(-n_rows // LANE), -(-other_len // LANE)
    assert seg.shape == (n_tiles, 4) and seg.dtype == np.int32
    padded = np.zeros((n_tiles * LANE, n_other * LANE + band), dtype=bool)
    padded[:n_rows, :other_len] = mask
    for r in range(n_rows):
        start, (s, _, _, e) = int(starts[r // sub]), seg[r // LANE]
        cols = np.flatnonzero(mask[r])
        assert cols.size == 0 or (start <= cols[0] and cols[-1] < start + band), r
        assert cols.size == 0 or (s * LANE <= cols[0] and cols[-1] < e * LANE), r
    counts = [0, 0]
    for t in range(n_tiles):
        start = int(starts[t * LANE // sub])
        s, i0, i1, e = (int(x) for x in seg[t])
        assert start <= s * LANE and e * LANE <= start + band and e <= n_other, (t, s, e)
        assert s <= i0 <= i1 <= e, (t, s, i0, i1, e)
        for bn in stages:
            for blk in range(s, e):
                for c0 in range(blk * LANE, min((blk + 1) * LANE, other_len), bn):
                    inside = i0 <= blk < i1
                    if inside:
                        assert padded[t * LANE:(t + 1) * LANE, c0:c0 + bn].all(), (t, bn, c0)
                    if bn == stages[0]:
                        counts[0] += inside
                        counts[1] += 1
    return counts


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_interior_against_mask(case):
    """The segments of the forward walk (128-, 64- and 32-key stages: the
    tensor-core forward's classes) and of the transposed walk (64-row query
    stages) against the dense mask: a stage marked interior holds no
    invisible element, no key past k_len and no query past q_len, and every
    visible element lies inside its band.  At the measured 1-d shape most
    stages are interior; the unmasked band is interior whole."""
    rule, sync, q_seq, k_seq, d = WINDOW_CASES[case]
    pack = tpack(sync, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    mask = build_mask(pack, rule).reshape(q_len, k_len)
    fw = tfwd.forward_route(pack, rule, BLOCKS, d, d)
    (bw,) = tbwd.backward_route(pack, rule, BLOCKS, 1, "kv")
    assert (fw.kernel, bw.kernel) == ("window_fwd", "window_bwd")
    assert fw.masked == (case != "unmasked")
    f_in, f_all = _walk_checks(mask, fw.arrays[0], fw.arrays[1], fw.band, fw.sub,
                               (128, 64, 32), k_len)
    b_in, b_all = _walk_checks(mask.T, bw.arrays[0], bw.arrays[1], bw.band, bw.sub, (64,),
                               q_len)
    if case == "local1d_w512":
        assert f_in >= 0.5 * f_all and b_in >= 0.5 * b_all, (f_in, f_all, b_in, b_all)
    if case == "unmasked":
        assert f_in == f_all


@pytest.mark.parametrize("shape", ["local2d_w8", "local1d_w512"])
def test_measured_shapes_take_the_window_route(shape):
    """The two shapes of the JAX package's window sweep, at their full size
    (bf16, d 128, the block solver's config), route to the window kernels
    with a band of 640 keys over sub-blocks of 128 rows."""
    rule, seq = {"local2d_w8": (LocalRule(8, 0, True), (64, 64)),
                 "local1d_w512": (LocalRule(512, 0, True), (8192,))}[shape]
    pack, cfg = tpack("none_front", seq, seq), choose_block_config(128, 128)
    fw = tfwd.forward_route(pack, rule, cfg, 128, 128)
    (bw,) = tbwd.backward_route(pack, rule, cfg, 1, "kv")
    assert (fw.kernel, fw.band, fw.sub) == ("window_fwd", 640, 128)
    assert (bw.kernel, bw.band, bw.sub) == ("window_bwd", 640, 128)


def test_half_window_rounds_as_jax_kernels(monkeypatch):
    """bf16, d 128, a 32 x 32 image under a causal 2-d window of 8: the
    port's plain forward and backward against JAX's ``_window_kernel`` and
    ``_fused_window_kernel`` (``fast_softmax=False``, interpret mode), the
    backward on the same o, l, m.  Both round p to bf16 before PV and dV,
    and dS before dK and dQ, so they part only where a float32 sum taken in
    another order flips a rounding: on fewer than 1% of each bf16 output's
    elements, with a mean error under 1e-5 (the tolerance of
    ``test_half_backward_rounds_as_jax_kernels``); the float32 l and m
    within 2e-5 at their scale (the summation order only)."""
    B, side, d = 2, 32, 128
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(rng.uniform(-2, 2, (B, side * side, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    seq = (side, side)
    tp, tr, jr = tpack("none_front", seq, seq), LocalRule(8, 0, True), fa.LocalRule(8, 0, True)
    jp = jpack("none_front", seq, seq)
    assert tfwd.forward_route(tp, tr, BLOCKS, d, d).kernel == "window_fwd"
    assert tbwd.backward_route(tp, tr, BLOCKS, 1)[0].kernel == "window_bwd"
    j = lambda x: jnp.asarray(_np(x), jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    bodies, jout = _jax_bodies(monkeypatch, lambda: jfwd.flash_forward(
        j(q), j(k), j(v), pack=jp, rule=jr, config=SMALL_BLOCKS, interpret=True,
        fast_softmax=False), stop=False)
    assert bodies == ["_window_kernel"]
    o, l, m = tfwd.flash_forward(q, k, v, pack=tp, rule=tr, config=BLOCKS)
    bodies, jg = _jax_bodies(monkeypatch, lambda: jbwd.flash_backward(
        j(q), j(k), j(v), j(o), j(l), j(m), j(do), pack=jp, rule=jr, config=SMALL_BLOCKS,
        interpret=True, fast_softmax=False), stop=False)
    assert bodies == ["_fused_window_kernel"]
    got = tbwd.flash_backward(q, k, v, o, l, m, do, pack=tp, rule=tr, config=BLOCKS)
    for name, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), tuple(jout) + tuple(jg),
                          (o, l, m) + tuple(got)):
        assert tuple(b.shape) == a.shape, name
        err = np.abs(_np(b) - _np(a))
        if name in ("l", "m"):
            assert err.max() <= 2e-5 * max(1.0, float(np.abs(_np(a)).max())), (name, err.max())
            continue
        assert (err > 0).mean() < 0.01, (name, (err > 0).mean())
        assert err.mean() < 1e-5, (name, err.mean())


def _c_text(source: str, signature: str) -> str:
    """The C function's text, its whitespace runs as single spaces."""
    return " ".join(_c_function(source, signature).split())


def test_window_body_is_the_c_dispatch():
    """``fwd_body`` and ``bwd_body`` name the body each window launch runs:
    the C dispatches ``window_fwd_any`` and ``window_bwd_any`` take the
    tensor-core bodies' banded walk under ``fwd_on_tc`` (bf16 and fp16 at
    d <= 512) and ``tc_bwd_takes`` (bf16 and fp16 at max(d, v_d) <= 128),
    the rules the reports follow; float32 and wider heads run the scalar
    bodies' window walk, across the head-dim classes."""
    fwd_rule = _c_text("attention_fwd_tc.cuh", "bool fwd_on_tc(")
    assert "return !std::is_same<T, float>::value && a.d <= kTcMaxD;" in fwd_rule
    assert "constexpr int kTcMaxD = 512;" in (
        Path(native.__file__).parent / "csrc" / "attention_fwd_tc.cuh").read_text()
    assert native.TC_MAX_D == 512
    assert ("return a.d <= 128 && a.v_d <= 128 && a.rule.q_len > 0 && a.rule.k_len > 0;"
            in _c_text("attention_bwd_tc.cuh", "bool tc_bwd_takes("))
    fwd = _c_text("band_kernels.cu", "int window_fwd_any(")
    assert ("if constexpr (!std::is_same<T, float>::value) { if (fwd_on_tc<T>(a)) { if (body) "
            "*body = 1; return fwd_tc_any<T, kBanded>(banded_window(a, seg), s); } } "
            "if (body) *body = 0;") in fwd
    bwd = _c_text("band_kernels.cu", "int window_bwd_any(")
    assert ("if constexpr (!std::is_same<T, float>::value) { if (tc_bwd_takes(a)) { if (body) "
            "*body = 1; return tc::bwd_tc<T, kBanded>(banded_window(a, seg), s); } } "
            "if (body) *body = 0; return bwd_kv_any<T, true, kWindow>(a, s);") in bwd
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d, v_d in ((64, 64), (128, 128), (64, 96), (27, 13), (128, 256), (256, 256),
                       (512, 64), (576, 64)):
            half = dtype != torch.float32
            assert native.fwd_body(dtype, d, v_d) == (
                "tensor-core" if half and d <= 512 else "scalar"), (dtype, d, v_d)
            assert native.bwd_body(dtype, d, v_d) == (
                "tensor-core" if half and max(d, v_d) <= 128 else "scalar"), (dtype, d, v_d)
