"""The port's op path against the JAX package, on the CPU.

The same numpy inputs go through the JAX package and the port.  On the CPU
the port's kernels run their plain PyTorch versions; the JAX side is its
dense oracle (``reference_attention``) for the whole case matrix of
``tests/test_kernels.py``, and its table-driven Pallas kernels in
interpret mode for a few cases (the banded and window routes switched off
with the package's own environment switches, so the kernels the port
mirrors run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_flash_attention_tpu as fa
import tf_flash_attention_tpu_torch.api as ta
from tf_flash_attention_tpu.ops import backward as jbwd
from tf_flash_attention_tpu.ops import forward as jfwd
from tf_flash_attention_tpu.ops.reference import reference_attention
from tf_flash_attention_tpu.sync_modes import make_sync_pack as jpack
from tf_flash_attention_tpu.utils import dtypes as jdtypes
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.block_sizes import BlockConfig
from tf_flash_attention_tpu_torch.ops import backward as tbwd
from tf_flash_attention_tpu_torch.ops import forward as tfwd
from tf_flash_attention_tpu_torch.ops import reference as tref
from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack as tpack
from tf_flash_attention_tpu_torch.utils import dtypes as tdtypes

from _torch_cases import fuzz_case
from test_kernels import ATTENTION_CASES, CASE_MATRIX, SHAPES_1D, SHAPES_2D, SMALL_BLOCKS

BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _port_rule(rule):
    """The port's rule equal to a JAX package rule (the carried copies)."""
    return trules.make_rule(
        {"FullRule": "full", "CausalRule": "causal", "LocalRule": "local"}[type(rule).__name__],
        **({} if not hasattr(rule, "window_size") else dict(
            window_size=rule.window_size, log2_stride_size=rule.log2_stride_size,
            is_causal=rule.is_causal)))


def _data(shapes, seed=0):
    rng = np.random.default_rng(seed)
    q_seq, k_seq, d, v_d = shapes["q_seq"], shapes["k_seq"], shapes["d"], shapes["v_d"]
    t = lambda shape: rng.uniform(-2.0, 2.0, (2,) + shape).astype(np.float32)
    return t((d,) + q_seq), t((d,) + k_seq), t((v_d,) + k_seq), t((v_d,) + q_seq)


def _tol(dtype, n):
    """The reference's tolerance model: 1e-6·n fp32, 1e-3·n half."""
    tol = (1e-3 if dtype.itemsize == 2 else 1e-6) * n
    return dict(rtol=tol, atol=tol)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("seq_dims", [1, 2], ids=["1d", "2d"])
@pytest.mark.parametrize("case,sync_mode", CASE_MATRIX, ids=[f"{c}-{m}" for c, m in CASE_MATRIX])
def test_matches_jax_reference(case, sync_mode, seq_dims):
    """Forward (O, l, m: values and dtypes) and the three gradients of the
    port's ``flash_attention`` against the JAX dense oracle, fp32."""
    shapes = SHAPES_1D if seq_dims == 1 else SHAPES_2D
    Q, K, V, dO = _data(shapes)
    rule = ATTENTION_CASES[case]
    n_q, n_k = int(np.prod(shapes["q_seq"])), int(np.prod(shapes["k_seq"]))

    (o1, l1, m1), vjp = jax.vjp(
        lambda q, k, v: reference_attention(q, k, v, rule=rule, sync_mode=sync_mode,
                                            seq_dims=seq_dims, returning_l_m=True),
        jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V))
    g1 = vjp((jnp.asarray(dO), jnp.zeros_like(l1), jnp.zeros_like(m1)))

    Qt, Kt, Vt = (torch.tensor(x, requires_grad=True) for x in (Q, K, V))
    o2, l2, m2 = ta.flash_attention(Qt, Kt, Vt, rule=_port_rule(rule), sync_mode=sync_mode,
                                    seq_dims=seq_dims, returning_l_m=True, block_config=BLOCKS)
    g2 = torch.autograd.grad(o2, (Qt, Kt, Vt), torch.from_numpy(dO))

    tol = _tol(torch.float32, n_k)
    for name, a, b in (("O", o1, o2), ("l", l1, l2), ("m", m1, m2)):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **tol)
    assert l2.dtype == m2.dtype == torch.float32
    for name, a, b, n in zip(("dQ", "dK", "dV"), g1, g2, (n_k, n_q, n_q)):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **_tol(torch.float32, n))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_half_matches_jax_reference(dtype):
    Q, K, V, dO = _data(SHAPES_1D, seed=1)
    rule = ATTENTION_CASES["local_stride_causal"]
    jx = [jnp.asarray(x, _JNP[dtype]) for x in (Q, K, V, dO)]
    (o1, l1, m1), vjp = jax.vjp(
        lambda q, k, v: reference_attention(q, k, v, rule=rule, sync_mode="scale_end",
                                            returning_l_m=True), *jx[:3])
    g1 = vjp((jx[3], jnp.zeros_like(l1), jnp.zeros_like(m1)))
    tx = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (Q, K, V)]
    o2, l2, m2 = ta.flash_attention(*tx, rule=_port_rule(rule), sync_mode="scale_end",
                                    returning_l_m=True, block_config=BLOCKS)
    g2 = torch.autograd.grad(o2, tx, torch.tensor(dO).to(dtype))
    tol = _tol(dtype, 310)
    for name, a, b in (("O", o1, o2), ("l", l1, l2), ("m", m1, m2)) + tuple(
            zip(("dQ", "dK", "dV"), g1, g2)):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **tol)
    assert (o2.dtype, l2.dtype, m2.dtype) == (dtype, torch.float32, dtype)


@pytest.mark.parametrize("run", range(8))
def test_fuzz_matches_jax_reference(run):
    kind, kw, sync, q_seq, k_seq, d, v_d, g = fuzz_case(run)
    seq_dims = len(q_seq)
    rng = np.random.default_rng(run)
    t = lambda shape: rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    Q, K, V, dO = t((g, d) + q_seq), t((g, d) + k_seq), t((g, v_d) + k_seq), t((g, v_d) + q_seq)
    jrule = {"full": fa.FullRule, "causal": fa.CausalRule, "local": fa.LocalRule}[kind](**kw)
    (o1, l1, m1), vjp = jax.vjp(
        lambda q, k, v: reference_attention(q, k, v, rule=jrule, sync_mode=sync,
                                            seq_dims=seq_dims, returning_l_m=True),
        jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V))
    g1 = vjp((jnp.asarray(dO), jnp.zeros_like(l1), jnp.zeros_like(m1)))
    Qt, Kt, Vt = (torch.tensor(x, requires_grad=True) for x in (Q, K, V))
    o2, l2, m2 = ta.flash_attention(Qt, Kt, Vt, rule=trules.make_rule(kind, **kw),
                                    sync_mode=sync, seq_dims=seq_dims, returning_l_m=True,
                                    block_config=BLOCKS)
    g2 = torch.autograd.grad(o2, (Qt, Kt, Vt), torch.from_numpy(dO))
    n_q, n_k = int(np.prod(q_seq)), int(np.prod(k_seq))
    label = f"run {run}: {kind} {kw} {sync} {q_seq} {k_seq} d {d} v_d {v_d}"
    for name, a, b, n in zip(("O", "l", "m", "dQ", "dK", "dV"), (o1, l1, m1) + tuple(g1),
                             (o2, l2, m2) + tuple(g2), (n_k, n_k, n_k, n_k, n_q, n_q)):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=f"{label} {name}",
                                   **_tol(torch.float32, n))


# cases run through JAX's table-driven kernels in interpret mode:
# (rule, sync, q_seq, k_seq, d, v_d, g)
KERNEL_CASES = {
    "causal": (ATTENTION_CASES["causal"], "scale_front", (300,), (520,), 32, 24, 1),
    "local_stride_causal": (ATTENTION_CASES["local_stride_causal"], "none_front", (384,),
                            (384,), 32, 24, 1),
    "local_2d": (ATTENTION_CASES["local"], "scale_end", (10, 22), (20, 11), 24, 12, 1),
    "causal_gqa": (ATTENTION_CASES["causal"], "none_front", (256,), (256,), 16, 16, 2),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_matches_jax_kernels(monkeypatch, case, fused):
    """``flash_forward``/``flash_backward`` against JAX's ``_fwd_kernel``,
    ``_fused_kernel`` and the split pair in interpret mode, fp32: the two
    compute the same products in another order, so they agree to a few
    float32 ulps of each output's scale (atol 2e-5 · max |x|)."""
    for var in ("FA_BANDED", "FA_BANDED_BWD", "FA_WINDOW", "FA_WINDOW_BWD"):
        monkeypatch.setenv(var, "0")
    rule, sync, q_seq, k_seq, d, v_d, g = KERNEL_CASES[case]
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    rng = np.random.default_rng(7)
    q, k, v = (rng.uniform(-2, 2, s).astype(np.float32)
               for s in ((2 * g, q_len, d), (2, k_len, d), (2, k_len, v_d)))
    do = rng.uniform(-2, 2, (2 * g, q_len, v_d)).astype(np.float32)

    jp = jpack(sync, q_seq, k_seq)
    jo, jl, jm = jfwd.flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pack=jp,
                                    rule=rule, config=SMALL_BLOCKS, interpret=True)
    jg = jbwd.flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl, jm,
                             jnp.asarray(do), pack=jp, rule=rule, config=SMALL_BLOCKS,
                             interpret=True, fused=fused)

    tp, tr = tpack(sync, q_seq, k_seq), _port_rule(rule)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tl, tm = tfwd.flash_forward(tq, tk, tv, pack=tp, rule=tr, config=BLOCKS)
    tg = tbwd.flash_backward(tq, tk, tv, to, tl, tm, tdo, pack=tp, rule=tr, config=BLOCKS,
                             fused="kv" if fused else False)
    for name, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), (jo, jl, jm) + tuple(jg),
                          (to, tl, tm) + tuple(tg)):
        want = _np(a)
        np.testing.assert_allclose(_np(b), want, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"{case} {name}")


@pytest.mark.parametrize("route", ["banded", "table"])
def test_half_forward_rounds_p_as_jax_kernels(monkeypatch, route):
    """bf16, causal (2, 512, 64): the port's plain forward against JAX's
    ``_banded_kernel`` / ``_fwd_kernel`` (``fast_softmax=False``, interpret
    mode).  Both round p to bf16 before PV while l sums the float32 p, so
    they part only where the online and the dense softmax round p against
    different maxima: within one bf16 ulp at the output's scale (2**-8 ·
    max |o|), on fewer than half the elements and with less than half the
    mean error of the forward that keeps p in float32 (which parts by up to
    2**-7 on a third of them)."""
    if route == "table":
        for var in ("FA_BANDED", "FA_WINDOW"):
            monkeypatch.setenv(var, "0")
    B, S, d = 2, 512, 64
    rng = np.random.default_rng(3)
    q, k, v = (rng.uniform(-2, 2, (B, S, d)).astype(np.float32) for _ in range(3))
    jp, tp, tr = jpack("none_front", (S,), (S,)), tpack("none_front", (S,), (S,)), \
        trules.CausalRule()
    bodies, out = _jax_bodies(monkeypatch, lambda: jfwd.flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), pack=jp, rule=fa.CausalRule(),
        config=SMALL_BLOCKS, interpret=True, fast_softmax=False), stop=False)
    assert bodies == [{"banded": "_banded_kernel", "table": "_fwd_kernel"}[route]]
    want = _np(out[0])
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _np(tfwd.flash_forward(tq, tk, tv, pack=tp, rule=tr, config=BLOCKS)[0])
    unrounded = _np(tfwd._flash_forward_plain(tfwd.prescale(tq, d ** -0.5).float(), tk.float(),
                                              tv.float(), tp, tr)[0].to(torch.bfloat16))
    err, err_f32 = np.abs(got - want), np.abs(unrounded - want)
    assert err.max() <= 2.0 ** -8 * np.abs(want).max()
    assert (err > 0).sum() < 0.5 * (err_f32 > 0).sum()
    assert err.mean() < 0.5 * err_f32.mean()


# the JAX backward bodies of each route, and the switches and ``fused``
# argument that select them
_HALF_BWD_ROUTES = {"banded": ({"FA_WINDOW_BWD": "0"}, None, ["_fused_banded_kernel"]),
                    "table": ({"FA_BANDED_BWD": "0", "FA_WINDOW_BWD": "0"}, None,
                              ["_fused_kernel"]),
                    "split": ({}, False, ["_dq_kernel", "_dkv_kernel"]),
                    "qouter": ({}, "q", ["_fused_qouter_kernel"])}


@pytest.mark.parametrize("route", list(_HALF_BWD_ROUTES))
def test_half_backward_rounds_as_jax_kernels(monkeypatch, route):
    """bf16, causal (2, 256, 64): the port's plain backward against JAX's
    ``_fused_banded_kernel``, ``_fused_kernel``, the split pair and
    ``_fused_qouter_kernel`` (``fast_softmax=False``, interpret mode) on the
    same o, l, m.  Both round
    p to bf16 before dV and dS before dK and dQ, so they part only where a
    float32 sum taken in another order flips a rounding: on fewer than 1% of
    each gradient's elements, with a mean error under 1e-5 (a backward that
    keeps p and dS in float32 parts on about 40%, mean about 3e-4)."""
    env, fused, want_bodies = _HALF_BWD_ROUTES[route]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    B, S, d = 2, 256, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.uniform(-2, 2, (B, S, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    tp, tr = tpack("none_front", (S,), (S,)), trules.CausalRule()
    o, l, m = tfwd.flash_forward(q, k, v, pack=tp, rule=tr, config=BLOCKS)
    j = lambda x: jnp.asarray(_np(x), jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    bodies, jg = _jax_bodies(monkeypatch, lambda: jbwd.flash_backward(
        j(q), j(k), j(v), j(o), j(l), j(m), j(do), pack=jpack("none_front", (S,), (S,)),
        rule=fa.CausalRule(), config=SMALL_BLOCKS, interpret=True, fast_softmax=False,
        fused=fused), stop=False)
    assert bodies == want_bodies
    got = tbwd.flash_backward(q, k, v, o, l, m, do, pack=tp, rule=tr, config=BLOCKS, fused=fused)
    for name, a, b in zip(("dq", "dk", "dv"), jg, got):
        err = np.abs(_np(b) - _np(a))
        assert (err > 0).mean() < 0.01, (name, (err > 0).mean())
        assert err.mean() < 1e-5, (name, err.mean())


# head dims past the old 256 cap: the CUDA kernels take them (a third tile
# class, output columns past 512 over grid z); on the CPU the op path and
# the block solver must take them too
@pytest.mark.parametrize("d,v_d", [(384, 384), (64, 576), (576, 64)])
def test_wide_head_dims_match_jax_reference(d, v_d):
    rng = np.random.default_rng(d + v_d)
    t = lambda shape: rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    Q, K, V, dO = t((2, d, 80)), t((2, d, 96)), t((2, v_d, 96)), t((2, v_d, 80))
    rule = fa.CausalRule()
    (o1, l1, m1), vjp = jax.vjp(
        lambda q, k, v: reference_attention(q, k, v, rule=rule, sync_mode="scale_end",
                                            returning_l_m=True),
        jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V))
    g1 = vjp((jnp.asarray(dO), jnp.zeros_like(l1), jnp.zeros_like(m1)))
    Qt, Kt, Vt = (torch.tensor(x, requires_grad=True) for x in (Q, K, V))
    o2, l2, m2 = ta.flash_attention(Qt, Kt, Vt, rule=trules.CausalRule(), sync_mode="scale_end",
                                    returning_l_m=True)   # the block solver picks the config
    g2 = torch.autograd.grad(o2, (Qt, Kt, Vt), torch.from_numpy(dO))
    for name, a, b, n in zip(("O", "l", "m", "dQ", "dK", "dV"), (o1, l1, m1) + tuple(g1),
                             (o2, l2, m2) + tuple(g2), (96, 96, 96, 96, 80, 80)):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **_tol(torch.float32, n))


def test_choose_block_config_takes_any_head_dims():
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    for d, v_d in ((128, 128), (384, 384), (64, 576), (1024, 96)):
        assert choose_block_config(d, v_d) == BLOCKS


def test_kernel_shared_memory_guards():
    """The wrappers' memory guards mirror the kernels' shared memory: every
    class fits at its widest head dims, and what does not fit raises a
    ValueError naming shared memory instead of reaching the kernel."""
    for d, v_d in ((128, 128), (256, 256), (512, 512), (64, 576), (1024, 1024)):
        assert native.fwd_smem(d, v_d) <= native.MAX_SMEM
    for d, v_d in ((128, 128), (256, 256), (512, 512), (64, 576), (384, 1024)):
        assert native.bwd_smem(d, v_d, 2) <= native.MAX_SMEM
    for d, v_d in ((128, 128), (256, 256), (512, 512), (512, 2048), (64, 576)):
        assert native.tc_fwd_smem(d, v_d) <= native.MAX_SMEM
    native._check_fwd_smem("flash_fwd", torch.float32, 1024, 1024)
    # half heads past the tensor-core classes run the scalar body
    native._check_fwd_smem("flash_fwd", torch.bfloat16, 576, 64)
    assert native.fwd_body(torch.bfloat16, 576, 64) == "scalar"
    with pytest.raises(ValueError, match="shared memory"):
        native._check_smem("flash_bwd_fused", native.bwd_smem(1024, 1024, 2))


@pytest.mark.parametrize("dtype,d,v_d,body", [
    (torch.bfloat16, 128, 128, "tensor-core"), (torch.float16, 27, 13, "tensor-core"),
    (torch.bfloat16, 64, 96, "tensor-core"), (torch.bfloat16, 128, 256, "scalar"),
    (torch.float16, 384, 384, "scalar"), (torch.float32, 64, 64, "scalar")])
def test_fused_backward_body(dtype, d, v_d, body):
    """``flash_bwd_fused`` and ``banded_bwd`` run the tensor-core backward on
    bf16 and fp16 at max(d, v_d) <= 128 and the scalar body elsewhere
    (float32: TF32 would not hold its limit); the memory guard follows the
    body, and both bodies fit the H100's shared memory."""
    assert native.bwd_body(dtype, d, v_d) == body
    assert native.TC_BWD_SMEM <= native.MAX_SMEM
    native._check_bwd_smem("banded_bwd", dtype, d, v_d)


@pytest.mark.parametrize("dtype,d,v_d,body", [
    (torch.bfloat16, 128, 128, "tensor-core"), (torch.float16, 64, 64, "tensor-core"),
    (torch.bfloat16, 60, 40, "tensor-core"), (torch.float16, 128, 64, "tensor-core"),
    (torch.bfloat16, 128, 256, "scalar"), (torch.bfloat16, 384, 384, "scalar"),
    (torch.float32, 128, 128, "scalar"), (torch.float32, 64, 64, "scalar")])
def test_qouter_backward_body(dtype, d, v_d, body):
    """``flash_bwd_qouter`` runs the tensor-core q-outer body on bf16 and fp16
    at max(d, v_d) <= 128 (any width there: d 60 takes the plain-load
    staging) and the scalar body on float32 and wider heads, the rule of the
    kv-outer backward; its memory guard follows the body it runs."""
    assert native.bwd_body(dtype, d, v_d) == body
    native._check_bwd_smem("flash_bwd_qouter", dtype, d, v_d)


@pytest.mark.parametrize("q_len,k_len", [(0, 64), (64, 0), (0, 0)])
def test_backward_body_empty_inputs(q_len, k_len):
    """An empty q or k takes the scalar body in the C dispatches of the
    fused and q-outer backwards (``bwd_fused_any``, ``bwd_qouter_any``), and
    ``bwd_body`` says so."""
    for dtype in (torch.bfloat16, torch.float16):
        assert native.bwd_body(dtype, 128, 128, q_len, k_len) == "scalar"
        assert native.bwd_body(dtype, 128, 128, 64, 64) == "tensor-core"


def test_qouter_tc_shared_memory():
    """The tensor-core q-outer backward's shared memory, pinned to the C
    ``kQoSmem``: Q and dO (128 rows, 32 KB each), two 64-key K / V stages (32
    KB each), the T(P) and T(dS) tiles (16 KB each), a 32 KB float partial
    per consumer warpgroup, the rows' lse2 and delta, five barriers and 1 KB
    of alignment: one CTA an SM, within 1 KB of the H100's block limit."""
    assert native.QOUTER_TC_SMEM == 231464
    assert native.QOUTER_TC_SMEM <= native.MAX_SMEM < native.QOUTER_TC_SMEM + 1024


@pytest.mark.parametrize("dtype,d,v_d,body", [
    (torch.bfloat16, 128, 128, "tensor-core"), (torch.float16, 128, 128, "tensor-core"),
    (torch.bfloat16, 256, 256, "tensor-core"), (torch.float16, 256, 64, "tensor-core"),
    (torch.bfloat16, 512, 512, "tensor-core"), (torch.float16, 512, 64, "tensor-core"),
    (torch.bfloat16, 576, 64, "scalar"), (torch.float16, 576, 576, "scalar"),
    (torch.float32, 128, 128, "scalar"), (torch.float32, 576, 64, "scalar")])
def test_forward_body(dtype, d, v_d, body):
    """``flash_fwd``, ``banded_fwd`` and ``resident_fwd`` run the
    tensor-core forward on bf16 and fp16 at d <= 512 and the scalar body
    elsewhere (float32: TF32 would not hold its limit); the memory guard
    follows the body and passes on both."""
    assert native.fwd_body(dtype, d, v_d) == body
    for name in ("flash_fwd", "banded_fwd", "resident_fwd"):
        native._check_fwd_smem(name, dtype, d, v_d)


@pytest.mark.parametrize("d,v_d,smem", [(128, 128, 164920), (256, 256, 197688),
                                        (512, 64, 230456), (64, 576, 197688)])
def test_resident_tc_shared_memory(d, v_d, smem):
    """The resident forward's tensor-core classes (128-, 64- and 32-key
    stages) fit one block of the H100 (one CTA an SM: the persistent grid is
    the 132 SMs), with the six barriers of the persistent walk (Q full and
    empty, two full and two empty stages) and its item slot."""
    assert native.tc_fwd_smem(d, v_d) == smem <= native.MAX_SMEM
    assert 2 * smem > native.MAX_SMEM
    native._check_fwd_smem("resident_fwd", torch.bfloat16, d, v_d)


# the port's kernel for each Pallas kernel body of the JAX package
_PORT_KERNEL = {"_fwd_kernel": "flash_fwd", "_banded_kernel": "banded_fwd",
                "_window_kernel": "window_fwd", "_resident_kernel": "resident_fwd",
                "_fused_kernel": "flash_bwd_fused", "_fused_banded_kernel": "banded_bwd",
                "_fused_window_kernel": "window_bwd", "_fused_qouter_kernel": "flash_bwd_qouter",
                "_dq_kernel": "flash_bwd_dq"}


class _Routed(Exception):
    pass


def _jax_bodies(monkeypatch, fn, stop):
    """Names of the Pallas kernel bodies a JAX call reaches, in order.  With
    ``stop`` the first ``pallas_call`` raises instead of running."""
    from jax.experimental import pallas as pl
    seen, real = [], pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        if stop:
            raise _Routed
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    try:
        out = fn()
    except _Routed:
        out = None
    monkeypatch.setattr(pl, "pallas_call", real)
    return seen, out


_SWITCHES = ("FA_BANDED", "FA_WINDOW", "FA_BANDED_BWD", "FA_WINDOW_BWD")

# (rule, sync, q_seq, k_seq, g, environment)
ROUTE_CASES = {
    **{f"{c}-{m}-{nd}d": (ATTENTION_CASES[c], m, sh["q_seq"], sh["k_seq"], 1, {})
       for c, m in CASE_MATRIX for nd, sh in ((1, SHAPES_1D), (2, SHAPES_2D))},
    "causal_slice": (ATTENTION_CASES["causal"], "none_front", (2048,), (2048,), 1, {}),
    "causal_gqa4": (ATTENTION_CASES["causal"], "none_front", (1024,), (1024,), 4, {}),
    "local_1d_qk": (fa.LocalRule(5, 1, True), "scale_front", (1500,), (2000,), 1, {}),
    "local_2d_wide": (fa.LocalRule(7, 0, False), "scale_end", (32, 48), (48, 32), 1, {}),
    "causal_switches_off": (ATTENTION_CASES["causal"], "none_front", (1024,), (1024,), 1,
                            {v: "0" for v in _SWITCHES}),
    "causal_split": (ATTENTION_CASES["causal"], "none_front", (1024,), (1024,), 1,
                     {"FA_FUSED_BWD": "0"}),
    "causal_resident": (ATTENTION_CASES["causal"], "none_front", (1024,), (1024,), 1,
                        {"FA_RESIDENT": "1"}),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_routes_match_jax(monkeypatch, case):
    """For every case the port launches the counterpart of the Pallas kernel
    the JAX package runs (its first ``pallas_call`` is intercepted, so no
    kernel runs)."""
    rule, sync, q_seq, k_seq, g, env = ROUTE_CASES[case]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    d = v_d = 16
    q, o = jnp.zeros((g, q_len, d)), jnp.zeros((g, q_len, v_d))
    k, v, l = jnp.zeros((1, k_len, d)), jnp.zeros((1, k_len, v_d)), jnp.ones((g, q_len))
    jp = jpack(sync, q_seq, k_seq)
    (fwd,), _ = _jax_bodies(monkeypatch, lambda: jfwd.flash_forward(
        q, k, v, pack=jp, rule=rule, config=SMALL_BLOCKS, interpret=True), stop=True)
    (bwd,), _ = _jax_bodies(monkeypatch, lambda: jbwd.flash_backward(
        q, k, v, o, l, l, o, pack=jp, rule=rule, config=SMALL_BLOCKS, interpret=True),
        stop=True)
    tp, tr = tpack(sync, q_seq, k_seq), _port_rule(rule)
    assert tfwd.forward_route(tp, tr, BLOCKS, d, v_d).kernel == _PORT_KERNEL[fwd]
    assert tbwd.backward_route(tp, tr, BLOCKS, g)[0].kernel == _PORT_KERNEL[bwd]


def test_compute_subtiling_selects_the_table_forward():
    """Explicit compute sub-tiling selects the table kernel in both packages
    (``forward.py:360-365``); the port's kernels ignore the sub-tile size."""
    tp, tr = tpack("none_front", (1024,), (1024,)), trules.CausalRule()
    sub = BlockConfig(256, 256, 128, 128, 128, 128, block_q_compute=128)
    assert tfwd.forward_route(tp, tr, BLOCKS, 64, 64).kernel == "banded_fwd"
    assert tfwd.forward_route(tp, tr, sub, 64, 64).kernel == "flash_fwd"


def test_window_forward_band_fits_shared_memory():
    """``window_fwd`` holds its band's scores in shared memory: the widest
    lane-aligned band it takes at d = v_d = 128 is 1408 keys (wider bands
    route to the banded kernel), and 1280 at d = v_d = 256."""
    for dim, widest in ((128, 1408), (256, 1280)):
        assert native.window_fwd_smem(widest, dim, dim) <= native.MAX_SMEM
        assert native.window_fwd_smem(widest + 128, dim, dim) > native.MAX_SMEM


# cases run through JAX's banded, window, resident and q-outer kernels in
# interpret mode: (rule, sync, q_seq, k_seq, d, v_d, g), the bodies JAX
# runs, and the environment and ``fused`` argument that select them
BAND_CASES = {
    "causal": ((ATTENTION_CASES["causal"], "scale_front", (512,), (520,), 32, 24, 1),
               ("_banded_kernel", "_fused_banded_kernel")),
    "full": ((ATTENTION_CASES["full"], "none_front", (200,), (130,), 16, 40, 1),
             ("_banded_kernel", "_fused_banded_kernel")),
    "causal_gqa": ((ATTENTION_CASES["causal"], "none_front", (512,), (512,), 16, 16, 2),
                   ("_banded_kernel", "_fused_banded_kernel")),
    "local_stride_causal": ((ATTENTION_CASES["local_stride_causal"], "scale_front", (300,),
                             (410,), 32, 24, 1), ("_window_kernel", "_fused_window_kernel")),
    "local_2d": ((ATTENTION_CASES["local"], "scale_end", (10, 22), (20, 11), 24, 12, 1),
                 ("_window_kernel", "_fused_window_kernel")),
    "resident": ((ATTENTION_CASES["causal"], "scale_end", (512,), (400,), 16, 24, 1),
                 ("_resident_kernel", "_fused_banded_kernel"), {"FA_RESIDENT": "1"}),
    "qouter_gqa": ((ATTENTION_CASES["local_causal"], "none_front", (300,), (300,), 16, 8, 4),
                   ("_window_kernel", "_fused_qouter_kernel"), {}, "q"),
}


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_matches_jax_band_kernels(monkeypatch, case):
    """``flash_forward``/``flash_backward`` against JAX's ``_banded_kernel``,
    ``_window_kernel``, ``_resident_kernel``, ``_fused_banded_kernel``,
    ``_fused_window_kernel`` and ``_fused_qouter_kernel`` in interpret mode,
    fp32, with the tolerance of ``test_matches_jax_kernels``; the port
    routes each case to the counterpart kernel."""
    (rule, sync, q_seq, k_seq, d, v_d, g), bodies, *select = BAND_CASES[case]
    env, fused = select + [{}, None][len(select):]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    rng = np.random.default_rng(11)
    q, k, v = (rng.uniform(-2, 2, s).astype(np.float32)
               for s in ((2 * g, q_len, d), (2, k_len, d), (2, k_len, v_d)))
    do = rng.uniform(-2, 2, (2 * g, q_len, v_d)).astype(np.float32)

    jp = jpack(sync, q_seq, k_seq)
    seen_f, (jo, jl, jm) = _jax_bodies(monkeypatch, lambda: jfwd.flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pack=jp, rule=rule,
        config=SMALL_BLOCKS, interpret=True), stop=False)
    seen_b, jg = _jax_bodies(monkeypatch, lambda: jbwd.flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl, jm, jnp.asarray(do),
        pack=jp, rule=rule, config=SMALL_BLOCKS, interpret=True, fused=fused), stop=False)
    assert (seen_f, seen_b) == ([bodies[0]], [bodies[1]])

    tp, tr = tpack(sync, q_seq, k_seq), _port_rule(rule)
    assert tfwd.forward_route(tp, tr, BLOCKS, d, v_d).kernel == _PORT_KERNEL[bodies[0]]
    assert tbwd.backward_route(tp, tr, BLOCKS, g, fused)[0].kernel == _PORT_KERNEL[bodies[1]]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tl, tm = tfwd.flash_forward(tq, tk, tv, pack=tp, rule=tr, config=BLOCKS)
    tg = tbwd.flash_backward(tq, tk, tv, to, tl, tm, tdo, pack=tp, rule=tr, config=BLOCKS,
                             fused=fused)
    for name, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), (jo, jl, jm) + tuple(jg),
                          (to, tl, tm) + tuple(tg)):
        want = _np(a)
        np.testing.assert_allclose(_np(b), want, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"{case} {name}")


def test_port_oracle_matches_jax_oracle():
    Q, K, V, _ = _data(SHAPES_2D, seed=2)
    rule = ATTENTION_CASES["local_stride_causal"]
    kw = dict(sync_mode="scale_front", seq_dims=2, returning_l_m=True)
    want = reference_attention(*(jnp.asarray(x) for x in (Q, K, V)), rule=rule, **kw)
    got = tref.reference_attention(*(torch.from_numpy(x) for x in (Q, K, V)),
                                   rule=_port_rule(rule), **kw)
    for name, a, b in zip("Olm", want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5, err_msg=name)


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """The CUDA wrappers validate before any pointer reaches a kernel."""
    pack = tpack("none_front", (64,), (64,))
    rule_c = native.fa_rule(pack, trules.CausalRule())
    x = torch.zeros((2, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        native.flash_fwd(x, x, x, rule_c, None, 128, 128)

    class EveryOther(trules.MaskRule):
        def check(self, pack, q_coords, k_coords, q_flat, k_flat):
            return (q_flat + k_flat) % 2 == 0

    with pytest.raises(NotImplementedError):
        native.fa_rule(pack, EveryOther())
    # the plain versions take any rule
    o = ta.flash_attention(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2),
                           rule=EveryOther(), block_config=BLOCKS)
    assert o.shape == (2, 16, 64)


def test_backward_routes():
    """``fused`` picks the kernel family as in the JAX package: ``"q"``, and
    ``True`` with a group of more than 2, the q-outer kernel; ``True``
    with a smaller group, ``"kv"`` and auto a kv-outer one; ``False`` the
    split pair."""
    tp, tr = tpack("none_front", (128,), (128,)), trules.CausalRule()
    kernels = lambda g, fused: [r.kernel for r in tbwd.backward_route(tp, tr, BLOCKS, g, fused)]
    for fused in ("q", True):   # g = 4 > 2 with fused=True is the q-outer kernel too
        assert kernels(4, fused) == ["flash_bwd_qouter"]
    assert kernels(2, True) == kernels(4, "kv") == kernels(4, None) == ["window_bwd"]
    assert kernels(4, False) == ["flash_bwd_dq", "flash_bwd_dkv"]


# ---- tests/test_api.py, ported ----

def _api_data(dtype=torch.float32, batch=(2, 3), d=8, v_d=5, q_seq=(40,), k_seq=(52,)):
    rng = np.random.default_rng(0)
    t = lambda s: torch.tensor(rng.uniform(-1, 1, s), dtype=torch.float32).to(dtype)
    return t(batch + (d,) + q_seq), t(batch + (d,) + k_seq), t(batch + (v_d,) + k_seq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_lm_dtypes(dtype):
    Q, K, V = _api_data(dtype)
    O, l, m = ta.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True,
                           block_config=BLOCKS)
    assert O.dtype == dtype and m.dtype == dtype
    assert l.dtype == tdtypes.l_dtype(dtype)
    assert O.shape == (2, 3, 5, 40) and l.shape == m.shape == (2, 3, 40)


def test_neg_inf_approx_values_match_jax():
    for dtype in (torch.float16, torch.float32, torch.float64, torch.bfloat16,
                  torch.float8_e4m3fn, torch.float8_e5m2):
        jdt = {torch.float64: jnp.float64, torch.float8_e4m3fn: jnp.float8_e4m3fn,
               torch.float8_e5m2: jnp.float8_e5m2}.get(dtype) or _JNP[dtype]
        assert tdtypes.neg_inf_approx(dtype) == jdtypes.neg_inf_approx(jdt), dtype
        assert str(tdtypes.l_dtype(dtype)).split(".")[-1] == str(jdtypes.l_dtype(jdt))
    assert tdtypes.neg_inf_approx(torch.float32) == np.frombuffer(b"\xfa" * 4, np.float32)[0]
    assert tdtypes.neg_inf_approx(torch.bfloat16) == float(
        np.frombuffer(b"\x00\x00\xfa\xfa", np.float32)[0])
    with pytest.raises(TypeError):
        tdtypes.canonical_dtype(torch.int32)


def test_validation_errors():
    Q, K, V = _api_data()
    with pytest.raises(ValueError):
        ta.flash_attention(Q, K, V, rule=trules.FullRule(), seq_dims=3)
    with pytest.raises(ValueError):
        ta.causal_1d(Q, K.to(torch.bfloat16), V, sync_mode="none_front")
    with pytest.raises(ValueError):
        ta.causal_1d(Q[:, :1], K, V, sync_mode="none_front")      # batch mismatch
    with pytest.raises(ValueError):
        ta.causal_1d(Q, K[..., :7, :], V, sync_mode="none_front")  # d mismatch
    with pytest.raises(ValueError):
        ta.causal_1d(Q, K[..., :-1], V, sync_mode="none_front")   # K/V sequence mismatch
    with pytest.raises(ValueError):
        ta.causal_1d(Q, K, V, sync_mode="bogus")
    with pytest.raises(ValueError):
        ta.causal_1d(Q, K, V, sync_mode="none_front", implementation="bogus")


def test_float64_chunked_path_not_ported():
    Q, K, V = _api_data(torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.causal_1d(Q, K, V, sync_mode="none_front")
    O = ta.causal_1d(Q, K, V, sync_mode="none_front", implementation="xla")
    assert O.dtype == torch.float64


def test_fp8_inputs_compute_in_bf16():
    Q, K, V = _api_data(torch.float8_e4m3fn)
    O, l, m = ta.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True,
                           block_config=BLOCKS)
    assert O.dtype == m.dtype == torch.float8_e4m3fn and l.dtype == torch.float32
    ref = ta.causal_1d(Q.float(), K.float(), V.float(), sync_mode="none_front",
                       implementation="xla")
    # only the fp8 rounding of O itself: e4m3 keeps 3 mantissa bits
    assert float((O.float() - ref).abs().max()) <= 0.5 * float(ref.abs().max()) + 1e-3


def test_xla_and_kernel_paths_agree():
    Q, K, V = _api_data()
    kw = dict(window_size=5, log2_stride_size=1, is_causal=True, sync_mode="scale_front")
    o1 = ta.local_1d(Q, K, V, block_config=BLOCKS, **kw)
    o2 = ta.local_1d(Q, K, V, implementation="xla", **kw)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5, atol=1e-5)


def test_fully_masked_rows():
    """scale_end causal with q longer than k: query 0 precedes every key and
    yields O = 0, l = 0, m = neg_inf_approx, and zero gradients."""
    rng = np.random.default_rng(3)
    Q = torch.tensor(rng.uniform(-1, 1, (1, 8, 33)), dtype=torch.float32, requires_grad=True)
    K = torch.tensor(rng.uniform(-1, 1, (1, 8, 4)), dtype=torch.float32)
    V = torch.tensor(rng.uniform(-1, 1, (1, 6, 4)), dtype=torch.float32)
    O, l, m = ta.causal_1d(Q, K, V, sync_mode="scale_end", returning_l_m=True,
                           block_config=BLOCKS)
    assert torch.equal(O[..., 0], torch.zeros_like(O[..., 0]))
    assert float(l[0, 0]) == 0.0
    assert float(m[0, 0]) == np.float32(tdtypes.neg_inf_approx(torch.float32))
    (g,) = torch.autograd.grad(O.sum(), Q)
    assert torch.equal(g[..., 0], torch.zeros_like(g[..., 0]))


def test_custom_scale():
    rng = np.random.default_rng(6)
    t = lambda s: torch.tensor(rng.uniform(-1, 1, s), dtype=torch.float32)
    Q, K, V = t((1, 1, 8, 64)), t((1, 1, 8, 64)), t((1, 1, 8, 64))
    o1 = ta.causal_1d(Q, K, V, sync_mode="none_front", scale=0.5, block_config=BLOCKS)
    o_default = ta.causal_1d(Q, K, V, sync_mode="none_front", block_config=BLOCKS)
    assert not torch.allclose(o1, o_default)
    o2 = ta.causal_1d(0.5 / (8 ** -0.5) * Q, K, V, sync_mode="none_front",
                      block_config=BLOCKS)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4, atol=1e-5)
    # and the same scale as the JAX package gives
    want = fa.causal_1d(jnp.asarray(Q.numpy()), jnp.asarray(K.numpy()),
                        jnp.asarray(V.numpy()), sync_mode="none_front", scale=0.5,
                        implementation="xla")
    np.testing.assert_allclose(o1.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_batchless_and_2d_shapes():
    rng = np.random.default_rng(3)
    t = lambda s: torch.tensor(rng.uniform(-1, 1, s), dtype=torch.float32)
    assert ta.full_1d(t((16, 100)), t((16, 80)), t((8, 80)),
                      block_config=BLOCKS).shape == (8, 100)
    O, l, m = ta.full_2d(t((2, 3, 8, 6, 8)), t((2, 3, 8, 12, 4)), t((2, 3, 5, 12, 4)),
                         returning_l_m=True, block_config=BLOCKS)
    assert O.shape == (2, 3, 5, 6, 8) and l.shape == m.shape == (2, 3, 6, 8)
