"""The port's chunked path (``ops/chunked.py``, the float64 route) against
the JAX package's ``flash_attention_xla`` on the same numpy inputs, on the
CPU.  Float64 holds to ``1e-9 * K * 10``: the reference's float64
internal-test class (1e-9 of the reduction length) with the JAX chunked
tests' factor of 10 for gradients; the two sides compute the same
recurrence in float64 and part by summation order (about 1e-15), so a
second limit, ``F64_READ``, holds them far below what a float32
computation would reach."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu.ops.chunked import flash_attention_xla as jax_xla
from tf_flash_attention_tpu.sync_modes import make_sync_pack as jax_pack
import tf_flash_attention_tpu_torch.api as ta
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch.ops.chunked import flash_attention_xla
from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

_JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rules(kind, **kw):
    """The same rule in both packages."""
    cls = {"full": "FullRule", "causal": "CausalRule", "local": "LocalRule"}[kind]
    return getattr(jrules, cls)(**kw), getattr(trules, cls)(**kw)


def _f64_tol(n):
    return 1e-9 * n * 10


# the second float64 limit, from the readings: the chunked path parts from
# JAX's by at most 1e-15 in test_float64_matches_jax's cases, while the same
# inputs computed in float32 part by 3.8e-7 or more, which 1e-9 * K * 10
# (3.1e-6 at K = 310) lets pass; the control below must fail this limit
F64_READ = 1e-11


# (rule, sync mode, q_len, k_len, blocks): JAX test_chunked.py's cases, the
# ragged lengths past a block edge, and a window narrower than a block
CASES = [
    (("full", {}), "none_front", 220, 310, 64),
    (("causal", {}), "scale_front", 128, 320, 64),
    (("local", dict(window_size=5, log2_stride_size=1, is_causal=True)), "scale_front", 128,
     256, 64),
    (("local", dict(window_size=40, is_causal=True)), "none_front", 300, 300, 512),
]


@pytest.mark.parametrize("rule,mode,qs,ks,block", CASES,
                         ids=[f"{r[0]}-{m}-{q}x{k}" for r, m, q, k, _ in CASES])
def test_float64_matches_jax(rule, mode, qs, ks, block):
    """Forward (o, l, m) and the three gradients from the o cotangent."""
    jr, tr = _rules(rule[0], **rule[1])
    rng = np.random.default_rng(qs + ks)
    q, k = rng.uniform(-2, 2, (2, qs, 24)), rng.uniform(-2, 2, (2, ks, 24))
    v, do = rng.uniform(-2, 2, (2, ks, 16)), rng.uniform(-1, 1, (2, qs, 16))

    jp = jax_pack(mode, (qs,), (ks,))
    (o1, l1, m1), vjp = jax.vjp(
        lambda q, k, v: jax_xla(q, k, v, pack=jp, rule=jr, block_q=block, block_kv=block),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g1 = vjp((jnp.asarray(do), jnp.zeros_like(l1), jnp.zeros_like(m1)))

    tx = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o2, l2, m2 = flash_attention_xla(*tx, pack=make_sync_pack(mode, (qs,), (ks,)), rule=tr,
                                     block_q=block, block_kv=block)
    assert o2.dtype == l2.dtype == m2.dtype == torch.float64
    g2 = torch.autograd.grad(o2, tx, torch.tensor(do))
    for name, a, b in zip(("o", "l", "m", "dq", "dk", "dv"), (o1, l1, m1) + tuple(g1),
                          (o2, l2, m2) + tuple(g2)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0,
                                   atol=_f64_tol(max(qs, ks)), err_msg=name)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=F64_READ,
                                   err_msg=name)
    # the control: the same inputs in float32 fail the second limit
    tx32 = [torch.tensor(x, dtype=torch.float32, requires_grad=True) for x in (q, k, v)]
    o3 = flash_attention_xla(*tx32, pack=make_sync_pack(mode, (qs,), (ks,)), rule=tr,
                             block_q=block, block_kv=block)[0]
    g3 = torch.autograd.grad(o3, tx32, torch.tensor(do, dtype=torch.float32))
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o1,) + tuple(g1), (o3,) + tuple(g3)):
        assert float(np.abs(b.detach().double().numpy() - np.asarray(a)).max()) > F64_READ, name


def test_fully_masked_rows():
    """Rows that see no key (a strided causal window under scale_end leaves
    some): o = 0, l = 0, m = neg_inf_approx, as in JAX."""
    jr, tr = _rules("local", window_size=2, log2_stride_size=2, is_causal=True)
    rng = np.random.default_rng(5)
    q, k, v = (rng.uniform(-1, 1, (1, n, 8)) for n in (40, 20, 20))
    jp = jax_pack("scale_end", (40,), (20,))
    o1, l1, m1 = jax_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pack=jp, rule=jr,
                         block_q=16, block_kv=16)
    o2, l2, m2 = flash_attention_xla(*(torch.tensor(x) for x in (q, k, v)),
                                     pack=make_sync_pack("scale_end", (40,), (20,)), rule=tr,
                                     block_q=16, block_kv=16)
    dead = np.asarray(l1) == 0
    assert dead.any() and not dead.all()
    assert (l2.numpy() == 0).tolist() == dead.tolist()
    assert (o2.numpy()[dead] == 0).all()
    assert (m2.numpy()[dead] == fa.utils.dtypes.neg_inf_approx(jnp.float64)).all()
    for a, b in ((o1, o2), (l1, l2), (m1, m2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=_f64_tol(20))


@pytest.mark.parametrize("seq_dims", [1, 2], ids=["1d", "2d"])
def test_public_float64_route(seq_dims):
    """The public entry's float64 default is the chunked path: outputs in
    float64 (l float64), gradients, against JAX's public float64 call."""
    rng = np.random.default_rng(seq_dims)
    seq_q, seq_k = ((96,), (128,)) if seq_dims == 1 else ((6, 10), (8, 12))
    Q, K = rng.uniform(-1, 1, (2, 8) + seq_q), rng.uniform(-1, 1, (2, 8) + seq_k)
    V, dO = rng.uniform(-1, 1, (2, 6) + seq_k), rng.uniform(-1, 1, (2, 6) + seq_q)
    call = dict(window_size=3, log2_stride_size=1, is_causal=True, sync_mode="scale_front",
                returning_l_m=True)
    jfn = fa.local_1d if seq_dims == 1 else fa.local_2d
    tfn = ta.local_1d if seq_dims == 1 else ta.local_2d
    (o1, l1, m1), vjp = jax.vjp(lambda q, k, v: jfn(q, k, v, **call),
                                *(jnp.asarray(x) for x in (Q, K, V)))
    g1 = vjp((jnp.asarray(dO), jnp.zeros_like(l1), jnp.zeros_like(m1)))
    tx = [torch.tensor(x, requires_grad=True) for x in (Q, K, V)]
    o2, l2, m2 = tfn(*tx, **call)
    assert o2.dtype == l2.dtype == m2.dtype == torch.float64
    g2 = torch.autograd.grad(o2, tx, torch.tensor(dO))
    n = int(np.prod(seq_k))
    for name, a, b in zip(("O", "l", "m", "dQ", "dK", "dV"), (o1, l1, m1) + tuple(g1),
                          (o2, l2, m2) + tuple(g2)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0,
                                   atol=min(_f64_tol(n), F64_READ), err_msg=name)
    # and the dense oracle's answer
    o3 = tfn(*tx, **call, implementation="xla")[0]
    np.testing.assert_allclose(o2.detach().numpy(), o3.detach().numpy(), rtol=0,
                               atol=min(_f64_tol(n), F64_READ))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_xla_flash_below_float64_matches_jax(dtype):
    """``implementation="xla_flash"`` on float32 and bf16: float32 inside,
    ``o`` in the input dtype, the public ``l``/``m`` dtypes; against JAX at
    the reference's tolerance model (1e-6 * K float32, 1e-3 * K half)."""
    rng = np.random.default_rng(9)
    Q, K, V = (rng.uniform(-2, 2, s).astype(np.float32)
               for s in ((2, 16, 200), (2, 16, 260), (2, 8, 260)))
    dO = rng.uniform(-1, 1, (2, 8, 200)).astype(np.float32)
    call = dict(sync_mode="none_front", returning_l_m=True, implementation="xla_flash")
    jx = [jnp.asarray(x, _JNP[dtype]) for x in (Q, K, V, dO)]
    (o1, l1, m1), vjp = jax.vjp(lambda q, k, v: fa.causal_1d(q, k, v, **call), *jx[:3])
    g1 = vjp((jx[3], jnp.zeros_like(l1), jnp.zeros_like(m1)))
    tx = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (Q, K, V)]
    o2, l2, m2 = ta.causal_1d(*tx, **call)
    g2 = torch.autograd.grad(o2, tx, torch.tensor(dO).to(dtype))
    assert (o2.dtype, l2.dtype, m2.dtype) == (dtype, torch.float32, dtype)
    tol = (1e-3 if dtype.itemsize == 2 else 1e-6) * 260
    for name, a, b in zip(("O", "l", "m", "dQ", "dK", "dV"), (o1, l1, m1) + tuple(g1),
                          (o2, l2, m2) + tuple(g2)):
        np.testing.assert_allclose(b.detach().float().numpy(),
                                   np.asarray(jnp.asarray(a, jnp.float32)), rtol=tol, atol=tol,
                                   err_msg=name)


def test_groups_split_long_sequences(monkeypatch):
    """A call whose tiles exceed one group's budget runs the q blocks in
    several groups a kv step, with the answer of one group."""
    from tf_flash_attention_tpu_torch.ops import chunked

    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.uniform(-1, 1, (1, 300, 8))) for _ in range(3))
    for x in (q, k, v):
        x.requires_grad_(True)
    tr = trules.CausalRule()
    pack = make_sync_pack("none_front", (300,), (300,))
    whole = chunked.flash_attention_xla(q, k, v, pack=pack, rule=tr, block_q=32, block_kv=32)
    gw = torch.autograd.grad(whole[0].sum(), (q, k, v))
    monkeypatch.setattr(chunked, "_GROUP_ELEMS", 32 * 32 * 3)
    assert len(chunked._groups(10, 1, 32, 32)) == 4
    split = chunked.flash_attention_xla(q, k, v, pack=pack, rule=tr, block_q=32, block_kv=32)
    gs = torch.autograd.grad(split[0].sum(), (q, k, v))
    for a, b in zip(whole + gw, split + gs):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0, atol=1e-13)
