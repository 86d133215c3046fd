"""The port's ring attention against the JAX package's, on the CPU.

Every case of ``tests/test_parallel.py``'s ring tests, with the same seeded
numpy inputs going to JAX's ``ring_flash_attention`` (``shard_map`` over 8
virtual CPU devices, Pallas kernels in interpret mode) and to the port's
(a single-controller ring over ``"cpu"`` eight times, the kernels' plain
versions): outputs and dQ/dK/dV within JAX's own ``2e-5``.  Each JAX
reference runs once (``_jax_ring``, cached for the module), and its
forward and gradients serve the forward and the gradient cases alike.
The ring's static schedule (``_offset_pack``, ``_local_live_steps``) must
equal JAX's, and a GQA ring over the model's K/V rows must equal JAX's
``ring_attention_local`` under ``shard_map``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu.parallel import ring as jring
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch.parallel import make_mesh, mha, ring_flash_attention
from tf_flash_attention_tpu_torch.parallel import ring as tring
from tf_flash_attention_tpu_torch.parallel.ring import ring_attention_local

from _torch_parity import one_torch_thread  # noqa: F401 (the fixture below)

# many small CPU ops: one intra-op thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

JBLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
TOL = dict(rtol=2e-5, atol=2e-5)    # tests/test_parallel.py's ring tolerance
AXES = ("data", "model", "context")

RULES = {
    "causal": (jrules.CausalRule(), trules.CausalRule()),
    "full": (jrules.FullRule(), trules.FullRule()),
    "local-causal": (jrules.LocalRule(20, is_causal=True), trules.LocalRule(20, is_causal=True)),
    "local-band": (jrules.LocalRule(12), trules.LocalRule(12)),
    "local-strided": (jrules.LocalRule(6, 1), trules.LocalRule(6, 1)),
    "local100-causal": (jrules.LocalRule(100, is_causal=True),
                        trules.LocalRule(100, is_causal=True)),
    "local70-band-wrap": (jrules.LocalRule(70), trules.LocalRule(70)),
    "local40-strided": (jrules.LocalRule(40, 1, True), trules.LocalRule(40, 1, True)),
}


def data(b=2, h=4, s=256, d=16, seed=0):
    """``tests/test_parallel.py``'s inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (b, h, s, d)).astype(np.float32) for _ in range(3))


def _vjp(fn, q, k, v, do):
    """``fn``'s output and its input gradients for the cotangent ``do``."""
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return o, vjp(jnp.asarray(do))


@functools.lru_cache(maxsize=None)
def _jax_ring(mesh_shape, rule, seq_shape, s):
    """JAX's ring output and input gradients (numpy) on ``data(b=1, h=2,
    s=s)`` with the cotangent ``data(seed=3)[0]``."""
    q, k, v = data(b=1, h=2, s=s)
    do = data(b=1, h=2, s=s, seed=3)[0]
    mesh = jmake_mesh(mesh_shape, AXES, jax.devices()[:8])
    ring = jring.ring_flash_attention(mesh, rule=RULES[rule][0], seq_shape=seq_shape,
                                      block_config=JBLOCKS)
    o, grads = _vjp(ring, q, k, v, do)
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port_ring(mesh_shape, rule, seq_shape, s):
    q, k, v = data(b=1, h=2, s=s)
    do = data(b=1, h=2, s=s, seed=3)[0]
    mesh = make_mesh(mesh_shape, AXES, ["cpu"] * 8)
    ring = ring_flash_attention(mesh, rule=RULES[rule][1], seq_shape=seq_shape)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ring(*xs)
    grads = torch.autograd.grad(o, xs, torch.from_numpy(do))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _check(mesh_shape, rule, seq_shape=None, s=512, grads=True):
    o_t, g_t = _port_ring(mesh_shape, rule, seq_shape, s)
    o_j, g_j = _jax_ring(mesh_shape, rule, seq_shape, s)
    np.testing.assert_allclose(o_t, o_j, **TOL, err_msg="o")
    if grads:
        for a, b, name in zip(g_t, g_j, ("dq", "dk", "dv")):
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_local(causal):
    rule = "causal" if causal else "full"
    _check((1, 1, 8), rule, grads=False)
    # and the port's own single-device layer
    q, k, v = (torch.from_numpy(x) for x in data(b=1, h=2, s=512))
    want = mha(q, k, v, rule=RULES[rule][1])
    got = ring_flash_attention(make_mesh((1, 1, 8), AXES, ["cpu"] * 8), causal=causal)(q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ring_attention_2d_mesh():
    _check((1, 2, 4), "causal", grads=False)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_gradients(causal):
    _check((1, 1, 8), "causal" if causal else "full")


@pytest.mark.parametrize("rule", ["causal", "full", "local-causal", "local-band",
                                  "local-strided"])
def test_ring_attention_2d_sequences(rule):
    """2d sequences (64 x 16) sharded along dim 0 into row slabs."""
    _check((1, 1, 8), rule, seq_shape=(64, 16), s=1024)


@pytest.mark.parametrize("rule", ["local100-causal", "local70-band-wrap", "local40-strided"])
def test_ring_attention_local_rule(rule):
    """The banded shard schedule of 1d local rules."""
    _check((1, 1, 8), rule)


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_schedule_matches_jax(rule, n):
    """The static schedule: the live steps of the banded shard schedule and
    the offset packs of every visited pair, 1d and 2d."""
    jr, tr = RULES[rule]
    for seq_shape in ((512 // n,), (64 // n, 16)):
        r0 = seq_shape[0]
        if isinstance(jr, jrules.LocalRule):
            steps = tring._local_live_steps(tr, n, r0)
            assert steps == jring._local_live_steps(jr, n, r0)
        else:
            steps = [(t, True, True) for t in range(n)]
        for t, _, _ in steps:
            for offs in ((t * r0, 0), (0, (n - t) * r0)):
                a, b = tring._offset_pack(seq_shape, *offs), jring._offset_pack(seq_shape, *offs)
                assert a.reference_shape == b.reference_shape
                for x, y in ((a.q, b.q), (a.k, b.k)):
                    assert (x.shape, x.stride, x.offset) == (y.shape, y.stride, y.offset)


def test_gqa_ring_matches_jax():
    """The context-parallel block's ring: 4 q heads over 2 K/V heads, the
    K/V rows grouped (``models/transformer.py``'s ``cp_attend``), forward
    and gradients on a context axis of 4."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d, n = 2, 4, 2, 256, 16, 4
    q, do = (rng.uniform(-1, 1, (b * hq, s, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.uniform(-1, 1, (b * hkv, s, d)).astype(np.float32) for _ in range(2))
    mesh = jmake_mesh((n,), ("context",), jax.devices()[:n])
    spec = P(None, "context", None)

    def jfn(q, k, v):
        return jring.ring_attention_local(q, k, v, axis_name="context", axis_size=n,
                                          rule=jrules.CausalRule(), block_config=JBLOCKS,
                                          interpret=True)

    ring = jax.jit(shard_map(jfn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                             check_vma=False))
    o_j, g_j = _vjp(ring, q, k, v, do)

    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    shards = [list(x.chunk(n, 1)) for x in xs]
    outs = ring_attention_local(*shards, rule=trules.CausalRule())
    o_t = torch.cat(outs, 1)
    g_t = torch.autograd.grad(o_t, xs, torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), **TOL)
    for a, bb, name in zip(g_t, g_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL, err_msg=name)
