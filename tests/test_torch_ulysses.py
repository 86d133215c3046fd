"""The port's Ulysses attention against the JAX package's, on the CPU.

Every Ulysses case of ``tests/test_parallel.py``: the same seeded numpy
inputs go to JAX's ``ulysses_flash_attention`` (``shard_map`` over 8
virtual CPU devices, Pallas kernels in interpret mode) and to the port's
(a single-controller all-to-all over ``"cpu"`` eight times, the kernels'
plain versions); outputs and gradients within JAX's own ``2e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu.parallel import ulysses_flash_attention as julysses
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch.parallel import make_mesh, ulysses_flash_attention

JBLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
TOL = dict(rtol=2e-5, atol=2e-5)    # tests/test_parallel.py's Ulysses tolerance
AXES = ("data", "model", "context")


def data(b=2, h=4, s=256, d=16, seed=0):
    """``tests/test_parallel.py``'s inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (b, h, s, d)).astype(np.float32) for _ in range(3))


def _both(mesh_shape, rules, q, k, v, do=None, **kw):
    """(port, JAX): each the output and, with a cotangent ``do``, the input
    gradients, as numpy."""
    out = []
    jmesh = jmake_mesh(mesh_shape, AXES, jax.devices()[:8])
    mesh = make_mesh(mesh_shape, AXES, ["cpu"] * 8)
    uly = ulysses_flash_attention(mesh, rules[1], **kw)
    xs = [torch.from_numpy(x).requires_grad_(do is not None) for x in (q, k, v)]
    o = uly(*xs)
    grads = [] if do is None else torch.autograd.grad(o, xs, torch.from_numpy(do))
    out.append((o.detach().numpy(), [g.numpy() for g in grads]))
    july = julysses(jmesh, rules[0], block_config=JBLOCKS, **kw)
    o, vjp = jax.vjp(lambda *a: july(*a), *map(jnp.asarray, (q, k, v)))
    out.append((np.asarray(o), [] if do is None else [np.asarray(g) for g in vjp(jnp.asarray(do))]))
    return out


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL, err_msg="o")
    assert len(got[1]) == len(want[1])
    for a, b, name in zip(got[1], want[1], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("rules,sync", [
    ((jrules.CausalRule(), trules.CausalRule()), "none_front"),
    ((jrules.FullRule(), trules.FullRule()), "none_front"),
    ((jrules.LocalRule(24, is_causal=True), trules.LocalRule(24, is_causal=True)), "none_front"),
    ((jrules.LocalRule(10, 1), trules.LocalRule(10, 1)), "scale_front"),
    ((jrules.CausalRule(), trules.CausalRule()), "scale_end"),
], ids=["causal", "full", "local-causal", "local-strided-scalefront", "causal-scaleend"])
def test_ulysses_matches_jax(rules, sync):
    """Forward and gradients; the scale modes take q_len != k_len."""
    sq = 256 if sync == "none_front" else 128
    q = data(b=1, h=8, s=sq)[0]
    _, k, v = data(b=1, h=8, s=256, seed=1)
    do = data(b=1, h=8, s=sq, seed=3)[0]
    _check(*_both((1, 1, 8), rules, q, k, v, do, sync_mode=sync))


def test_ulysses_gqa_and_mixed_mesh():
    """GQA (8 q over 4 kv heads) on a data x model x context mesh."""
    q = data(b=2, h=8, s=128)[0]
    _, k, v = data(b=2, h=4, s=128, seed=1)
    _check(*_both((2, 2, 2), (jrules.CausalRule(), trules.CausalRule()), q, k, v))


def test_ulysses_2d_sequences():
    """2d sequences (32 x 8), row slabs: the all-to-all restores the whole
    flattened sequence, so the 2d order needs no shard offsets."""
    q, k, v = data(b=1, h=8, s=256)
    rules = (jrules.LocalRule(6, is_causal=True), trules.LocalRule(6, is_causal=True))
    _check(*_both((1, 1, 8), rules, q, k, v, q_seq_shape=(32, 8), k_seq_shape=(32, 8)))


def test_ulysses_head_divisibility_error():
    """4 heads over an 8-way context axis: both raise, pointing at the ring."""
    q, k, v = (torch.from_numpy(x) for x in data(b=1, h=4, s=256))
    uly = ulysses_flash_attention(make_mesh((1, 1, 8), AXES, ["cpu"] * 8), trules.CausalRule())
    with pytest.raises(ValueError, match="ring attention"):
        uly(q, k, v)
    july = julysses(jmake_mesh((1, 1, 8), AXES, jax.devices()[:8]), jrules.CausalRule(),
                    block_config=JBLOCKS)
    with pytest.raises(ValueError, match="ring attention"):
        july(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())))
