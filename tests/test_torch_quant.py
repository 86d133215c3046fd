"""Weight-only int8 projections in the port against the JAX package, on the
CPU: ``quantize_int8``, ``quantize_weight_int8``, ``int8_matmul`` and
``quantize_model_weights`` give the JAX package's codes and scales bit for
bit (eager JAX: each division the IEEE quotient), and ``forward`` on the
quantized weights agrees with the JAX forward on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.ops import quant as jq
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.ops import quant as tq

MCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, dtype=torch.float32)
_PROJ = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


def _inputs(seed, shape):
    """Values whose slices include an all-zero one (scale 1) and exact
    halves of a step (rounded half to even)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[..., 0, :] = 0.0
    x[..., 1, :3] = [127.0, 63.5, -0.5]
    return x


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax(axis, dtype):
    x = _inputs(axis + 3, (5, 9, 40))
    want = jq.quantize_int8(jnp.asarray(x).astype(dtype), axis=axis)
    got = tq.quantize_int8(torch.from_numpy(x).to(getattr(torch, dtype)), axis=axis)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(tq.dequantize_int8(got).numpy(),
                                  np.asarray(jq.dequantize_int8(want)))


def test_quantize_model_weights_matches_jax(params_np):
    want = jtf.quantize_model_weights(jax.tree.map(jnp.asarray, params_np))
    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    got = ttf.quantize_model_weights(model)
    for jl, block, dense in zip(want["layers"], got.layers, model.layers):
        for name in _PROJ:
            qt = getattr(block, name)
            assert isinstance(qt, tq.QuantizedTensor) and qt.shape == getattr(dense, name).shape
            np.testing.assert_array_equal(qt.values.numpy(), np.asarray(jl[name].values), name)
            np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jl[name].scales), name)
        np.testing.assert_array_equal(block.ln1.numpy(), np.asarray(jl["ln1"]))
    # the source model keeps its dense float32 parameters
    assert all(isinstance(getattr(b, n), torch.nn.Parameter) for b in model.layers for n in _PROJ)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(37,), (2, 19)])
def test_int8_matmul_matches_jax(dtype, lead):
    """Codes, int32 accumulators and outputs bit for bit, 2-d and 3-d x."""
    x = _inputs(7, lead + (64,))
    w = np.random.default_rng(8).normal(size=(64, 96)).astype(np.float32) / 8
    jx, jw = jnp.asarray(x).astype(dtype), jq.quantize_weight_int8(jnp.asarray(w))
    want = jq.int8_matmul(jx, jw)
    qx = jq.quantize_int8(jx, axis=-1)
    want_acc = jax.lax.dot_general(qx.values, jw.values, (((len(lead),), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, tqx, acc = tq.int8_matmul(tx, tq.quantize_weight_int8(torch.from_numpy(w)),
                                   return_parts=True)
    assert got.dtype == tx.dtype and acc.dtype == torch.int32
    np.testing.assert_array_equal(tqx.values.numpy(), np.asarray(qx.values))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_forward_quantized_matches_jax(params_np):
    """``forward`` on quantized weights against the JAX forward on its
    quantized weights, float32: within 1e-5 (attention's summation order
    only; the projections are bit-equal), while the dense weights' logits
    lie farther off."""
    tokens = np.random.default_rng(2).integers(0, 64, (2, 40))
    want = np.asarray(jtf.forward(MCFG, jtf.quantize_model_weights(
        jax.tree.map(jnp.asarray, params_np)), jnp.asarray(tokens)))
    got = ttf.forward(TCFG, ttf.quantize_model_weights(
        ttf.params_from_jax(TCFG, params_np, "cpu")), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dense = ttf.forward(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                        torch.from_numpy(tokens)).detach().numpy()
    assert np.abs(got - dense).max() > 1e-3          # the int8 weights are in use


def test_engine_takes_dense_weights_only(params_np):
    """The JAX engine casts its projections with ``.astype`` and so takes no
    quantized weights; the port's engine refuses them with a message."""
    from tf_flash_attention_tpu_torch.serving import engine as teng
    q = ttf.quantize_model_weights(ttf.params_from_jax(TCFG, params_np, "cpu"))
    with pytest.raises(TypeError, match="dense weights"):
        teng.DecodeEngine(TCFG, q, teng.EngineConfig(max_seqs=2), device="cpu")


def test_int8_matmul_refuses_other_devices():
    qw = tq.quantize_weight_int8(torch.ones(16, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        tq._int8_product(torch.ones(32, 16, dtype=torch.int8, device="meta"), qw.values)
