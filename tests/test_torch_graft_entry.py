"""The port's driver entry points (``graft_entry.py``) on the CPU:
``entry()``'s forward on the JAX entry's weights against JAX's jitted
forward, and ``dryrun_multichip(8)`` over 8 CPU shards with its checks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu_torch import graft_entry
from tf_flash_attention_tpu_torch.models import transformer as ttf

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 through 2 layers: only the order of sums differs
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's weights and tokens, and its forward in float32 (one
    jit): (numpy params, numpy tokens, numpy logits)."""
    _, (params, tokens) = jentry.entry()
    cfg = jtf.ModelConfig(**{f.name: getattr(graft_entry.ENTRY_CONFIG, f.name)
                             for f in dataclasses.fields(jtf.ModelConfig)
                             if f.name in ("vocab", "d_model", "n_layers", "n_heads",
                                           "n_kv_heads", "d_head", "d_ff", "max_seq")},
                          dtype=jnp.float32)
    logits = jax.jit(lambda p, t: jtf.forward(cfg, p, t))(params, tokens)
    return jax.tree.map(np.asarray, params), np.asarray(tokens), np.asarray(logits)


def test_entry_forward_matches_jax(jax_entry):
    params_np, tokens_np, want = jax_entry
    fn, (params, tokens) = graft_entry.entry("cpu")
    assert params.embed.device.type == "cpu" and tokens.dtype == torch.long
    np.testing.assert_array_equal(tokens.numpy(), tokens_np)
    # the port's own weights (bf16 compute): the JAX entry's shapes, finite
    with torch.no_grad():
        own = fn(params, tokens)
    assert own.shape == want.shape == (2, 256, 1024) and own.dtype == torch.float32
    assert torch.isfinite(own).all()
    # the JAX entry's weights carried over, in float32
    cfg = dataclasses.replace(graft_entry.ENTRY_CONFIG, dtype=torch.float32)
    carried = ttf.params_from_jax(cfg, params_np, "cpu")
    with torch.no_grad():
        got = fn(carried, tokens)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_dryrun_multichip_on_8_cpu_shards(capsys):
    graft_entry.dryrun_multichip(8, ["cpu"] * 8)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "dryrun_multichip(8) dp/tp/sp/ep", "dryrun_multichip(8) pp/dp",
        "dryrun_multichip(8) dp/tp/cp", "dryrun_multichip(8) dp/tp/cp ulysses+ring",
        "dryrun_multichip(8) tp x cp serving"]
    assert "mesh={'data': 2, 'model': 4} experts=4" in lines[0]
    assert "mesh={'data': 4, 'pipe': 2}" in lines[1]
    assert "mesh={'data': 2, 'model': 2, 'context': 2}" in lines[2]
    assert "ulysses fwd+grads parity ok" in lines[3] and "ring parity ok" in lines[3]
    assert "mesh={'model': 2, 'seq': 4} greedy parity ok (tp=2 cp=4, 10 tokens" in lines[4]
    assert "float32 cache: equal to the dense forward's in full" in lines[4]
    for line in lines[:3]:
        assert np.isfinite(float(line.rsplit("loss=", 1)[1]))


def test_dryrun_devices_default_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert graft_entry._devices(8, None) == [torch.device("cuda", 0)] * 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert graft_entry._devices(4, None) == [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(ValueError):
        graft_entry._devices(8, ["cpu"] * 4)
