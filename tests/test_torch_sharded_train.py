"""The port's sharded attention and sharded train step against the JAX
package's, on the CPU.

The cases of ``tests/test_parallel.py``'s ``sharded_flash_attention`` and
``tests/test_model.py``'s sharded and context-parallel steps, in float32,
on ``"cpu"`` eight times for the port and on 8 virtual CPU devices for JAX
(Pallas kernels in interpret mode): the JAX parameters load into the port
with ``params_from_jax``, the same numpy tokens go to both, and the
context-parallel loss, its gradients, and three AdamW steps of
``make_sharded_train_step`` on a ``(data 2, model 4)`` and a ``(data 2,
model 2, context 2)`` mesh must agree.  Each JAX reference runs once (the
module's fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu.parallel import sharded_flash_attention as jsharded
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel import make_mesh, sharded_flash_attention

from test_torch_train import _assert_close, _flat_grads, _flat_jax

AXES = ("data", "model", "context")
# tests/test_model.py's sharded-step and context-parallel configurations, in
# float32: the comparison is of the algorithm, not of two bf16 roundings
JCFGS = {
    "tp": jtf.ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
                          d_head=16, d_ff=128, max_seq=64, dtype=jnp.float32),
    "cp": jtf.ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, max_seq=256, context_parallel=True,
                          dtype=jnp.float32),
}
MESHES = {"tp": ((2, 4), ("data", "model")), "cp": ((2, 2, 2), AXES)}
SEQ = {"tp": 65, "cp": 257}
LR = 1e-2     # tests/test_model.py's AdamW rate
# the weights after three AdamW steps: adam's m / (sqrt(v) + eps) turns
# the gradients' float32 differences (held to 2e-5 by the gradient test)
# into differences of the step's size lr, wherever a gradient is small or
# its steps cancel; JAX's own sharded steps part from its unsharded ones on
# the same float32 weights by the same order.  A tenth of lr; a lost or
# mis-weighted shard moves the weights by whole steps, and each step's loss
# far past its rtol of 1e-5
STEP_ATOL = LR / 10


def tcfg(jcfg):
    return ttf.ModelConfig(vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
                           n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
                           d_head=jcfg.d_head, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq,
                           dtype=torch.float32, context_parallel=jcfg.context_parallel)


def meshes(kind):
    shape, axes = MESHES[kind]
    return jmake_mesh(shape, axes, jax.devices()[:8]), make_mesh(shape, axes, ["cpu"] * 8)


def setup(kind):
    params = jtf.init_params(JCFGS[kind], jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, 128, (4, SEQ[kind])).astype(np.int32)
    return params, jax.tree.map(np.asarray, params), tokens


@pytest.fixture(scope="module")
def cp_ref():
    """JAX's context-parallel loss and its gradients on (2, 2, 2)."""
    params, params_np, tokens = setup("cp")
    jmesh, _ = meshes("cp")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(JCFGS["cp"], p, jnp.asarray(tokens), mesh=jmesh)))(params)
    return params_np, tokens, float(loss), _flat_jax(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module", params=["tp", "cp"])
def steps_ref(request):
    """Three steps of JAX's ``make_sharded_train_step`` with optax.adamw:
    the losses and the parameters after them."""
    kind = request.param
    params, params_np, tokens = setup(kind)
    jmesh, _ = meshes(kind)
    optimizer = optax.adamw(LR)
    params = jax.device_put(params, jtf.param_shardings(JCFGS[kind], jmesh))
    opt_state = optimizer.init(params)
    step = jtf.make_sharded_train_step(JCFGS[kind], jmesh, optimizer)
    losses = []
    for _ in range(3):
        loss, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return kind, params_np, tokens, losses, _flat_jax(jax.tree.map(np.asarray, params))


def test_sharded_flash_attention_matches_jax():
    """Batch over data 2, heads over model 4 (``test_parallel.py``'s case)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.uniform(-1, 1, (2, 4, 256, 16)).astype(np.float32) for _ in range(3))
    want = jsharded(jmake_mesh((2, 4), ("data", "model"), jax.devices()[:8]), jrules.CausalRule(),
                    block_config=BlockConfig(128, 128, 128, 128, 128, 128))(
        *map(jnp.asarray, (q, k, v)))
    fn = sharded_flash_attention(make_mesh((2, 4), ("data", "model"), ["cpu"] * 8),
                                 trules.CausalRule())
    got = fn(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_param_shardings_match_jax():
    jmesh, _ = meshes("cp")
    want = jtf.param_shardings(JCFGS["cp"], jmesh)
    got = ttf.param_shardings(tcfg(JCFGS["cp"]))
    assert got["embed"] == tuple(want["embed"].spec) + (None,) * (2 - len(want["embed"].spec))
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for name, spec in w.items():
            assert g[name] == tuple(spec.spec) + (None,) * (len(g[name]) - len(spec.spec)), name


def test_context_parallel_loss_matches_jax_and_dense(cp_ref):
    params_np, tokens, loss_j, _ = cp_ref
    cfg = tcfg(JCFGS["cp"])
    _, mesh = meshes("cp")
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    tok = torch.from_numpy(tokens).long()
    loss = float(ttf.loss_fn(cfg, model, tok, mesh=mesh))
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    dense = float(ttf.loss_fn(dataclasses.replace(cfg, context_parallel=False), model, tok))
    np.testing.assert_allclose(loss, dense, rtol=1e-5)


def test_context_parallel_gradients_match_jax(cp_ref):
    params_np, tokens, _, grads_j = cp_ref
    cfg = tcfg(JCFGS["cp"])
    _, mesh = meshes("cp")
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    ttf.loss_fn(cfg, model, torch.from_numpy(tokens).long(), mesh=mesh).backward()
    grads_t = _flat_grads(model)
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        _assert_close(grads_t[name], g, f"grad {name}")


def test_sharded_train_steps_match_jax(steps_ref):
    kind, params_np, tokens, losses_j, params_j = steps_ref
    cfg = tcfg(JCFGS[kind])
    _, mesh = meshes(kind)
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    # optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = ttf.make_sharded_train_step(cfg, mesh, opt)
    losses = [float(step(model, torch.from_numpy(tokens).long())) for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    params_t = {"embed": model.embed, "final_norm": model.final_norm}
    for i, block in enumerate(model.layers):
        params_t.update({f"layers.{i}.{n}": p for n, p in block.named_parameters()})
    assert params_t.keys() == params_j.keys()
    for name, p in params_j.items():
        _assert_close(params_t[name], p, f"param {name}", atol=STEP_ATOL)


def test_sequence_parallel_changes_no_number(monkeypatch):
    """sp (the residual stream in sequence chunks over the model devices,
    the norms on the chunks) is placement only: the logits and every
    gradient but the norm scales' equal those of the same mesh without it,
    bit for bit; a norm scale's gradient, a sum over the sequence, adds the
    chunks' sums (the all-reduce of Megatron's sp), so it moves by float32
    summation order only."""
    cfg = tcfg(JCFGS["tp"])
    _, mesh = meshes("tp")
    tokens = torch.from_numpy(setup("tp")[2]).long()
    outs = []
    for sp in (True, False):
        monkeypatch.setattr(ttf, "_sequence_parallel", lambda cfg, mesh, sp=sp: sp)
        model = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ttf.loss_fn(cfg, model, tokens, mesh=mesh).backward()
        outs.append((ttf.forward(cfg, model, tokens[:, :-1], mesh=mesh).detach(),
                     _flat_grads(model)))
    (logits_sp, grads_sp), (logits, grads) = outs
    assert torch.equal(logits_sp, logits)
    for name, g in grads.items():
        if name.endswith((".ln1", ".ln2")):
            torch.testing.assert_close(grads_sp[name], g, rtol=0,
                                       atol=1e-6 * float(g.abs().max()))
        else:
            assert torch.equal(grads_sp[name], g), name
