"""The port's Mixture-of-Experts FFN, MoE model and expert-parallel step
against the JAX package's, on the CPU.

``moe_ffn`` on the same numpy inputs and weights (float32 and bf16 inputs,
capacity factors 1.25 and 0.5, which drops tokens): the routing, the
outputs, the aux loss and every gradient; the index dispatch against the
one-hot plain form; ``tests/test_model.py``'s MoE model (forward with the
aux, three AdamW steps), its expert-parallel step on (data 2, model 4) and
the loss and gradients on (data 2, model 2, context 2), all in float32
with the JAX parameters loaded by ``params_from_jax``.  Each JAX reference
runs once, jitted (the module's fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_flash_attention_tpu.models import moe as jmoe
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu_torch.models import moe as tmoe
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel import make_mesh

from _torch_parity import one_torch_thread
from test_torch_sharded_train import STEP_ATOL
from test_torch_train import _assert_close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-2     # tests/test_model.py's AdamW rate
# tests/test_model.py's MoE configurations, in float32
JCFGS = {
    "model": jtf.ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                             d_head=16, d_ff=128, max_seq=64, n_experts=4, dtype=jnp.float32),
    "ep": jtf.ModelConfig(vocab=128, d_model=64, n_layers=1, n_heads=8, n_kv_heads=8,
                          d_head=16, d_ff=128, max_seq=64, n_experts=4, dtype=jnp.float32),
    "cp": jtf.ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, max_seq=128, n_experts=4, context_parallel=True,
                          dtype=jnp.float32),
}
MESHES = {"ep": ((2, 4), ("data", "model")), "cp": ((2, 2, 2), ("data", "model", "context"))}
# float32 through the same products: the outputs and the aux part by
# summation order only
RTOL = 1e-5


def tcfg(jcfg):
    return ttf.ModelConfig(vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
                           n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
                           d_head=jcfg.d_head, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq,
                           n_experts=jcfg.n_experts, capacity_factor=jcfg.capacity_factor,
                           context_parallel=jcfg.context_parallel, dtype=torch.float32)


def _flat(tree, prefix=""):
    """A nested dict of arrays as {"a.b.c": array}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict) else {name: v})
    return out


def _flat_jax(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i, layer in enumerate(tree["layers"]):
        out.update(_flat(layer, f"layers.{i}."))
    return out


def _flat_torch(model, grads=False):
    out = {"embed": model.embed, "final_norm": model.final_norm}
    for i, block in enumerate(model.layers):
        out.update({f"layers.{i}.{n}": p for n, p in block.named_parameters()})
    return {k: v.grad if grads else v for k, v in out.items()}


def _adamw(model):
    # optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _tokens(shape):
    return np.random.default_rng(1).integers(0, 128, shape).astype(np.int32)


# ---- moe_ffn ----

FFN = dict(n_experts=4, d_model=32, d_ff=64)
X_SHAPE = (3, 40, 32)


def _jax_routing(cfg, params, x):
    """The reference's routing lines (``models/moe.py:54-63``)."""
    b, s, d = x.shape
    capacity = max(1, int(cfg.capacity_factor * s / cfg.n_experts))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, cfg.n_experts, dtype=jnp.float32)
    position = jnp.cumsum(onehot, axis=1) * onehot - 1.0
    keep = ((position >= 0) & (position < capacity)).any(-1)
    return np.asarray(expert), np.asarray(keep)


def _ffn_inputs(capacity_factor, dtype):
    jcfg = jmoe.MoEConfig(capacity_factor=capacity_factor, **FFN)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x, dy = (rng.normal(size=X_SHAPE).astype(np.float32) for _ in range(2))
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jcfg, params, (x, dy), (jdt, tdt)


class _Params:
    """``router, w_in, w_out`` as leaf tensors that take gradients."""

    def __init__(self, params):
        for k, v in params.items():
            setattr(self, k, torch.tensor(v, requires_grad=True))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_ffn_matches_jax(capacity_factor, dtype):
    """Routing and keep masks equal; y and aux within 1e-5 relative (a bf16
    y rounds the same float32 values, so within one bf16 ulp at its scale
    where a value sits on a rounding boundary); the gradients wrt x, the
    router, w_in and w_out of <y, dy> + aux."""
    jcfg, params, (x, dy), (jdt, tdt) = _ffn_inputs(capacity_factor, dtype)
    jx = jnp.asarray(x, jdt)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(jcfg, p, x)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jx)
    tcfg_ = tmoe.MoEConfig(capacity_factor=capacity_factor, **FFN)
    p = _Params(params)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    r = tmoe.route(tcfg_, p.router, tx)
    want_expert, want_keep = _jax_routing(jcfg, params, jx)
    np.testing.assert_array_equal(r.expert.numpy(), want_expert)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    if capacity_factor < 1:
        assert not want_keep.all()          # tokens are dropped
    y, aux = tmoe.moe_ffn(tcfg_, p, tx)
    assert y.dtype == tdt and aux.dtype == torch.float32
    jy32 = np.asarray(jy.astype(jnp.float32))
    tol = RTOL if dtype == "f32" else 2.0 ** -8
    np.testing.assert_allclose(y.detach().float().numpy(), jy32, rtol=0,
                               atol=tol * np.abs(jy32).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert (y[~r.keep] == 0).all()
    (torch.sum(y.float() * torch.from_numpy(dy)) + aux).backward()
    for name in ("router", "w_in", "w_out"):
        want = np.asarray(jgrads[0][name])
        np.testing.assert_allclose(getattr(p, name).grad.numpy(), want, rtol=0,
                                   atol=RTOL * np.abs(want).max(), err_msg=name)
    want = np.asarray(jgrads[1].astype(jnp.float32))
    np.testing.assert_allclose(tx.grad.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg="x")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_index_form_matches_onehot(capacity_factor):
    """The index dispatch and combine give the one-hot einsums' values and
    gradients, and keep no (b, s, E, C) tensor for the backward."""
    _, params, (x, dy), _ = _ffn_inputs(capacity_factor, "f32")
    cfg = tmoe.MoEConfig(capacity_factor=capacity_factor, **FFN)
    outs = []
    for fn in (tmoe.moe_ffn, tmoe.moe_ffn_onehot):
        p = _Params(params)
        tx = torch.tensor(x, requires_grad=True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                      lambda t: t):
            y, aux = fn(cfg, p, tx)
        (torch.sum(y * torch.from_numpy(dy)) + aux).backward()
        outs.append((y.detach(), aux.detach(), tx.grad, p.router.grad, p.w_in.grad,
                     p.w_out.grad, saved))
    b, s, _ = X_SHAPE
    capacity = max(1, int(capacity_factor * s / cfg.n_experts))
    onehot_shape = (b, s, cfg.n_experts, capacity)
    assert onehot_shape not in outs[0][-1] and onehot_shape in outs[1][-1]
    for name, got, want in zip(("y", "aux", "x", "router", "w_in", "w_out"), outs[0], outs[1]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()),
                                   msg=name)


# ---- the MoE model ----

@pytest.fixture(scope="module")
def model_ref():
    """JAX's forward with the aux, and three jitted ``train_step``s with
    optax.adamw."""
    cfg = JCFGS["model"]
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    tokens = _tokens((4, 65))
    logits, aux = jax.jit(lambda p, t: jtf.forward(cfg, p, t, return_aux=True))(
        params, jnp.asarray(tokens[:, :-1]))
    optimizer = optax.adamw(LR)
    opt_state = optimizer.init(params)
    step = jax.jit(lambda p, o, t: jtf.train_step(cfg, p, o, t, optimizer=optimizer))
    losses = []
    for _ in range(3):
        loss, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return (params_np, tokens, np.asarray(logits), float(aux), losses,
            _flat_jax(jax.tree.map(np.asarray, params)))


def test_moe_forward_with_aux_matches_jax(model_ref):
    params_np, tokens, logits_j, aux_j, losses_j, _ = model_ref
    cfg = tcfg(JCFGS["model"])
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    logits, aux = ttf.forward(cfg, model, torch.from_numpy(tokens[:, :-1]).long(),
                              return_aux=True)
    _assert_close(logits, logits_j, "logits")
    np.testing.assert_allclose(float(aux), aux_j, rtol=RTOL)
    assert aux_j > 0
    # loss_fn adds the aux: the JAX step's first loss
    np.testing.assert_allclose(float(ttf.loss_fn(cfg, model, torch.from_numpy(tokens).long())),
                               losses_j[0], rtol=RTOL)


def test_moe_train_steps_match_jax(model_ref):
    params_np, tokens, _, _, losses_j, params_j = model_ref
    cfg = tcfg(JCFGS["model"])
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    opt = _adamw(model)
    tok = torch.from_numpy(tokens).long()
    losses = [float(ttf.train_step(cfg, model, tok, optimizer=opt)) for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, rtol=RTOL)
    assert losses[-1] < losses[0]
    params_t = _flat_torch(model)
    assert params_t.keys() == params_j.keys()
    for name, p in params_j.items():
        _assert_close(params_t[name], p, f"param {name}", atol=STEP_ATOL)


# ---- expert parallelism ----

def _meshes(kind):
    shape, axes = MESHES[kind]
    return jmake_mesh(shape, axes, jax.devices()[:8]), make_mesh(shape, axes, ["cpu"] * 8)


@pytest.fixture(scope="module")
def ep_ref():
    """Three steps of JAX's ``make_sharded_train_step`` on (data 2, model 4):
    the experts split over ``model``."""
    cfg = JCFGS["ep"]
    jmesh, _ = _meshes("ep")
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    tokens = _tokens((4, 65))
    optimizer = optax.adamw(LR)
    params = jax.device_put(params, jtf.param_shardings(cfg, jmesh))
    opt_state = optimizer.init(params)
    step = jtf.make_sharded_train_step(cfg, jmesh, optimizer)
    losses = []
    for _ in range(3):
        loss, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return params_np, tokens, losses, _flat_jax(jax.tree.map(np.asarray, params))


def test_expert_parallel_steps_match_jax(ep_ref):
    params_np, tokens, losses_j, params_j = ep_ref
    cfg = tcfg(JCFGS["ep"])
    _, mesh = _meshes("ep")
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    step = ttf.make_sharded_train_step(cfg, mesh, _adamw(model))
    losses = [float(step(model, torch.from_numpy(tokens).long())) for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, rtol=RTOL)
    params_t = _flat_torch(model)
    assert params_t.keys() == params_j.keys()
    for name, p in params_j.items():
        _assert_close(params_t[name], p, f"param {name}", atol=STEP_ATOL)


def test_moe_aux_is_global_over_data_shards(ep_ref):
    """The sharded loss equals the unsharded one: the aux is formed once
    from counts and probabilities summed over the data shards (the mean of
    the shards' own aux losses is another number)."""
    params_np, tokens, _, _ = ep_ref
    cfg = tcfg(JCFGS["ep"])
    _, mesh = _meshes("ep")
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    tok = torch.from_numpy(tokens).long()
    sharded = float(ttf.loss_fn(cfg, model, tok, mesh=mesh))
    np.testing.assert_allclose(sharded, float(ttf.loss_fn(cfg, model, tok)), rtol=RTOL)
    halves = [ttf.forward(cfg, model, t[:, :-1], return_aux=True)[1] for t in tok.chunk(2)]
    whole = ttf.forward(cfg, model, tok[:, :-1], return_aux=True)[1]
    assert abs(float(sum(halves) / 2 - whole)) > 1e-6


@pytest.fixture(scope="module")
def cp_ref():
    """JAX's MoE loss and gradients on (data 2, model 2, context 2)."""
    cfg = JCFGS["cp"]
    jmesh, _ = _meshes("cp")
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tokens = _tokens((4, 129))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, jnp.asarray(tokens), mesh=jmesh)))(params)
    return (jax.tree.map(np.asarray, params), tokens, float(loss),
            _flat_jax(jax.tree.map(np.asarray, grads)))


def test_moe_context_parallel_loss_and_gradients_match_jax(cp_ref):
    params_np, tokens, loss_j, grads_j = cp_ref
    cfg = tcfg(JCFGS["cp"])
    _, mesh = _meshes("cp")
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    loss = ttf.loss_fn(cfg, model, torch.from_numpy(tokens).long(), mesh=mesh)
    np.testing.assert_allclose(float(loss), loss_j, rtol=RTOL)
    loss.backward()
    grads_t = _flat_torch(model, grads=True)
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        _assert_close(grads_t[name], g, f"grad {name}")


def test_experts_must_divide_over_model():
    cfg = dataclasses.replace(tcfg(JCFGS["ep"]), n_experts=6)
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="n_experts 6"):
        ttf.make_sharded_train_step(cfg, mesh, torch.optim.SGD([torch.zeros(1)], 0.1))


# ---- parameters ----

def test_params_from_jax_and_shardings_with_moe(model_ref):
    params_np = model_ref[0]
    cfg = tcfg(JCFGS["model"])
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    want = _flat_jax(params_np)
    got = _flat_torch(model)
    assert got.keys() == want.keys()
    assert not any(k.endswith((".w1", ".w2", ".w3")) for k in got)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), value, err_msg=name)
    jmesh, _ = _meshes("ep")
    jspec = jtf.param_shardings(JCFGS["model"], jmesh)
    tspec = ttf.param_shardings(cfg)
    for g, w in zip(tspec["layers"], jspec["layers"]):
        flat_w = _flat(w)
        flat_g = _flat(g)
        assert flat_g.keys() == flat_w.keys()
        for name, spec in flat_w.items():
            assert flat_g[name] == tuple(spec.spec) + (None,) * (len(flat_g[name])
                                                                 - len(spec.spec)), name
    # the reference's scales
    big = dataclasses.replace(cfg, d_model=256, d_ff=512)
    init = ttf.init_params(big, torch.Generator().manual_seed(0), "cpu").layers[0].moe
    assert abs(float(init.router.std()) - 256 ** -0.5) < 3e-3
    assert abs(float(init.w_in.std()) - 256 ** -0.5) < 3e-3
    assert abs(float(init.w_out.std()) - 512 ** -0.5) < 3e-3


def test_moe_weights_stay_float32_and_dense(model_ref):
    """``inference_weights`` casts the projections, not the experts (they
    run in float32); ``quantize_model_weights`` leaves them dense."""
    cfg = dataclasses.replace(tcfg(JCFGS["model"]), dtype=torch.bfloat16)
    model = ttf.params_from_jax(cfg, model_ref[0], "cpu")
    served = ttf.inference_weights(model)
    assert served.layers[0].wq.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in served.layers[0].moe.parameters())
    quant = ttf.quantize_model_weights(model)
    assert isinstance(quant.layers[0].wq, ttf.QuantizedTensor)
    assert all(isinstance(p, torch.nn.Parameter) for p in quant.layers[0].moe.parameters())
    logits = ttf.forward(cfg, quant, torch.zeros((1, 16), dtype=torch.long))
    assert torch.isfinite(logits).all()
