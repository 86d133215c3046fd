"""The port's training path against the JAX package, on the CPU.

The model is ``tests/test_model.py``'s ``CFG`` (GQA 4 q / 2 kv heads,
d_head 16) in float32, so the comparison is of the algorithm, not of two
frameworks' bf16 rounding: the JAX parameters from ``init_params`` load
into the port with ``params_from_jax``, the same numpy tokens go to both,
and the logits, the loss, every parameter gradient and the parameters
after one AdamW step must agree.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel.sharded import mha, sharded_flash_attention

from test_model import CFG

JCFG = dataclasses.replace(CFG, dtype=jnp.float32)
TCFG = ttf.ModelConfig(vocab=CFG.vocab, d_model=CFG.d_model, n_layers=CFG.n_layers,
                       n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads, d_head=CFG.d_head,
                       d_ff=CFG.d_ff, max_seq=CFG.max_seq, dtype=torch.float32)
# float32 through 2 layers: only the order of sums differs
ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    params = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, CFG.vocab, (2, 65)).astype(np.int32)
    return params, params_np, tokens


def _flat_grads(model):
    out = {"embed": model.embed.grad, "final_norm": model.final_norm.grad}
    for i, block in enumerate(model.layers):
        for name, p in block.named_parameters():
            out[f"layers.{i}.{name}"] = p.grad
    return out


def _flat_jax(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i, layer in enumerate(tree["layers"]):
        for name, value in layer.items():
            out[f"layers.{i}.{name}"] = value
    return out


def _assert_close(got, want, name, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_forward_and_loss_match_jax(setup):
    params, params_np, tokens = setup
    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    want = jtf.forward(JCFG, params, jnp.asarray(tokens[:, :-1]))
    got = ttf.forward(TCFG, model, torch.from_numpy(tokens[:, :-1]).long())
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_close(got, want, "logits")
    _assert_close(ttf.loss_fn(TCFG, model, torch.from_numpy(tokens).long()),
                  jtf.loss_fn(JCFG, params, jnp.asarray(tokens)), "loss")


def test_gradients_and_adamw_step_match_jax(setup):
    params, params_np, tokens = setup
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jtf.loss_fn(JCFG, p, jnp.asarray(tokens)))(params)
    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    # optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    loss_t = ttf.train_step(TCFG, model, torch.from_numpy(tokens).long(), optimizer=opt)
    _assert_close(loss_t, loss_j, "loss")
    grads_t = _flat_grads(model)
    grads_jf = _flat_jax(grads_j)
    assert grads_t.keys() == grads_jf.keys()
    for name, g in grads_jf.items():
        _assert_close(grads_t[name], g, f"grad {name}")

    # the step itself, from the same (JAX) gradients: where |g| is near
    # adam's eps, g / (|g| + eps) would magnify the gradients' own float32
    # differences, so the step is compared on identical gradients, to two
    # float32 ulps of the weights' scale
    optimizer = optax.adamw(1e-3)
    updates, _ = optimizer.update(grads_j, optimizer.init(params), params)
    stepped = _flat_jax(optax.apply_updates(params, updates))
    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    params_t = {"embed": model.embed, "final_norm": model.final_norm}
    for i, block in enumerate(model.layers):
        params_t.update({f"layers.{i}.{n}": p for n, p in block.named_parameters()})
    for name, p in params_t.items():
        p.grad = torch.from_numpy(np.array(grads_jf[name]))
    opt.step()
    for name, p in stepped.items():
        _assert_close(params_t[name], p, f"param {name}", atol=2.4e-7)


@pytest.fixture(scope="module")
def jax_unbroken_steps(setup):
    """The losses of 4 unbroken steps of JAX's jitted ``train_step`` with
    ``optax.adamw`` on ``setup``'s weights and tokens."""
    params, _, tokens = setup
    optimizer = optax.adamw(1e-3)
    step = jax.jit(functools.partial(jtf.train_step, JCFG, optimizer=optimizer))
    opt_state, losses = optimizer.init(params), []
    for _ in range(4):
        loss, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


def test_resumed_adamw_steps_match_jax_unbroken_steps(setup, jax_unbroken_steps, tmp_path):
    """2 port steps, a checkpoint, a fresh model and optimizer restored
    through ``target``, 2 more steps: each step's loss against JAX's 4
    unbroken optax steps within ATOL.  Steps 3 and 4 read the restored AdamW
    moments (a fresh optimizer state moves their losses by 6.6e-3).  The
    weights are not compared with JAX's: where |g| is near adam's eps,
    g / (|g| + eps) magnifies the gradients' float32 differences (see
    ``test_gradients_and_adamw_step_match_jax``); the resumed weights equal
    the port's unbroken ones bit for bit in ``test_torch_checkpoint.py``."""
    from tf_flash_attention_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    _, params_np, tokens = setup
    want_losses = jax_unbroken_steps
    tok = torch.from_numpy(tokens).long()

    def adamw(model):
        return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    model = ttf.params_from_jax(TCFG, params_np, "cpu")
    opt = adamw(model)
    losses = [ttf.train_step(TCFG, model, tok, optimizer=opt) for _ in range(2)]
    save_checkpoint(str(tmp_path), 2, {"params": model.state_dict(),
                                       "opt_state": opt.state_dict(), "step": 2})
    model = ttf.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    opt = adamw(model)
    state = restore_checkpoint(str(tmp_path), target={"params": model.state_dict(),
                                                      "opt_state": opt.state_dict(), "step": 0})
    model.load_state_dict(state["params"])
    opt.load_state_dict(state["opt_state"])
    losses += [ttf.train_step(TCFG, model, tok, optimizer=opt) for _ in range(2)]
    assert len(losses) == len(want_losses) == 4
    for i, (got, want) in enumerate(zip(losses, want_losses)):
        _assert_close(got, want, f"loss {i}")


def test_train_step_decreases_loss():
    model = ttf.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    tokens = torch.randint(0, TCFG.vocab, (4, 65), generator=torch.Generator().manual_seed(1))
    losses = [float(ttf.train_step(TCFG, model, tokens, optimizer=opt)) for _ in range(3)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("rule", [trules.CausalRule(),
                                  trules.LocalRule(window_size=8, is_causal=True)],
                         ids=["causal", "local"])
def test_bf16_forward_finite(rule):
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16, rule=rule)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits = ttf.forward(cfg, model, torch.zeros((2, 64), dtype=torch.long))
    assert logits.shape == (2, 64, cfg.vocab) and torch.isfinite(logits).all()


def test_mha_gqa_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.uniform(-2, 2, s).astype(np.float32)
               for s in ((2, 4, 200, 16), (2, 2, 200, 16), (2, 2, 200, 16)))
    from tf_flash_attention_tpu.mask_rules import CausalRule
    from tf_flash_attention_tpu.parallel.sharded import mha as jmha
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rule=CausalRule())
    got = mha(*(torch.from_numpy(x) for x in (q, k, v)), rule=trules.CausalRule())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("option", ["mesh", "context_parallel", "sharded_flash_attention"])
def test_ported_mesh_options_run(option):
    """What raised before the parallel layer was ported now runs: a train
    step over a (data, model) mesh, the context-parallel config over a
    (data, model, context) mesh, and the head- and data-sharded attention
    (each against JAX in ``test_torch_sharded_train.py`` and
    ``test_torch_ring.py``)."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    tokens = torch.randint(0, TCFG.vocab, (2, 17), generator=torch.Generator().manual_seed(0))
    if option == "sharded_flash_attention":
        q = torch.randn((2, 4, 64, 16), generator=torch.Generator().manual_seed(1))
        fn = sharded_flash_attention(make_mesh((2, 2), ("data", "model"), ["cpu"] * 4),
                                     trules.CausalRule())
        torch.testing.assert_close(fn(q, q, q), mha(q, q, q, rule=trules.CausalRule()),
                                   rtol=0, atol=0)
        return
    cfg = dataclasses.replace(TCFG, context_parallel=option == "context_parallel")
    mesh = (make_mesh((2, 2), ("data", "model"), ["cpu"] * 4) if option == "mesh"
            else make_mesh((1, 2, 2), ("data", "model", "context"), ["cpu"] * 4))
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dense = float(ttf.loss_fn(cfg, model, tokens))
    loss = ttf.train_step(cfg, model, tokens, optimizer=torch.optim.SGD(model.parameters(), 0.1),
                          mesh=mesh)
    np.testing.assert_allclose(float(loss), dense, rtol=1e-5)
