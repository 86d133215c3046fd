"""The port's GPipe pipeline against the JAX package's, on the CPU.

``tests/test_model.py``'s pipeline configuration in float32 (4 layers on
a (data 2, pipe 4) mesh, 2 microbatches), the port on ``"cpu"`` eight
times, JAX on 8 virtual CPU devices (Pallas kernels in interpret mode):
the stage layout, the pipeline loss against JAX's and against the dense
loss, three AdamW steps against ``make_pipeline_train_step`` with
optax.adamw, the stage applications of a step, and an MoE model through
the pipeline, whose loss drops the aux as JAX's does.  Each JAX reference
runs once, jitted (the module's fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_flash_attention_tpu.models import pipeline as jpp
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu_torch.models import pipeline as tpp
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel import make_mesh

from _torch_parity import one_torch_thread
from test_torch_moe import _flat, tcfg
from test_torch_sharded_train import STEP_ATOL
from test_torch_train import _assert_close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JCFG = jtf.ModelConfig(vocab=64, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4, d_head=16,
                       d_ff=128, max_seq=64, dtype=jnp.float32)
SHAPE, AXES = (2, 4), ("data", "pipe")
M = 2
LR = 1e-2     # tests/test_model.py's AdamW rate
RTOL = 1e-5


def _meshes():
    return jmake_mesh(SHAPE, AXES, jax.devices()[:8]), make_mesh(SHAPE, AXES, ["cpu"] * 8)


def _tokens():
    return np.random.default_rng(1).integers(0, 64, (8, 33)).astype(np.int32)


def _flat_staged(staged):
    """{"layers.j.name": [stage 0's, stage 1's, ...]} as JAX's stacked
    leaves, plus the embedding and the final norm."""
    out = {"embed": staged.embed, "final_norm": staged.final_norm}
    for j in range(len(staged.stages[0])):
        for name, _ in staged.stages[0][j].named_parameters():
            out[f"layers.{j}.{name}"] = [dict(stage[j].named_parameters())[name]
                                         for stage in staged.stages]
    return out


def _stacked_np(ps):
    return np.stack([p.detach().numpy() for p in ps]) if isinstance(ps, list) else ps.detach().numpy()


def _flat_stacked(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for j, layer in enumerate(tree["layers"]):
        out.update(_flat(layer, f"layers.{j}."))
    return out


@pytest.fixture(scope="module")
def ref():
    """JAX's stacked parameters and three steps of its jitted
    ``make_pipeline_train_step``: the losses (the first is the pipeline
    loss at the initial weights), the parameters after them, the
    shardings."""
    jmesh, _ = _meshes()
    params = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    stacked = jpp.stack_stage_params(JCFG, params, SHAPE[1])
    stacked_np = jax.tree.map(np.asarray, stacked)
    optimizer = optax.adamw(LR)
    step, shardings = jpp.make_pipeline_train_step(JCFG, jmesh, optimizer, n_microbatches=M)
    opt_state = optimizer.init(stacked)
    specs = shardings(stacked)
    stacked = jax.device_put(stacked, specs)
    losses = []
    for _ in range(3):
        loss, stacked, opt_state = step(stacked, opt_state, jnp.asarray(_tokens()))
        losses.append(float(loss))
    return (jax.tree.map(np.asarray, params), stacked_np, losses,
            _flat_stacked(jax.tree.map(np.asarray, stacked)), specs)


def test_stack_stage_params_layout(ref):
    """Stage s holds layers s·per … s·per + per − 1 (the model's own
    modules), JAX's stacked pytree loads into the same layout, and the
    placements are JAX's shardings."""
    params_np, stacked_np, _, _, specs = ref
    cfg = tcfg(JCFG)
    model = ttf.params_from_jax(cfg, params_np, "cpu")
    staged = tpp.stack_stage_params(cfg, model, 4)
    per = cfg.n_layers // 4
    assert all(staged.stages[s][j] is model.layers[s * per + j]
               for s in range(4) for j in range(per))
    loaded = _flat_staged(tpp.stages_from_jax(cfg, stacked_np, "cpu"))
    mine = _flat_staged(staged)
    want = _flat_stacked(stacked_np)
    assert loaded.keys() == mine.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(_stacked_np(mine[name]), value, err_msg=name)
        np.testing.assert_array_equal(_stacked_np(loaded[name]), value, err_msg=name)
    _, placements = tpp.make_pipeline_train_step(cfg, _meshes()[1],
                                                 torch.optim.SGD(staged.parameters(), 0.1), M)
    got = placements(staged)
    assert got["embed"] == tuple(specs["embed"].spec) and got["final_norm"] == ()
    assert [_flat(g) for g in got["layers"]] == [
        {k: tuple(v.spec) for k, v in _flat(w).items()} for w in specs["layers"]]
    with pytest.raises(ValueError, match="not divisible by n_stages"):
        tpp.stack_stage_params(cfg, model, 3)


def test_pipeline_loss_matches_jax_and_dense(ref):
    params_np, stacked_np, losses_j, _, _ = ref
    cfg = tcfg(JCFG)
    _, mesh = _meshes()
    tokens = torch.from_numpy(_tokens()).long()
    staged = tpp.stages_from_jax(cfg, stacked_np, "cpu")
    loss = float(tpp.pipeline_loss_fn(cfg, mesh, M)(staged, tokens))
    np.testing.assert_allclose(loss, losses_j[0], rtol=RTOL)
    dense = float(ttf.loss_fn(cfg, ttf.params_from_jax(cfg, params_np, "cpu"), tokens))
    np.testing.assert_allclose(loss, dense, rtol=RTOL)


def test_pipeline_train_steps_match_jax(ref):
    _, stacked_np, losses_j, params_j, _ = ref
    cfg = tcfg(JCFG)
    _, mesh = _meshes()
    staged = tpp.stages_from_jax(cfg, stacked_np, "cpu")
    # optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
    opt = torch.optim.AdamW(staged.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step, _ = tpp.make_pipeline_train_step(cfg, mesh, opt, M)
    tokens = torch.from_numpy(_tokens()).long()
    losses = [float(step(staged, tokens)) for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, rtol=RTOL)
    assert losses[-1] < losses[0]
    got = _flat_staged(staged)
    assert got.keys() == params_j.keys()
    for name, p in params_j.items():
        _assert_close(torch.from_numpy(_stacked_np(got[name])), p, f"param {name}",
                      atol=STEP_ATOL)


def test_stage_runs_only_its_live_ticks(ref, monkeypatch):
    """A step applies each stage M times a data shard, on the ticks t with
    0 <= t - s < M: n_stages·M·dp applications, none on a bubble tick."""
    cfg = tcfg(JCFG)
    _, mesh = _meshes()
    staged = tpp.stages_from_jax(cfg, ref[1], "cpu")
    seen = []
    inner = tpp._stage_apply

    def count(cfg, blocks, x):
        seen.append(next(s for s, stage in enumerate(staged.stages) if stage is blocks))
        return inner(cfg, blocks, x)

    monkeypatch.setattr(tpp, "_stage_apply", count)
    tpp.pipeline_loss_fn(cfg, mesh, M)(staged, torch.from_numpy(_tokens()).long())
    n_stages, dp = SHAPE[1], SHAPE[0]
    assert len(seen) == n_stages * M * dp
    assert all(seen.count(s) == M * dp for s in range(n_stages))
    # GPipe order within a data shard: tick t runs stages max(0, t-M+1) .. min(t, S-1)
    ticks = [s for t in range(M + n_stages - 1) for s in range(n_stages) if 0 <= t - s < M]
    assert seen == ticks * dp


def test_moe_pipeline_drops_the_aux_as_jax(ref):
    """An MoE model through the pipeline: the loss is JAX's pipeline loss,
    the cross entropy without the load-balancing term that ``loss_fn``
    adds."""
    jcfg = jtf.ModelConfig(**{**JCFG.__dict__, "n_experts": 4})
    jmesh, mesh = _meshes()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    stacked = jpp.stack_stage_params(jcfg, params, SHAPE[1])
    tokens = _tokens()
    want = float(jax.jit(jpp.pipeline_loss_fn(jcfg, jmesh, M))(stacked, jnp.asarray(tokens)))
    cfg = tcfg(jcfg)
    staged = tpp.stages_from_jax(cfg, jax.tree.map(np.asarray, stacked), "cpu")
    tok = torch.from_numpy(tokens).long()
    got = float(tpp.pipeline_loss_fn(cfg, mesh, M)(staged, tok))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    model = ttf.params_from_jax(cfg, jax.tree.map(np.asarray, params), "cpu")
    logits, aux = ttf.forward(cfg, model, tok[:, :-1], return_aux=True)
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, tok[:, 1:, None]).mean()
    np.testing.assert_allclose(got, float(nll), rtol=RTOL)
    np.testing.assert_allclose(float(ttf.loss_fn(cfg, model, tok)), float(nll + aux), rtol=RTOL)
    assert float(aux) > 1e-3
