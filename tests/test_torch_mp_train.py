"""Training over a process group, on the CPU: one process a mesh slot.

One world of 4 processes joined by a gloo group (``_torch_mp_world.py``)
is spawned once for the module and runs every case: 2 AdamW steps of
``make_sharded_train_step`` on (data 2, model 2) (sp), (data 1, model 2,
context 2) (cp, the ring) and an MoE model on (data 2, model 2) (experts
over ``model``), of ``make_pipeline_train_step`` on (data 2, pipe 2), each
rank holding its slot's parameters (``slot_params``/``slot_stages``); the
ring (causal, full, a local rule) and Ulysses at context 4 and
``sharded_flash_attention`` on (data 2, model 2), forward and backward;
and the new collectives with their backwards.  Meanwhile this process
computes the references: JAX's jitted steps on ``jax.devices()[:4]`` and
its ``shard_map`` callables (Pallas kernels in interpret mode), and the
port's single-controller steps and callables on ``"cpu"`` four times.

Tolerances.  Against JAX, the existing ones: losses ``rtol 1e-5``,
parameters after the steps ``STEP_ATOL`` (``test_torch_sharded_train.py``),
callables ``2e-5`` (``test_torch_ring.py``).  Against the single-controller
port: the callables run the same kernels on the same blocks, so they are
bit-equal; a step's sums over processes add in shard order where the
single-controller step adds in autograd's order (the replicated
parameters' gradients, the norm scales' under sp, the MoE probability
sums), so its gradients part by float32 summation order (measured at most
1.3e-6 on gradients of at most 0.08, so ``GRAD_ATOL`` 1e-5), the losses
by at most a float32 rounding (``LOSS_RTOL`` 1e-6), and two AdamW steps
turn those into parameter differences of at most 2.3e-5 (AdamW's
``m / sqrt(v)`` at lr 1e-2 scales a small gradient's difference up), so
``PARAM_ATOL`` 1e-4 = lr / 100, a tenth of ``STEP_ATOL``.  Across ranks
everything is exact: every sum gathers and adds in shard order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.models import pipeline as jpp
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel import make_mesh as jmake_mesh
from tf_flash_attention_tpu.parallel import ring as jring
from tf_flash_attention_tpu.parallel import sharded_flash_attention as jsharded
from tf_flash_attention_tpu.parallel import ulysses_flash_attention as julysses
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel import collectives as col

import _torch_mp_world as mpw
from test_torch_moe import _flat_jax
from test_torch_pipeline import _flat_stacked
from test_torch_sharded_train import STEP_ATOL

LOSS_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-6, 1e-5, mpw.TRAIN_LR / 100
TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_parallel.py's ring tolerance
JBLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
LAYOUTS = list(mpw.TRAIN)
CALLABLES = list(mpw.CALLABLES)
JRULES = {"causal": jrules.CausalRule(), "full": jrules.FullRule(),
          "local": jrules.LocalRule(100, is_causal=True)}


def _jcfg(name):
    return jtf.ModelConfig(**{**mpw.TRAIN_MODEL, **mpw.TRAIN[name][2]}, dtype=jnp.float32)


def _jmesh(shape, axes):
    return jmake_mesh(shape, axes, jax.devices()[:mpw.WORLD])


def _jax_steps(name, params, tokens):
    """JAX's jitted steps with optax.adamw: the losses and the parameters
    after them, flat by the port's names."""
    shape, axes, _, _ = mpw.TRAIN[name]
    cfg, mesh, optimizer = _jcfg(name), _jmesh(shape, axes), optax.adamw(mpw.TRAIN_LR)
    params = jax.tree.map(jnp.asarray, params)
    if name == "pipe":
        step, shardings = jpp.make_pipeline_train_step(cfg, mesh, optimizer,
                                                       n_microbatches=mpw.MICROBATCHES)
        params = jax.device_put(params, shardings(params))
    else:
        step = jtf.make_sharded_train_step(cfg, mesh, optimizer)
        params = jax.device_put(params, jtf.param_shardings(cfg, mesh))
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(mpw.TRAIN_STEPS):
        loss, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    params = jax.tree.map(np.asarray, params)
    return losses, (_flat_stacked(params) if name == "pipe" else _flat_jax(params))


def _jax_callable(name):
    shape, kind, rule = mpw.CALLABLES[name]
    mesh = _jmesh(shape, ("data", "model", "context"))
    fn = {"ring": lambda: jring.ring_flash_attention(mesh, rule=JRULES[rule],
                                                     block_config=JBLOCKS),
          "ulysses": lambda: julysses(mesh, JRULES[rule], block_config=JBLOCKS),
          "sharded": lambda: jsharded(mesh, JRULES[rule], block_config=JBLOCKS)}[kind]()
    *qkv, do = mpw.callable_qkv(name)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, qkv))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _stacked(flat):
    """The port's gathered ``StagedTransformer`` names (``stages.s.j.x``)
    as JAX's stacked leaves (``layers.j.x`` with a leading stage axis)."""
    out = {k: v for k, v in flat.items() if not k.startswith("stages.")}
    by = {}
    for k, v in flat.items():
        if k.startswith("stages."):
            _, s, rest = k.split(".", 2)
            by.setdefault(f"layers.{rest}", {})[int(s)] = v
    out.update({k: np.stack([v[s] for s in sorted(v)]) for k, v in by.items()})
    return out


def _jax_refs(params, tokens, layouts, callables):
    """JAX's references of ``layouts`` and ``callables``; a second process
    computes one half while this one computes the other (JAX's
    interpret-mode compiles take most of the module's time)."""
    jax.config.update("jax_platforms", "cpu")
    return dict(layouts={n: _jax_steps(n, params[n], tokens[n]) for n in layouts},
                callables={n: _jax_callable(n) for n in callables})


@pytest.fixture(scope="module")
def world():
    """The ranks' results beside the references: {"ranks": {rank: ...},
    "single": the port single-controller, "jax": the JAX package's}."""
    params, tokens = {}, {}
    for name, (_, _, _, tshape) in mpw.TRAIN.items():
        p = jtf.init_params(_jcfg(name), jax.random.PRNGKey(0))
        if name == "pipe":
            p = jpp.stack_stage_params(_jcfg(name), p, mpw.TRAIN[name][0][1])
        params[name] = jax.tree.map(np.asarray, p)
        tokens[name] = np.random.default_rng(1).integers(0, 128, tshape).astype(np.int32)
    started = mpw.start(dict(params=params, tokens=tokens), case="train_world")
    pool = mp.get_context("spawn").Pool(1)
    try:
        other = pool.apply_async(_jax_refs, (params, tokens, ["dense", "moe"], CALLABLES))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        single = dict(layouts=mpw.train_layouts(params, tokens, ["cpu"] * mpw.WORLD),
                      callables=mpw.train_callables(["cpu"] * mpw.WORLD))
        torch.set_num_threads(n)
        ref = _jax_refs(params, tokens, ["cp", "pipe"], [])
        done = other.get(timeout=600)
        ref["layouts"].update(done["layouts"])
        ref["callables"].update(done["callables"])
    finally:
        pool.terminate()
        ranks = mpw.join(started)
    return dict(ranks=ranks, single=single, jax=ref)


def _port_flat(name, flat):
    return _stacked(flat) if name == "pipe" else flat


@pytest.mark.parametrize("name", LAYOUTS)
def test_steps_match_jax(world, name):
    """Every rank's losses and gathered parameters after 2 steps against
    JAX's jitted step on a 4-device mesh of the same shape."""
    losses_j, params_j = world["jax"]["layouts"][name]
    for rank, res in world["ranks"].items():
        got = res["layouts"][name]
        np.testing.assert_allclose(got["losses"], losses_j, rtol=1e-5, err_msg=str(rank))
        flat = _port_flat(name, got["params"])
        assert flat.keys() == params_j.keys()
        for k, want in params_j.items():
            np.testing.assert_allclose(flat[k], want, rtol=0,
                                       atol=STEP_ATOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"rank {rank} {k}")
    assert losses_j[-1] < losses_j[0]


@pytest.mark.parametrize("name", LAYOUTS)
def test_steps_match_single_controller(world, name):
    """Every rank against the single-controller port on ``"cpu"`` four
    times (the module's docstring gives the tolerances)."""
    want = world["single"]["layouts"][name]
    for rank, res in world["ranks"].items():
        got = res["layouts"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for part, atol in (("grads", GRAD_ATOL), ("params", PARAM_ATOL)):
            assert got[part].keys() == want[part].keys()
            for k, w in want[part].items():
                np.testing.assert_allclose(got[part][k], w, rtol=0, atol=atol,
                                           err_msg=f"rank {rank} {part} {k}")


@pytest.mark.parametrize("name", LAYOUTS)
def test_every_rank_equal(world, name):
    """Every rank's losses are equal, and so, bit for bit, is every
    parameter that two ranks both hold after the steps (the replicated
    ones everywhere, a model or stage slice on the ranks of that slice),
    and so is the whole model each gathers."""
    ranks = world["ranks"]
    first = ranks[0]["layouts"][name]
    for rank in range(1, mpw.WORLD):
        got = ranks[rank]["layouts"][name]
        assert got["losses"] == first["losses"], rank
        for k, w in first["params"].items():
            np.testing.assert_array_equal(got["params"][k], w, err_msg=f"rank {rank} {k}")
    shape, axes, _, _ = mpw.TRAIN[name]
    split = "pipe" if name == "pipe" else "model"
    slot = lambda r: dict(zip(axes, np.unravel_index(r, shape)))[split]
    sliced = lambda k: k.startswith("stages.") if name == "pipe" else "model" in ttf._spec(k)
    for a in range(mpw.WORLD):
        for b in range(a + 1, mpw.WORLD):
            held_a, held_b = (ranks[r]["layouts"][name]["held"] for r in (a, b))
            for k, w in held_a.items():
                if slot(a) == slot(b) or not sliced(k):
                    np.testing.assert_array_equal(held_b[k], w, err_msg=f"ranks {a} {b} {k}")


@pytest.mark.parametrize("name", LAYOUTS)
def test_rank_holds_its_slot(world, name):
    """A rank holds its slot's parameters only: under tp its model shard's
    slice of each model-sharded weight (``param_shardings``) and the rest
    whole, under the pipeline its stage's layers; each equal to its slice
    of the whole model that the ranks gather."""
    shape, axes, _, _ = mpw.TRAIN[name]
    for rank, res in world["ranks"].items():
        got = res["layouts"][name]
        at = dict(zip(axes, np.unravel_index(rank, shape)))
        whole = got["params"]
        if name == "pipe":
            s = at["pipe"]
            assert {k for k in got["held"] if k.startswith("stages.")} == {
                k.replace(f"stages.{s}.", "stages.0.", 1) for k in whole
                if k.startswith(f"stages.{s}.")}
            for k, v in got["held"].items():
                np.testing.assert_array_equal(
                    v, whole[k.replace("stages.0.", f"stages.{s}.", 1)], err_msg=k)
            continue
        assert got["held"].keys() == whole.keys()
        sliced = 0
        for k, v in got["held"].items():
            spec = ttf._spec(k)
            want = whole[k]
            if "model" in spec:
                want = np.split(want, shape[axes.index("model")], spec.index("model"))[at["model"]]
                sliced += 1
            np.testing.assert_array_equal(v, want, err_msg=f"rank {rank} {k}")
        # q, k, v, o and the MLP's three (or the experts' two) a layer
        assert sliced == mpw.TRAIN_MODEL["n_layers"] * (6 if name == "moe" else 7)


@pytest.mark.parametrize("name", CALLABLES)
def test_callables_match_jax(world, name):
    """The output and dQ/dK/dV on every rank (whole) against JAX's
    ``shard_map`` callable on a mesh of the same shape."""
    want = world["jax"]["callables"][name]
    for rank, res in world["ranks"].items():
        for got, w, what in zip(res["callables"][name], want, ("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(got, w, **TOL, err_msg=f"rank {rank} {what}")


@pytest.mark.parametrize("name", CALLABLES)
def test_callables_match_single_controller(world, name):
    """The same calls bit for bit against the single-controller callables
    (the same kernels on the same blocks; the gathers only move data)."""
    want = world["single"]["callables"][name]
    for rank, res in world["ranks"].items():
        for got, w, what in zip(res["callables"][name], want, ("o", "dq", "dk", "dv")):
            np.testing.assert_array_equal(got, w, err_msg=f"rank {rank} {what}")


# ---- the collectives over the group, from mpw.collective_checks ----

def _line(rank, axis):
    """The ranks of ``rank``'s line of axis "a" (rows) or "b" on the (2, 2)
    mesh, in order."""
    i, j = divmod(rank, 2)
    return [2 * k + j for k in range(2)] if axis == "a" else [2 * i + k for k in range(2)]


def _x(rank):
    return np.arange(4.0).reshape(2, 2) + 10 * rank


def _expect(name, rank):
    """(forward, gradient) of ``name`` on ``rank``, the cotangent on each
    rank ``rank + 1`` everywhere (``mpw.collective_checks``)."""
    w = lambda r: float(r + 1)
    a, b = _line(rank, "a"), _line(rank, "b")
    me_b = b.index(rank)
    ones = np.ones((2, 2))
    if name == "psum":        # identity backward
        return sum(_x(r) for r in a), w(rank) * ones
    if name == "pvary":       # psum backward
        return _x(rank), sum(w(r) for r in a) * ones
    if name == "all_gather":  # reduce-scatter backward: every rank's cotangent of my piece
        return np.stack([_x(r) for r in b]), sum(w(r) for r in b) * ones
    if name == "all_gather_invariant":
        return np.stack([_x(r) for r in b]), w(rank) * ones
    if name == "piece":       # backward: the pieces' cotangents gathered
        return _x(rank)[me_b:me_b + 1], np.stack([w(r) * np.ones(2) for r in b])
    if name == "psum_scatter":   # backward: all_gather
        return sum(_x(r) for r in b)[me_b:me_b + 1], np.stack([w(r) * np.ones(2) for r in b])
    if name == "ppermute":    # (0, 1) along "b": index 1 gets index 0's; backward the reverse
        fwd = _x(b[0]) if me_b == 1 else np.zeros((2, 2))
        return fwd, (w(b[1]) * ones if me_b == 0 else np.zeros((2, 2)))
    if name == "all_to_all":  # split dim 0, concat dim 1 along "a"
        me_a = a.index(rank)
        fwd = np.concatenate([_x(r)[me_a:me_a + 1] for r in a], axis=1)
        return fwd, np.stack([w(r) * np.ones(2) for r in a])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["psum", "pvary", "all_gather", "all_gather_invariant",
                                  "piece", "psum_scatter", "ppermute", "all_to_all"])
def test_collective_and_its_backward_over_gloo(world, name):
    """Each differentiable collective's forward and JAX-transpose backward
    on every rank of the gloo world."""
    for rank, res in world["ranks"].items():
        fwd, grad = res["collectives"][name]
        want_fwd, want_grad = _expect(name, rank)
        np.testing.assert_array_equal(fwd, want_fwd, err_msg=f"rank {rank} forward")
        np.testing.assert_array_equal(grad, want_grad, err_msg=f"rank {rank} backward")


def test_ppermute_bf16_and_gradient_sums_over_gloo(world):
    """A bf16 swap along "b" (raw bytes through gloo), ``psum_gradients``
    over both lines (a missing gradient counts as zeros), and ``CALLS``
    counting the process-group calls (backwards included)."""
    for rank, res in world["ranks"].items():
        m = res["collectives"]
        other = _line(rank, "b")[1 - _line(rank, "b").index(rank)]
        np.testing.assert_array_equal(m["ppermute_bf16"], [other + 0.5] * 3)
        p, q = m["psum_gradients"]
        np.testing.assert_array_equal(p, [6.0, 6.0])          # 0 + 1 + 2 + 3
        np.testing.assert_array_equal(q, [0.0] * 3)
        # forwards and backwards: psum 1 + pvary's 1 + the gradient sums' 2;
        # all_gather 2 + piece's and psum_scatter's backwards
        assert m["calls"] == {"psum": 4, "all_gather": 4, "psum_scatter": 2, "ppermute": 3,
                              "all_to_all": 2}


# ---- the in-process forms ----

def test_ppermute_in_process_moves_and_sends_gradients_back():
    """In process (every shard's part), a pair's part lands on its new
    slot, a slot no pair ends at gets zeros, and autograd sends the
    gradients back along the inverse permutation."""
    parts = [torch.full((2,), float(i), requires_grad=True) for i in range(3)]
    out = col.ppermute(parts, col.LOCAL, [(0, 1), (1, 2)])
    assert [o.tolist() for o in out] == [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]
    assert not out[0].requires_grad
    grads = torch.autograd.grad(out[1:], parts, [torch.full((2,), 10.0 * i) for i in (1, 2)],
                                allow_unused=True)
    assert [g.tolist() for g in grads[:2]] == [[10.0, 10.0], [20.0, 20.0]] and grads[2] is None


def test_all_to_all_in_process_is_the_tiled_exchange():
    """Shard j receives piece j of every shard along the split dim,
    concatenated in shard order; applying the inverse exchange restores
    the parts."""
    parts = [torch.arange(6.0).reshape(3, 2) + 100 * i for i in range(3)]
    out = col.all_to_all(parts, col.LOCAL, 0, 1)
    for j, o in enumerate(out):
        assert torch.equal(o, torch.cat([p[j:j + 1] for p in parts], 1))
    back = col.all_to_all(out, col.LOCAL, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))


def test_training_pairs_pass_through_in_process():
    """``pvary``, ``psum_scatter``, ``piece`` and ``all_gather_invariant``
    on an in-process axis (one process holding every shard, where ``.to``
    does their work) return their input as it is."""
    x = torch.arange(4.0).reshape(2, 2)
    assert col.pvary(x, col.LOCAL) is x and col.psum_scatter(x, col.LOCAL, 0) is x
    assert col.piece(x, col.LOCAL, 0) is x and col.all_gather_invariant(x, col.LOCAL) == [x]
