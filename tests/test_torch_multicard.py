"""The port across the cards of one host, what the CPU can hold of it.

- ``native._launch`` takes the device of its tensors: a launch whose
  tensors lie on two devices, or on no CUDA device, raises before any
  pointer reaches a kernel (on the card it launches under that device's
  guard on its current stream: ``test_torch_cuda.py`` holds each kernel
  family on ``cuda:1`` while ``cuda:0`` is current).
- ``parallel.mesh.maybe_init_distributed`` binds a rank to
  ``cuda:{LOCAL_RANK}`` before the group starts (the card as the group's
  ``device_id``, a timeout), and leaves the device alone on the CPU, where a
  world of four processes started with torchrun's environment joins a gloo
  group and makes a mesh whose subgroups the NCCL warm-up's exchanges reach.
- The single-controller engine on a mesh of ``"cpu"`` four times (the code
  that on the card runs one graph a step across four cards) for tp = 4,
  cp = 4 and model 2 x seq 2, against the JAX engine on four CPU devices
  with the same mesh: equal float32 greedy tokens.
- The graphs with a backward (``GraphedTrainStep``, ``GraphedFunction``)
  span the cards too: over two cards the factories return them holding
  both, the first named first, and the functions they capture run their
  backward with autograd's multithreading off (the capturing thread's
  streams are the capture's), GPipe's nested per-tick backward included.
  Those functions, run eagerly on ``"cpu"`` four times for the four
  training layouts of four slots (dense sp, cp, MoE, GPipe) and the ring,
  Ulysses and sharded callables, equal the default autograd run bit for
  bit and JAX's jitted steps and ``shard_map`` callables on four CPU
  devices within the tolerances of ``test_torch_mp_train.py``.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import pipeline as jpp
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.models.transformer import params_from_jax
from tf_flash_attention_tpu_torch.parallel import mesh as tmesh
from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
from tf_flash_attention_tpu_torch.serving import graphs

import _torch_mp_world as mpw
import test_torch_mp_train as mpt
from test_torch_sharded_train import STEP_ATOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("devices", [["cpu", "meta"], ["cpu"], ["meta"], []],
                         ids=["two-devices", "cpu", "meta", "no-tensor"])
def test_launch_takes_one_cuda_device(devices, monkeypatch):
    """A launch's tensors must lie on one CUDA device; anything else raises
    before the library is even loaded."""
    monkeypatch.setattr(native, "library", lambda source: pytest.fail("loaded the library"))
    args = [torch.zeros(4, device=d) for d in devices]
    with pytest.raises(ValueError, match="one CUDA device"):
        native._call("fa_kv_append", 0, 1, *args, None, 3)


def test_launch_refusal_counts_nothing(monkeypatch):
    monkeypatch.setattr(native, "library", lambda source: pytest.fail("loaded the library"))
    before = dict(native.LAUNCHES)
    with pytest.raises(ValueError, match=r"\['cpu', 'meta'\]"):
        native._call("fa_paged_decode", torch.zeros(1), torch.zeros(1, device="meta"))
    assert dict(native.LAUNCHES) == before


class _Recorder:
    """Stands in for ``torch.distributed.init_process_group`` and
    ``torch.cuda.set_device``, recording the calls in order."""

    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init_process_group", kw))

    def set_device(self, dev):
        self.calls.append(("set_device", torch.device(dev)))


def _torchrun_env(monkeypatch, rank, local_rank, world=4, coordinator=False):
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if coordinator:
        monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:29500")
    else:
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))


@pytest.mark.parametrize("coordinator", [False, True], ids=["torchrun", "coordinator"])
@pytest.mark.parametrize("rank,local_rank,card", [(2, 2, 2), (5, 1, 1), (6, None, 2)],
                         ids=["local-2", "second-host", "rank-mod-cards"])
def test_maybe_init_distributed_binds_the_card(monkeypatch, coordinator, rank, local_rank, card):
    """Where CUDA is present the rank's card (``cuda:{LOCAL_RANK}``, else
    its rank modulo the cards) is made current before the NCCL group
    starts, and the group gets it as its ``device_id`` and a timeout."""
    import torch.distributed as dist

    rec = _Recorder()
    _torchrun_env(monkeypatch, rank, local_rank, world=8, coordinator=coordinator)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", rec.init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", rec.set_device)
    assert tmesh.maybe_init_distributed() is True
    want = torch.device("cuda", card)
    assert [c[0] for c in rec.calls] == ["set_device", "init_process_group"]
    assert rec.calls[0][1] == want
    kw = rec.calls[1][1]
    assert (kw["backend"], kw["device_id"], kw["timeout"]) == ("nccl", want, tmesh.DIST_TIMEOUT)
    if coordinator:
        assert (kw["init_method"], kw["rank"], kw["world_size"]) == (
            "tcp://127.0.0.1:29500", rank, 8)
    else:
        assert kw["init_method"] == "env://"


def test_maybe_init_distributed_leaves_the_cpu_alone(monkeypatch):
    """Without CUDA: gloo, no device bound, the same timeout."""
    import torch.distributed as dist

    rec = _Recorder()
    _torchrun_env(monkeypatch, 1, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", rec.init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_device", rec.set_device)
    assert tmesh.maybe_init_distributed() is True
    assert [c[0] for c in rec.calls] == ["init_process_group"]
    kw = rec.calls[0][1]
    assert (kw["backend"], kw["timeout"], "device_id" in kw) == ("gloo", tmesh.DIST_TIMEOUT,
                                                                   False)


_RANK = r"""
import json, os, torch
import torch.distributed as dist
from tf_flash_attention_tpu_torch.parallel import collectives
from tf_flash_attention_tpu_torch.parallel.mesh import _warm_up, make_mesh, maybe_init_distributed
torch.set_num_threads(1)
up = maybe_init_distributed()
mesh = make_mesh((2, 2), ("data", "model"))
_warm_up([mesh.groups[a] for a in mesh.axis_names], mesh.device)
rank = dist.get_rank()
x = torch.full((3,), float(rank + 1))
s = collectives.psum([x], mesh.axis("model"))
p = collectives.ppermute([x], mesh.axis("data"), [(0, 1), (1, 0)])[0]
print(json.dumps(dict(up=up, rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
                      device=str(mesh.device), coords=mesh.coords(), psum=s.tolist(),
                      ppermute=p.tolist(), cuda_touched=torch.cuda.is_initialized(),
                      timeout=dist.distributed_c10d._get_default_group()._get_backend(
                          torch.device("cpu")).options._timeout.total_seconds())))
dist.destroy_process_group()
"""


def test_torchrun_world_on_gloo():
    """Four processes with torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``) start the
    group with ``maybe_init_distributed()`` alone, make a (data 2, model 2)
    mesh over it, run the NCCL warm-up's exchanges on its subgroups, and
    sum and permute over them; no process touches CUDA."""
    port = mpw.free_port()
    procs = []
    for rank in range(4):
        env = {k: v for k, v in os.environ.items() if k != "COORDINATOR_ADDRESS"}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="4", LOCAL_WORLD_SIZE="4",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, got in enumerate(outs):
        data, model = divmod(rank, 2)
        assert (got["up"], got["rank"], got["world"], got["backend"]) == (True, rank, 4, "gloo")
        assert got["device"] == "cpu" and not got["cuda_touched"]
        assert got["coords"] == {"data": data, "model": model}
        # model lines are ranks (2d, 2d + 1); data lines (m, m + 2)
        assert got["psum"] == [float(4 * data + 3)] * 3
        assert got["ppermute"] == [float(2 * (1 - data) + model + 1)] * 3
        assert got["timeout"] == tmesh.DIST_TIMEOUT.total_seconds()


MCFG = jtf.ModelConfig(**mpw.MODEL, max_seq=256, dtype=jnp.float32)


@pytest.fixture(scope="module")
def references():
    """Each layout's JAX engine on four CPU devices (the same mesh shape and
    axes), each jitted once for the module, and the numpy weights."""
    params_np = jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))
    params = jax.tree.map(jnp.asarray, params_np)
    tokens = {}
    for name, (shape, axes) in mpw.LAYOUTS.items():
        eng = jeng.DecodeEngine(MCFG, params, jeng.EngineConfig(**mpw.ENGINE),
                                mesh=jmake_mesh(shape, axes, jax.devices()[:4]))
        rids = [eng.submit(p, max_new_tokens=n) for p, n in mpw.REQUESTS]
        res = eng.run(max_steps=200)
        tokens[name] = [res[r] for r in rids]
    return dict(params=params_np, tokens=tokens)


@pytest.mark.parametrize("name", list(mpw.LAYOUTS))
def test_single_controller_engine_matches_jax_on_four_devices(references, name):
    """The port's engine driving four shards from one process (``"cpu"``
    four times: the code that on the card is one graph a step across four
    cards) gives the JAX engine's greedy float32 tokens on four devices of
    the same mesh, and holds every head shard's slices and every (seq, head)
    shard's caches itself."""
    shape, axes = mpw.LAYOUTS[name]
    torch_model = params_from_jax(mpw.model_cfg(), references["params"], "cpu")
    eng = DecodeEngine(mpw.model_cfg(), torch_model, EngineConfig(**mpw.ENGINE),
                       mesh=tmesh.make_mesh(shape, axes, ["cpu"] * 4))
    tp = dict(zip(axes, shape)).get("model", 1)
    assert (len(eng._params), len(eng.shards)) == (tp if tp > 1 else 1, 4)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in mpw.REQUESTS]
    res = eng.run(max_steps=200)
    assert [res[r] for r in rids] == references["tokens"][name]


# ---- the graphs with a backward across the cards ----

class _Stream:
    """Stands in for a ``torch.cuda.Stream`` of ``device``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def wait_stream(self, other):
        pass


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers built and their captures made without a card: streams
    and the pool handle stood in for, ``_capture`` calling the captured
    function once, PyTorch's capturable AdamW let onto the CPU."""
    import torch.optim.adam as torch_adam

    def capture(fn, streams, pool, generators=(), held=(), inputs=()):
        return graphs.Graph(graph=None, inputs=tuple(inputs), outputs=tuple(fn()), launches={},
                            nodes=None, pool_bytes=0, held=list(held),
                            devices=tuple(s.device for s in streams))

    monkeypatch.setattr(graphs, "capture_streams", lambda devices: tuple(map(_Stream, devices)))
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: ["cpu", "cuda"])


@pytest.mark.parametrize("order", [(0, 1), (1, 0, 1, 0)], ids=["0-1", "1-0-1-0"])
def test_graphs_with_a_backward_span_the_cards(no_card, order):
    """Over ``cuda:0`` and ``cuda:1`` (a mesh naming them in ``order``)
    ``graph_train_step`` and ``graph_callable`` return the graph wrappers,
    holding a capture stream on each card, the first named first; no card
    is touched."""
    cards = [torch.device("cuda", i) for i in order]
    home = (cards[0], cards[1])
    mesh = tmesh.make_mesh((len(cards),), ("model",), cards)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], capturable=True)
    step = graphs.graph_train_step(lambda p, t: None, opt, mesh)
    fn = graphs.graph_callable(lambda x: x, mesh)
    assert isinstance(step, graphs.GraphedTrainStep) and isinstance(fn, graphs.GraphedFunction)
    for wrapper in (step, fn):
        assert tuple(s.device for s in wrapper.streams) == home
        assert wrapper.stream.device == cards[0] and not wrapper.refuse


class _Threads(torch.autograd.Function):
    """The identity; its backward appends whether autograd's multithreading
    is on to ``seen``."""

    @staticmethod
    def forward(ctx, x, seen):
        ctx.seen = seen
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.seen.append(torch.autograd.is_multithreading_enabled())
        return g, None


def _nested_loss(seen):
    """``loss(params, tokens)`` shaped as GPipe's over a process group: a
    value whose backward runs an explicit ``torch.autograd.backward`` of
    another graph (``pipeline._LoopBackward``), which holds ``_Threads``."""
    from tf_flash_attention_tpu_torch.models import pipeline as tpp

    def loss(params, tokens):
        seen.append(torch.autograd.is_multithreading_enabled())
        inner = (_Threads.apply(params.weight, seen) * tokens).sum()

        def run(grad):
            torch.autograd.backward(inner, grad)

        return tpp._LoopBackward.apply(run, params.weight, inner.detach())

    return loss


@pytest.mark.parametrize("kind", ["train_step", "gpipe_nested", "callable"])
def test_graphed_backward_runs_in_the_calling_thread(no_card, kind):
    """Autograd's multithreading is off (thread-local) in the functions a
    graph captures over two cards, in their eager warm-up and in the
    capture: a train step's forward and backward, GPipe's nested per-tick
    backward, a callable's backward; it is on before and after, where the
    caller's own backward runs."""
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    seen = []
    x = torch.arange(3.0)
    if kind == "callable":
        fn = graphs.GraphedFunction(lambda t: _Threads.apply(t, seen) * 2, cards)
        leaf = x.clone().requires_grad_(True)
        out = fn(leaf)                               # the eager call, then the captures
        assert seen == [False, False]                # the warm-up's backward, the capture's
        torch.autograd.grad(out.sum(), leaf)         # the caller's own backward
        assert seen == [False, False, True]
        return
    params = torch.nn.Linear(3, 1, bias=False)
    opt = torch.optim.AdamW(params.parameters(), lr=1e-3, capturable=True)
    if kind == "gpipe_nested":
        loss_fn = _nested_loss(seen)
    else:
        def loss_fn(p, t):
            seen.append(torch.autograd.is_multithreading_enabled())
            return (_Threads.apply(p.weight, seen) * t).sum()
    step = graphs.GraphedTrainStep(loss_fn, opt, cards)
    step(params, x)                                  # the eager step, then the capture
    assert len(step.graphs) == 1 and seen == [False] * 4, seen
    assert torch.autograd.is_multithreading_enabled()
    loss_fn(params, x).backward()
    assert seen[-1] is True


# the training layouts and callables that phase 15 of chip_smoke.py graphs
# across four cards, at mpw's small sizes
CALLABLES = ["ring-causal", "ulysses", "sharded"]


@contextlib.contextmanager
def _default_autograd():
    """Autograd's multithreading left as the caller has it (the switch the
    captured functions throw made a no-op)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.autograd, "set_multithreading_enabled",
                  lambda mode: contextlib.nullcontext())
        yield


@pytest.fixture(scope="module")
def captured_functions():
    """The captured functions on ``"cpu"`` four times, through the calling
    thread's backward and through autograd's default, and JAX's jitted
    references on four CPU devices (each once for the module)."""
    params, tokens = {}, {}
    for name, (_, _, _, tshape) in mpw.TRAIN.items():
        p = jtf.init_params(mpt._jcfg(name), jax.random.PRNGKey(0))
        if name == "pipe":
            p = jpp.stack_stage_params(mpt._jcfg(name), p, mpw.TRAIN[name][0][1])
        params[name] = jax.tree.map(np.asarray, p)
        tokens[name] = np.random.default_rng(1).integers(0, 128, tshape).astype(np.int32)
    cpus = ["cpu"] * mpw.WORLD
    with torch.autograd.set_multithreading_enabled(False):
        callables = mpw.train_callables(cpus, CALLABLES)
    here = dict(layouts=mpw.train_layouts(params, tokens, cpus), callables=callables)
    with _default_autograd():
        default = dict(layouts=mpw.train_layouts(params, tokens, cpus),
                       callables=mpw.train_callables(cpus, CALLABLES))
    return dict(here=here, default=default,
                jax=mpt._jax_refs(params, tokens, list(mpw.TRAIN), CALLABLES))


@pytest.mark.parametrize("name", list(mpw.TRAIN))
def test_captured_steps_match_default_autograd_and_jax(captured_functions, name):
    """A layout's step (``train_once``: the function a ``GraphedTrainStep``
    captures) on ``"cpu"`` four times: its losses, gradients and
    parameters after 2 AdamW steps bit-equal to the same step under
    autograd's default threading, and against JAX's jitted step on four
    devices as ``test_torch_mp_train.py`` holds the ranks."""
    got = captured_functions["here"]["layouts"][name]
    want = captured_functions["default"]["layouts"][name]
    assert got["losses"] == want["losses"]
    for part in ("grads", "params"):
        assert got[part].keys() == want[part].keys()
        for k, w in want[part].items():
            np.testing.assert_array_equal(got[part][k], w, err_msg=f"{part} {k}")
    losses_j, params_j = captured_functions["jax"]["layouts"][name]
    np.testing.assert_allclose(got["losses"], losses_j, rtol=1e-5)
    flat = mpt._port_flat(name, got["params"])
    assert flat.keys() == params_j.keys()
    for k, w in params_j.items():
        np.testing.assert_allclose(flat[k], w, rtol=0,
                                   atol=STEP_ATOL * max(1.0, float(np.abs(w).max())), err_msg=k)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", CALLABLES)
def test_captured_callables_match_default_autograd_and_jax(captured_functions, name):
    """A callable's forward and ``torch.autograd.grad`` (what a
    ``GraphedFunction`` captures) in the calling thread on ``"cpu"`` four
    times: bit-equal to autograd's default, and within JAX's ring
    tolerance of its ``shard_map`` callable on four devices."""
    got = captured_functions["here"]["callables"][name]
    for a, b in zip(got, captured_functions["default"]["callables"][name]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, captured_functions["jax"]["callables"][name]):
        np.testing.assert_allclose(a, b, **mpt.TOL)
