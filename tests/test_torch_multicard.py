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
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.models.transformer import params_from_jax
from tf_flash_attention_tpu_torch.parallel import mesh as tmesh
from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

import _torch_mp_world as mpw

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


def test_graphs_with_a_backward_take_one_card():
    """A training step's or an attention callable's graph runs autograd,
    whose per-card threads leave a capture across cards: both refuse more
    than one device before touching one, and the factories give the eager
    function over several cards."""
    from tf_flash_attention_tpu_torch.serving import graphs

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], capturable=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        graphs.GraphedTrainStep(lambda params, tokens: None, opt, cards)
    with pytest.raises(ValueError, match="one CUDA device"):
        graphs.GraphedFunction(lambda x: x, cards)
    mesh = tmesh.make_mesh((2,), ("model",), cards)
    assert not isinstance(graphs.graph_callable(lambda x: x, mesh), graphs.GraphedFunction)
    assert not isinstance(graphs.graph_train_step(lambda p, t: None, opt, mesh),
                          graphs.GraphedTrainStep)
