"""The engine's compiled steps in the port, on the CPU.

On the card ``DecodeEngine._compile`` captures the decode, speculative and
chunked-prefill steps as CUDA graphs; a capture refuses a host sync or a
tensor made from host data inside the step.  Here, on the CPU, where
``_compile`` returns the step's impl itself:

- the chunk kernels' interface: ``write_tokens_at`` and
  ``paged_prefill_attention`` build their device ``meta`` from Python ints
  or 0-d tensors alike, and both give the JAX package's results (the
  writes bit for bit, the prefill within the serving tolerance; JAX's
  Pallas prefill in interpret mode), flat and at a page stride of 2;
- the engine's step impls, with the kernels' plain versions stood in for
  by shape-correct stubs, run no op that syncs with the host or makes a
  tensor from host data (a ``TorchDispatchMode`` records every aten op):
  what the card would refuse at capture.  The kernels' own capture is
  proved on the card (``chip_smoke.py`` phases 2 and 11);
- ``serving_census.step_kernels`` and ``parallel.mesh.maybe_init_distributed``.
"""

import os
import socket
import subprocess
import sys
import types
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu.serving import prefill as jpre
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.parallel import mesh as tmesh
from tf_flash_attention_tpu_torch.serving import decode as tdec
from tf_flash_attention_tpu_torch.serving import engine as teng
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv
from tf_flash_attention_tpu_torch.serving import prefill as tpre
from tf_flash_attention_tpu_torch.utils.serving_census import step_kernels

from _torch_parity import (FORBIDDEN, _OpLog, assert_same_cache, cache_cfgs,  # noqa: F401
                           caches_from, one_torch_thread, random_state)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {False: 2e-5, True: 1e-3}   # test_torch_prefill.py's float32 and int8 tolerances
SCALARS = {"int": lambda x: x, "tensor": lambda x: torch.tensor(x, dtype=torch.int32)}


@pytest.mark.parametrize("stride", [1, 2], ids=["flat", "stride2"])
@pytest.mark.parametrize("quantized", [False, True], ids=["unquantized", "int8"])
def test_write_tokens_meta_matches_jax(quantized, stride):
    """Two chunks (the second padded) at slot 1 on every shard of the
    stride: the port's cache equals JAX's bit for bit, lengths included,
    whether slot, start and true_len are ints or 0-d tensors."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = cache_cfgs(quantized, page_size=16, n_pages=16, max_pages_per_seq=4)
    trash = tcfg.n_pages - 1
    state = random_state(tcfg, rng, [0, 0, 0])
    chunks = [(0, 32, rng.uniform(-2, 2, (2, 2, 32, 32)).astype(np.float32)),
              (32, 21, rng.uniform(-2, 2, (2, 2, 32, 32)).astype(np.float32))]
    for offset in range(stride):
        jc = caches_from(state, jcfg, tcfg)[0]
        for start, n, (k, v) in chunks:
            jc = jkv.write_tokens_at(jc, jcfg, 1, start, jnp.asarray(k), jnp.asarray(v), n,
                                     trash, page_stride=stride, page_offset=offset)
        for kind, as_scalar in SCALARS.items():
            tc = caches_from(state, jcfg, tcfg)[1]
            for start, n, (k, v) in chunks:
                tkv.write_tokens_at(tc, tcfg, as_scalar(1), as_scalar(start), torch.from_numpy(k),
                                    torch.from_numpy(v), as_scalar(n), trash, stride, offset)
            assert_same_cache(jc, tc, trash)
            assert int(tc.lengths[1]) == int(jc.lengths[1]), (kind, offset)


@pytest.mark.parametrize("stride", [1, 2], ids=["flat", "stride2"])
@pytest.mark.parametrize("rule", ["causal", "local"])
@pytest.mark.parametrize("quantized", [False, True], ids=["unquantized", "int8"])
def test_prefill_meta_matches_jax(quantized, rule, stride):
    """A 32-row chunk at 40 with 27 real rows, on every shard of the
    stride: the port's prefill within the serving tolerance of JAX's, and
    the int and 0-d tensor scalars bit-equal."""
    rng = np.random.default_rng(6)
    jcfg, tcfg = cache_cfgs(quantized, page_size=16, n_pages=28, max_pages_per_seq=8)
    jc, tc = caches_from(random_state(tcfg, rng, [0, 0, 0]), jcfg, tcfg)
    start, true_len = 40, 27
    q = rng.uniform(-1, 1, (32, 4, 32)).astype(np.float32)
    jkw, tkw = {}, {}
    if rule == "local":
        jkw["rule"], tkw["rule"] = JLocalRule(24, 0, True), LocalRule(24, 0, True)
    for offset in range(stride):
        want = np.asarray(jpre.paged_prefill_attention(
            q, jc, jcfg, 1, start, true_len, page_stride=stride, page_offset=offset,
            interpret=True, **jkw))[:true_len]
        got = {kind: tpre.paged_prefill_attention(
            torch.from_numpy(q), tc, tcfg, f(1), f(start), f(true_len), page_stride=stride,
            page_offset=offset, **tkw).numpy()[:true_len] for kind, f in SCALARS.items()}
        np.testing.assert_array_equal(got["int"], got["tensor"])
        np.testing.assert_allclose(got["int"], want, rtol=0, atol=TOL[quantized])


def test_metas_are_jax_metas():
    """The meta rows hold what JAX's wrappers stack (kv_cache.py:386-389,
    prefill.py:241-257): the chunk write's (slot, start, total, trash,
    offset), the prefill's (slot, count, total, start, first_live, offset)
    with JAX's count and first live page."""
    w = tkv.chunk_write_meta(torch.tensor(2), 48, torch.tensor(13), 15, 4)
    assert w.dtype == torch.int32 and w.tolist() == [[2, 48, 61, 15, r] for r in range(4)]
    rule = LocalRule(20, 0, True)
    cfg = cache_cfgs(False, page_size=16)[1]
    p = tpre.prefill_meta(cfg, 1, torch.tensor(70), 9, rule, 3)
    # 79 tokens: global pages 0-4, shard r owning g % 3 == r; the window of
    # row 70 reaches back to 51 (global page 3)
    assert p.tolist() == [[1, 2, 79, 70, 1, 0], [1, 2, 79, 70, 1, 1], [1, 1, 79, 70, 1, 2]]


# ---- the engine's step impls run no host sync ----

MCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                       d_ff=128, dtype=torch.float32)
ECFG = teng.EngineConfig(max_seqs=2, page_size=16, n_pages=16, max_pages_per_seq=4,
                         prefill_chunk=16, prefix_caching=False)
def _zeros_like_out(q, returning_l_m):
    """A kernel's shape-correct output: o like q, l and m over its rows."""
    o = torch.zeros_like(q)
    if not returning_l_m:
        return o
    return o, torch.zeros(q.shape[:-1]), torch.zeros(q.shape[:-1])


@pytest.fixture
def stub_kernels(monkeypatch):
    """The five serving kernels' plain versions stood in for by stubs."""
    monkeypatch.setattr(tkv, "_write_tokens_plain", lambda *a, **k: None)
    monkeypatch.setattr(tkv, "_append_tokens_plain", lambda *a, **k: None)
    monkeypatch.setattr(tpre, "_paged_prefill_plain",
                        lambda qs, cache, cfg, meta, rule, lm=False, stride=1:
                        _zeros_like_out(qs, lm))
    for name in ("_paged_decode_plain", "_paged_multitoken_decode_plain"):
        monkeypatch.setattr(tdec, name, lambda q, cache, cfg, scale, rule, lm=False, *a, **k:
                            _zeros_like_out(q, lm))


def _engine(layout):
    params = ttf.init_params(MCFG, torch.Generator().manual_seed(0), device="cpu")
    ecfg, mcfg, kw = ECFG, MCFG, dict(device="cpu")
    if layout == "cp2":
        kw = dict(mesh=tmesh.make_mesh((2,), ("seq",), ["cpu"] * 2))
    elif layout == "tp2":
        kw = dict(mesh=tmesh.make_mesh((2,), ("model",), ["cpu"] * 2))
    elif layout == "speculative":
        ecfg = teng.EngineConfig(**{**ECFG.__dict__, "speculative_tokens": 3})
    elif layout == "window":
        mcfg = ttf.ModelConfig(**{**MCFG.__dict__, "rule": LocalRule(16, 0, True)})
        ecfg = teng.EngineConfig(**{**ECFG.__dict__, "max_pages_per_seq": 8, "n_pages": 20})
    return teng.DecodeEngine(mcfg, params, ecfg, **kw)


@pytest.mark.parametrize("layout", ["flat", "cp2", "tp2", "speculative", "window"])
def test_step_impls_are_capture_safe(layout, stub_kernels):
    eng = _engine(layout)
    # on the CPU the compiled steps are the impls themselves
    assert eng._decode_step == eng._decode_step_impl
    assert eng._chunk_prefill == eng._chunk_prefill_impl
    eng._upload(eng._in_chunk, np.arange(1, 17))
    eng._upload(eng._in_meta, [1, 16, 11])
    eng._upload(eng._in_tokens, [3, 4])
    eng._upload(eng._in_active, [True, False])
    eng._upload(eng._in_drafts, np.full(eng._in_drafts.shape, 5))
    with _OpLog() as log:
        logits, = eng._chunk_prefill_impl(eng._in_chunk, eng._in_meta)
        if layout == "speculative":
            greedy, step_logits = eng._spec_step_impl(eng._in_drafts, eng._in_active)
        else:
            greedy, step_logits = eng._decode_step_impl(eng._in_tokens, eng._in_active)
    assert logits.shape == (MCFG.vocab,)
    assert greedy.shape == eng._in_drafts.shape if layout == "speculative" else (2,)
    assert step_logits.shape == (2, MCFG.vocab)
    assert log.ops["aten.mm"] > 0          # the mode saw the layers
    assert not FORBIDDEN & set(log.ops), sorted(FORBIDDEN & set(log.ops))
    # the mode does catch a sync and a host-made tensor
    with _OpLog() as check:
        int(torch.tensor(3) + 1)
    assert {"aten._local_scalar_dense", "aten.lift_fresh"} <= set(check.ops)


# ---- the census under graphs; the process group ----

def test_step_kernels_counts_a_graph_once():
    """An eager step's kernels are the profiler's; a graphed step's also
    carry its graph's nodes from the capture and its replays."""
    counts = Counter({"kv_append_kernel": 2, "gemm": 5, "Memcpy HtoD": 1})
    eager = step_kernels(lambda: None, counts)
    assert eager["kernels"] == 7 and eager["copies"] == 1 and "graph" not in eager
    g = types.SimpleNamespace(nodes={"kernels": 375, "copies": 0, "other": 0},
                              launches={"paged_decode": 8, "kv_append": 8}, replays=4)
    graphed = step_kernels(types.SimpleNamespace(graphs={"key": g}), counts)
    assert graphed["graph"] == {"nodes": g.nodes, "wrapper_launches": 16, "replays": 4}
    assert graphed["kernels"] == 7


def test_maybe_init_distributed_without_environment(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.maybe_init_distributed() is False


def test_maybe_init_distributed_starts_a_group():
    """A world of one gloo process from COORDINATOR_ADDRESS, in a
    subprocess: True, and the group is up."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "COORDINATOR_ADDRESS": f"localhost:{port}", "WORLD_SIZE": "1",
           "RANK": "0"}
    env.pop("MASTER_ADDR", None)
    code = ("import torch.distributed as dist\n"
            "from tf_flash_attention_tpu_torch.parallel.mesh import maybe_init_distributed\n"
            "print(maybe_init_distributed(), dist.get_world_size(), dist.get_backend(),\n"
            "      maybe_init_distributed())\n"
            "dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1", "gloo", "True"]
