"""Sliding-window models under tensor parallelism in the port's engine
against the JAX engine on the same mesh, on the CPU (the JAX side on its
virtual CPU devices, the port on ``"cpu"`` repeated): a ``LocalRule`` model
with lazy prompt paging and eviction, at a ``model`` axis of 2 and at model
2 x seq 2, with and without speculation, on ``test_serving.py``'s small
float32 model (no rounding order between the two packages can flip a
token)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.serving import engine as teng

from test_torch_tp_engine import MCFG, PATTERN, TCFG, _serve, _tp_mesh


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(params_np):
    return ttf.params_from_jax(TCFG, params_np, "cpu")


# a window of 8 (pages of 16): the 40-token prompt pages lazily and evicts
# while it prefills, both requests evict while they decode
WINDOW_ECFG = dict(max_seqs=2, page_size=16, n_pages=24, max_pages_per_seq=6, prefill_chunk=16,
                   quantized_kv=False)
WINDOW_REQS = [([(i * 7 + 1) % 64 for i in range(40)], 12), (PATTERN, 20)]


@pytest.mark.parametrize("spec", [0, 3], ids=["greedy", "speculative"])
@pytest.mark.parametrize("shape,names", [((1, 2), ("data", "model")), ((2, 2), ("model", "seq"))],
                         ids=["tp2", "tp2xcp2"])
def test_tp_window_engine(params_np, model, shape, names, spec):
    """A sliding-window model under TP (2, and model 2 x seq 2) against the
    JAX engine on the same mesh: tokens, stats, spec_stats and every
    allocator's free pages, with eviction, with and without speculation;
    the flat port engine's tokens as a second witness."""
    ecfg = dict(WINDOW_ECFG, speculative_tokens=spec)
    jm = dataclasses.replace(MCFG, rule=JLocalRule(8, 0, True))
    tm = dataclasses.replace(TCFG, rule=LocalRule(window_size=8, is_causal=True))
    n = int(np.prod(shape))
    je = jeng.DecodeEngine(jm, jax.tree.map(jnp.asarray, params_np), jeng.EngineConfig(**ecfg),
                           mesh=jmake_mesh(shape, names, jax.devices()[:n]))
    te = teng.DecodeEngine(tm, model, teng.EngineConfig(**ecfg), mesh=_tp_mesh(shape, names))
    assert (te.tp, te.cp) == (je.tp, je.cp) == (2, shape[1] if names[1] == "seq" else 1)
    want = _serve(je, WINDOW_REQS)
    got = _serve(te, WINDOW_REQS)
    assert got == want
    assert te.stats == je.stats and te.spec_stats == je.spec_stats
    assert te.stats["pages_evicted"] > 0 and (not spec or te.spec_stats["accepted"] > 0)
    assert [a.free_pages for a in te.allocators] == [a.free_pages for a in je.allocators]
    assert te._pages_cap == je._pages_cap and te.prefix_cache is None
    flat = teng.DecodeEngine(tm, model, teng.EngineConfig(**ecfg), device="cpu")
    assert _serve(flat, WINDOW_REQS) == got
