"""The port's compiled training steps, attention callables and bucketed
prefill, on the CPU.

On the card ``make_sharded_train_step`` and ``make_pipeline_train_step``
capture a step (forward, backward, the optimizer's step) as a CUDA graph,
the parallel attention callables a forward and a backward graph, and the
engine its bucketed prefill and first-token sampler; a capture refuses a
host sync or a tensor made from host data.  Here, on the CPU, where the
factories return the eager functions:

- (a) ``_rope`` keeps its inverse frequencies in a device cache: the
  cached frequencies are the JAX package's numpy ones bit for bit, the
  rotation is bit-equal to the uncached formula and to JAX's ``_rope``
  (bf16; float32 within an ulp: XLA's and PyTorch's cos/sin differ in the
  last bit), and after its first call it makes no tensor from host data;
- (b) the steps of the dense model, (data 2, model 2), context 2 and
  (model 2, context 2), MoE and
  the pipeline, and the bucketed ``_prefill_impl`` and ``_sample1_impl``,
  run no op that syncs with the host or makes a tensor from host data, the
  op kernels' plain versions stood in for by shape-correct stubs: an aten
  recorder (``_torch_parity._OpLog``) and a guard on ``torch.from_numpy``,
  ``torch.tensor`` and ``torch.as_tensor``, which the recorder cannot see.
  The optimizer is the capturable AdamW the card captures, with PyTorch's
  device check widened to the CPU;
- (c) the bucketed prefill with ``true_len`` a 0-d tensor in one static
  buffer, at two lengths of one bucket, against the JAX engine's jitted
  ``_prefill_impl`` (Pallas in interpret mode);
- (d) the card-side rules: a non-capturable optimizer is refused with a
  ``ValueError`` before any CUDA call, the layouts that are captured, and
  the eager functions the factories return on the CPU.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.optim.adam as torch_adam

from tf_flash_attention_tpu.models import transformer as jtf
from tf_flash_attention_tpu.serving import engine as jeng
from tf_flash_attention_tpu_torch.mask_rules import CausalRule
from tf_flash_attention_tpu_torch.models import pipeline as tpipe
from tf_flash_attention_tpu_torch.models import transformer as ttf
from tf_flash_attention_tpu_torch.ops import backward as tbwd
from tf_flash_attention_tpu_torch.ops import forward as tfwd
from tf_flash_attention_tpu_torch.parallel import (make_mesh, ring_flash_attention,
                                                   sharded_flash_attention,
                                                   ulysses_flash_attention)
from tf_flash_attention_tpu_torch.serving import engine as teng
from tf_flash_attention_tpu_torch.serving import graphs

from _torch_parity import FORBIDDEN, _OpLog, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TCFG = ttf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                       d_ff=128, dtype=torch.float32)


# ---- (a) the rotary embedding's device cache ----

def _jax_freqs(d, theta):
    """The JAX package's inverse frequencies (``models/transformer.py:182``)."""
    half = d // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def _rope_uncached(x, theta, pos0):
    """The port's ``_rope`` as it was before the cache: the numpy
    frequencies made into a tensor on every call."""
    s, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = pos0 + torch.arange(s, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * torch.from_numpy(_jax_freqs(d, theta)).to(x.device)[None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s, d, pos0", [(64, 16, 0), (300, 64, 0), (37, 128, 4096)])
def test_rope_cache_matches_jax(dtype, s, d, pos0):
    x = np.random.default_rng(s + d).standard_normal((2, 3, s, d)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ttf._rope(tx, 10000.0, pos0)
    np.testing.assert_array_equal(ttf._inverse_freqs(d, 10000.0, "cpu").numpy(),
                                  _jax_freqs(d, 10000.0))
    assert torch.equal(got, _rope_uncached(tx, 10000.0, pos0))
    want = np.asarray(jtf._rope(jnp.asarray(x).astype(getattr(jnp, dtype)), 10000.0, pos0)
                      .astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=float(np.spacing(np.abs(want).max())))


@contextlib.contextmanager
def no_host_data(monkeypatch):
    """``torch.from_numpy``, ``torch.tensor`` and ``torch.as_tensor`` raise
    inside: a tensor made from host data, which the aten recorder sees only
    as ``lift_fresh`` (``torch.tensor``) or not at all."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"torch.{name} inside a captured function")
        return fn

    with monkeypatch.context() as m:
        for name in ("from_numpy", "tensor", "as_tensor"):
            m.setattr(torch, name, refuse(name))
        yield


def test_rope_makes_no_host_tensor_after_its_first_call(monkeypatch):
    x = torch.randn(1, 2, 8, 32)
    theta = 12345.0                          # a key no other test fills
    first = ttf._rope(x, theta)
    assert (32, theta, torch.device("cpu")) in ttf._INV_FREQS
    with no_host_data(monkeypatch), _OpLog() as log:
        again = ttf._rope(x, theta, 8)
        at = teng._rope_at(x[0].transpose(0, 1), torch.arange(8), theta)
    assert not FORBIDDEN & set(log.ops), sorted(FORBIDDEN & set(log.ops))
    assert torch.equal(first, ttf._rope(x, theta)) and again.shape == x.shape
    assert at.shape == (8, 2, 32)


# ---- (b) the compiled functions hold no host sync ----

@pytest.fixture
def stub_op_kernels(monkeypatch):
    """The op kernels' plain versions stood in for by shape-correct stubs
    (on the card the kernels run there), and PyTorch's capturable AdamW let
    onto the CPU."""
    def fwd(q_scaled, k, v, pack, rule):
        rows = q_scaled.shape[:2]
        return (q_scaled.new_zeros((*rows, v.shape[-1])), torch.ones(rows),
                torch.zeros(rows))

    def bwd(q, k, v, do, lse2, delta, pack, rule, scale, fused):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(tfwd, "_flash_forward_plain", fwd)
    monkeypatch.setattr(tbwd, "_flash_backward_plain", bwd)
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: ["cpu", "cuda"])


def _train_case(layout):
    """(step, params, tokens) of ``layout`` on the CPU, with a capturable
    AdamW."""
    cfg, devs = TCFG, ["cpu"] * 4
    if layout == "moe":
        cfg = dataclasses.replace(TCFG, n_experts=4)
    elif layout in ("cp2", "cp4"):
        cfg = dataclasses.replace(TCFG, context_parallel=True)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(1))
    if layout == "pipeline":
        staged = tpipe.stack_stage_params(cfg, params, 2)
        opt = torch.optim.AdamW(staged.parameters(), lr=1e-3, capturable=True)
        mesh = make_mesh((2, 2), ("data", tpipe.AXIS_PIPE), devs)
        return tpipe.make_pipeline_train_step(cfg, mesh, opt, 2)[0], staged, tokens
    opt = torch.optim.AdamW(params.parameters(), lr=1e-3, capturable=True)
    mesh = {"dense": make_mesh((1, 1), ("data", "model"), devs[:1]),
            "tp2": make_mesh((2, 2), ("data", "model"), devs),
            "cp2": make_mesh((1, 1, 2), ("data", "model", "context"), devs[:2]),
            "cp4": make_mesh((1, 2, 2), ("data", "model", "context"), devs),
            "moe": make_mesh((2, 2), ("data", "model"), devs)}[layout]
    return ttf.make_sharded_train_step(cfg, mesh, opt), params, tokens


@pytest.mark.parametrize("layout", ["dense", "tp2", "cp2", "cp4", "moe", "pipeline"])
def test_train_steps_are_capture_safe(layout, stub_op_kernels, monkeypatch):
    """The second step (the one a graph captures: the first made the
    optimizer's state and filled the caches) under the recorder and the
    host-data guard: forward, backward and the optimizer's step.  tp2
    (sp), cp4, moe and pipeline are the layouts of four slots that a graph
    spans four cards with."""
    step, params, tokens = _train_case(layout)
    assert not isinstance(step, graphs.GraphedTrainStep)      # the CPU runs it eagerly
    before = [p.detach().clone() for p in params.parameters()]
    step(params, tokens)
    with no_host_data(monkeypatch), _OpLog() as log:
        loss = step(params, tokens)
    assert log.ops["aten.mm"] > 0 and log.ops["aten.addcdiv_"] + log.ops["aten._foreach_addcdiv_"]
    assert not FORBIDDEN & set(log.ops), sorted(FORBIDDEN & set(log.ops))
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in zip(before, params.parameters()))


MCFG_J = jtf.ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)
ECFG = dict(max_seqs=2, page_size=16, n_pages=16, max_pages_per_seq=4, prefix_caching=False,
            prefill_mode="bucketed", prefill_buckets=(32, 64), quantized_kv=False)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jtf.init_params(MCFG_J, jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def jax_engine(params_np):
    """The JAX engine; its ``_prefill[b]`` is jitted once a bucket, as JAX
    runs it."""
    return jeng.DecodeEngine(MCFG_J, jax.tree.map(jnp.asarray, params_np),
                             jeng.EngineConfig(**ECFG))


def _engine(params_np):
    return teng.DecodeEngine(TCFG, ttf.params_from_jax(TCFG, params_np, "cpu"),
                             teng.EngineConfig(**ECFG), device="cpu")


def test_bucketed_prefill_and_sampler_are_capture_safe(params_np, stub_op_kernels,
                                                       monkeypatch):
    eng = _engine(params_np)
    assert eng._bucket_prefill == eng._prefill_impl and eng._sample1 == eng._sample1_impl
    eng._upload(eng._in_prompt[32], np.arange(1, 33))
    eng._upload(eng._in_true_len, 20)
    eng._prefill_impl(eng._in_prompt[32], eng._in_true_len)       # fills the caches
    eng._set_sampling(1, teng.SamplingParams(temperature=0.7, top_k=5))
    eng._upload(eng._in_slot, [1])
    with no_host_data(monkeypatch), _OpLog() as log:
        logits, *kv = eng._prefill_impl(eng._in_prompt[32], eng._in_true_len)
        eng._in_logits1.copy_(logits[None])
        tok, = eng._sample1_impl(eng._in_logits1, eng._in_slot)
    assert logits.shape == (TCFG.vocab,) and len(kv) == 2 * TCFG.n_layers
    assert kv[0].shape == (TCFG.n_kv_heads, 32, TCFG.d_head)
    assert tok.shape == (1,) and 0 <= int(tok) < TCFG.vocab
    assert log.ops["aten.mm"] > 0 and log.ops["aten.sort"] > 0
    assert not FORBIDDEN & set(log.ops), sorted(FORBIDDEN & set(log.ops))


# ---- (c) the bucketed prefill on a device length ----

def test_bucketed_prefill_device_length_matches_jax(params_np, jax_engine):
    """One static prompt buffer and one 0-d length buffer, filled in place
    for two prompts of bucket 64 (one filling it), as the graph reads them:
    the last real token's logits and every layer's K/V of the real rows
    within the serving tolerance of the JAX ``_prefill_impl``."""
    eng = _engine(params_np)
    rng = np.random.default_rng(7)
    for n in (41, 64):
        prompt = [int(t) for t in rng.integers(1, 64, n)]
        toks = prompt + [0] * (64 - n)
        want, want_kv = jax_engine._prefill[64](jax_engine.params, jnp.asarray(toks, jnp.int32),
                                                n)
        eng._upload(eng._in_prompt[64], toks)
        eng._upload(eng._in_true_len, n)
        got, *kv = eng._bucket_prefill(eng._in_prompt[64], eng._in_true_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for i, (jk, jv) in enumerate(want_kv):
            np.testing.assert_allclose(kv[2 * i][:, :n].numpy(), np.asarray(jk)[:, :n],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(kv[2 * i + 1][:, :n].numpy(), np.asarray(jv)[:, :n],
                                       rtol=0, atol=1e-5)


# ---- (d) the card-side rules, reachable without CUDA ----

def test_non_capturable_optimizer_is_refused():
    params = ttf.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    plain = torch.optim.AdamW(params.parameters(), lr=1e-3)
    fused_only = torch.optim.SGD(params.parameters(), lr=1e-3)
    for opt in (plain, fused_only):
        with pytest.raises(ValueError, match="capturable=True"):
            graphs.check_capturable(opt)
    graphs.check_capturable(torch.optim.AdamW(params.parameters(), lr=1e-3, capturable=True))
    # the factories on a mesh of one CUDA device take the card's path: the
    # check runs before any CUDA call, so it raises here too
    card = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    with pytest.raises(ValueError, match="capturable=True"):
        ttf.make_sharded_train_step(TCFG, card, plain)
    staged = tpipe.stack_stage_params(TCFG, params, 2)
    pipe = make_mesh((1, 2), ("data", tpipe.AXIS_PIPE), ["cuda:0"] * 2)
    with pytest.raises(ValueError, match="capturable=True"):
        tpipe.make_pipeline_train_step(TCFG, pipe, torch.optim.AdamW(staged.parameters()), 2)


def test_captured_layouts():
    cuda = torch.device("cuda", 0)
    assert graphs.capture_devices(["cuda:0"] * 8) == (cuda,)
    assert graphs.capture_devices(make_mesh((1, 1), ("data", "model"),
                                            [cuda]).devices.flat) == (cuda,)
    # several cards: one graph over all of them, the first named first
    assert graphs.capture_devices(["cuda:1", "cuda:0", "cuda:1"]) == (
        torch.device("cuda", 1), cuda)
    assert graphs.capture_devices(["cpu"] * 4) is None
    assert graphs.capture_devices(["cpu", "cuda:0"]) is None


def test_factories_return_eager_functions_on_the_cpu():
    """On the CPU the step factories return plain functions with the
    caller's optimizer as it is (not capturable), and the attention
    callables are the eager ones."""
    params = ttf.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.AdamW(params.parameters(), lr=1e-3)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    step = ttf.make_sharded_train_step(TCFG, mesh, opt)
    assert not isinstance(step, graphs.GraphedTrainStep)
    tokens = torch.randint(0, 64, (2, 9), generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(step(params, tokens)) and opt.param_groups[0]["capturable"] is False
    ctx = make_mesh((1, 1, 2), ("data", "model", "context"), ["cpu"] * 2)
    for fn in (ring_flash_attention(ctx), ulysses_flash_attention(ctx, CausalRule()),
               sharded_flash_attention(mesh, CausalRule())):
        assert not isinstance(fn, graphs.GraphedFunction)
