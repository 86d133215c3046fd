"""Host-side pieces of the port against the JAX package: the carried copies
of mask_rules/sync_modes, the scheduler, the prefix cache and sampling."""

import ast
import dataclasses
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_flash_attention_tpu.flops as jflops
import tf_flash_attention_tpu.mask_rules as jrules
import tf_flash_attention_tpu.schedule as jsched
import tf_flash_attention_tpu.sync_modes as jsync
import tf_flash_attention_tpu_torch.flops as tflops
import tf_flash_attention_tpu_torch.mask_rules as trules
import tf_flash_attention_tpu_torch.schedule as tsched
import tf_flash_attention_tpu_torch.sync_modes as tsync
from tf_flash_attention_tpu.serving import prefix_cache as jpc
from tf_flash_attention_tpu.serving import sampling as jsamp
from tf_flash_attention_tpu.serving import scheduler as jsch
from tf_flash_attention_tpu_torch.serving import prefix_cache as tpc
from tf_flash_attention_tpu_torch.serving import sampling as tsamp
from tf_flash_attention_tpu_torch.serving import scheduler as tsch


def _code_without_docstring(module):
    tree = ast.parse(inspect.getsource(module))
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return [ast.dump(node) for node in body]


# the port carries copies (importing the JAX package would import jax);
# everything but the module docstring must stay identical
@pytest.mark.parametrize("pair", [(jrules, trules), (jsync, tsync), (jsched, tsched),
                                  (jflops, tflops)],
                         ids=["mask_rules", "sync_modes", "schedule", "flops"])
def test_carried_copies_equal_the_originals(pair):
    assert _code_without_docstring(pair[0]) == _code_without_docstring(pair[1])


def test_carried_host_runtime_source_is_byte_identical():
    """The port builds its own copy of the C++ host runtime."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    original = repo / "tf_flash_attention_tpu" / "csrc" / "fa_native.cc"
    assert (repo / "tf_flash_attention_tpu_torch" / "csrc" / "fa_native.cc").read_bytes() \
        == original.read_bytes()


def _port_rule(rule):
    if isinstance(rule, jrules.LocalRule):
        return trules.LocalRule(rule.window_size, rule.log2_stride_size, rule.is_causal)
    return trules.CausalRule() if isinstance(rule, jrules.CausalRule) else trules.FullRule()


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("seq_dims", [1, 2], ids=["1d", "2d"])
def test_schedules_equal_the_jax_packages(seq_dims, use_native):
    """The port's schedules, from the NumPy classifier (the spec,
    use_native=False) and from its C++ host classifier (the default, as the
    op path builds them), must equal the JAX package's default build for
    the whole case matrix of tests/test_kernels.py, transposed too."""
    from test_kernels import ATTENTION_CASES, CASE_MATRIX, SHAPES_1D, SHAPES_2D
    shapes = SHAPES_1D if seq_dims == 1 else SHAPES_2D
    for case, mode in CASE_MATRIX:
        rule = ATTENTION_CASES[case]
        jp = jsync.make_sync_pack(mode, shapes["q_seq"], shapes["k_seq"])
        tp = tsync.make_sync_pack(mode, shapes["q_seq"], shapes["k_seq"])
        want = jsched.build_schedule(jp, rule, 128, 128)
        got = tsched.build_schedule(tp, _port_rule(rule), 128, 128, use_native=use_native)
        for a, b in ((want, got), (want.transpose(), got.transpose())):
            for field in ("kv_table", "kv_counts", "needs_mask"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                              err_msg=f"{case} {mode} {field}")


def test_carried_flops_price_like_the_jax_package():
    """flops.py calls build_schedule with use_native left True: the port's
    C++ host classifier prices it, as the JAX package's does."""
    want = jflops.matmul_flops_forward(jrules.CausalRule(), "none_front", (2048,), (2048,),
                                       128, 128, 64)
    got = tflops.matmul_flops_forward(trules.CausalRule(), "none_front", (2048,), (2048,),
                                      128, 128, 64)
    assert got == want == 2.0 * 128 * 128 * 256 * 136 * 64


def test_carried_rules_behave_alike():
    rng = np.random.default_rng(0)
    qf, kf = rng.integers(0, 64, (16, 1)), rng.integers(0, 64, (1, 16))
    for kind, kw in (("full", {}), ("causal", {}),
                     ("local", dict(window_size=4, log2_stride_size=1, is_causal=True))):
        jr, tr = jrules.make_rule(kind, **kw), trules.make_rule(kind, **kw)
        pack_j = jsync.make_sync_pack("scale_end", (64,), (32,))
        pack_t = tsync.make_sync_pack("scale_end", (64,), (32,))
        assert dataclasses.asdict(pack_j) == dataclasses.asdict(pack_t)
        np.testing.assert_array_equal(jr.check(pack_j, [qf], [kf], qf, kf),
                                      tr.check(pack_t, [qf], [kf], qf, kf))


def test_scheduler_same_decisions():
    js, ts = jsch.Scheduler(3, 10, 16), tsch.Scheduler(3, 10, 16)
    reqs = [(0, 20, 8), (1, 50, 30), (2, 5, 5), (3, 60, 60), (4, 1, 1)]
    for rid, n, m in reqs:
        js.enqueue(jsch.Request(rid, n, m))
        ts.enqueue(tsch.Request(rid, n, m))

    def admitted(s):
        return [(r.rid, slot) for r, slot in s.admit()]

    assert admitted(js) == admitted(ts)
    js.release(0, 2), ts.release(0, 2)
    js.release(2, 1), ts.release(2, 1)
    assert admitted(js) == admitted(ts)
    assert js.queued == ts.queued


def test_prefix_cache_same_hashes_and_pages():
    ja, ta = jpc.SharedPageAllocator(12), tpc.SharedPageAllocator(12)
    jc, tc = jpc.PrefixCache(4), tpc.PrefixCache(4)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    assert list(jc._chain(prompt, 2)) == list(tc._chain(prompt, 2))
    for alloc, cache in ((ja, jc), (ta, tc)):
        pages = alloc.alloc(0, 3)
        cache.insert(prompt, pages, alloc)
    assert jc.lookup(prompt + [7], 11) == tc.lookup(prompt + [7], 11)
    assert jc.lookup([0] * 9) == tc.lookup([0] * 9)
    for alloc in (ja, ta):
        alloc.free(0)
    assert ja.free_pages == ta.free_pages
    assert jc.evict(ja, 12) == tc.evict(ta, 12)
    assert (jc.hits, jc.misses, len(jc)) == (tc.hits, tc.misses, len(tc))
    assert ja.free_pages == ta.free_pages == 12


def test_sample_tokens_greedy_identical():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 64)).astype(np.float32)
    zeros = np.zeros(5, np.float32)
    want = jsamp.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros),
                               jnp.zeros(5, jnp.int32), jnp.ones(5))
    got = tsamp.sample_tokens(torch.from_numpy(logits), None, torch.from_numpy(zeros),
                              torch.zeros(5, dtype=torch.int32), torch.ones(5))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sample_tokens_same_keep_sets(monkeypatch):
    """Both samplers fed the same Gumbel noise pick the same token, so their
    top-k/top-p keep sets agree (a token outside either set never wins)."""
    rng = np.random.default_rng(2)
    S, vocab = 4, 64
    logits = rng.normal(size=(S, vocab)).astype(np.float32) * 2
    temps = np.array([0.7, 1.0, 1.5, 0.0], np.float32)
    top_ks = np.array([5, 0, 12, 0], np.int32)
    top_ps = np.array([1.0, 0.6, 0.9, 1.0], np.float32)
    for trial in range(8):
        noise = rng.gumbel(size=vocab).astype(np.float32) * 3
        monkeypatch.setattr(jax.random, "categorical",
                            lambda key, lg: jnp.argmax(lg + jnp.asarray(noise)))
        monkeypatch.setattr(tsamp, "_gumbel",
                            lambda shape, gen, dev: torch.from_numpy(noise).expand(shape))
        want = jsamp.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(trial),
                                   jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
        got = tsamp.sample_tokens(torch.from_numpy(logits), None, torch.from_numpy(temps),
                                  torch.from_numpy(top_ks), torch.from_numpy(top_ps))
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=f"trial {trial}")


def test_sampling_params_validation():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0)):
        with pytest.raises(ValueError):
            tsamp.SamplingParams(**bad)
