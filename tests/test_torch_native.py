"""The port's host runtime (its copy of ``csrc/fa_native.cc``, built with
the host C++ compiler, and the bindings in ``native.py``) against the JAX
package's NumPy specs, on the CPU: the tile classes exactly, the FLOPs
estimate at rel 1e-12, the scheduler's decisions exactly."""

import numpy as np
import pytest

from tf_flash_attention_tpu import flops as jflops
from tf_flash_attention_tpu import mask_rules as jrules
from tf_flash_attention_tpu import schedule as jsched
from tf_flash_attention_tpu import sync_modes as jsync
from tf_flash_attention_tpu.serving.scheduler import Request, Scheduler
from tf_flash_attention_tpu_torch import mask_rules as trules
from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch import schedule as tsched
from tf_flash_attention_tpu_torch import sync_modes as tsync

# tests/test_native.py's grid
RULES = [
    ("full", {}),
    ("causal", {}),
    ("local", dict(window_size=7)),
    ("local", dict(window_size=5, log2_stride_size=2)),
    ("local", dict(window_size=7, is_causal=True)),
    ("local", dict(window_size=3, log2_stride_size=1, is_causal=True)),
]
SHAPES = {"1d": ((220,), (310,)), "2d": ((10, 22), (20, 11))}


@pytest.mark.parametrize("mode", tsync.SYNC_MODES)
@pytest.mark.parametrize("rule", RULES, ids=lambda r: f"{r[0]}{sorted(r[1].values())}")
@pytest.mark.parametrize("shapes", SHAPES, ids=list(SHAPES))
def test_tile_classes_equal_the_jax_spec(mode, rule, shapes):
    kind, kw = rule
    q_seq, k_seq = SHAPES[shapes]
    got = native.native_tile_classes(tsync.make_sync_pack(mode, q_seq, k_seq),
                                     trules.make_rule(kind, **kw), 16, 16)
    assert got is not None
    want = jsched._tile_classes_python(jsync.make_sync_pack(mode, q_seq, k_seq),
                                       jrules.make_rule(kind, **kw), 16, 16)
    for g, w, name in zip(got, want, ("live", "partial")):
        assert g.dtype == bool
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_flops_estimate_equals_the_jax_packages():
    pack = tsync.make_sync_pack("none_front", (300,), (500,))
    sched = tsched.build_schedule(pack, trules.CausalRule(), 128, 128)
    got = native.native_estimate_forward_flops(sched.live, 300, 500, 128, 128, 32, 16, 4)
    want = jflops.estimate_forward_flops(jrules.CausalRule(), "none_front", (300,), (500,),
                                         32, 16, 4, block_q=128, block_kv=128)
    assert got == pytest.approx(want, rel=1e-12)


def _admitted(py):
    return [(r.rid, s) for r, s in py.admit()]


def test_scheduler_decides_as_the_jax_spec():
    """tests/test_native.py's admission and release sequence."""
    py = Scheduler(max_seqs=3, n_pages=10, page_size=64)
    nat = native.NativeScheduler(max_seqs=3, n_pages=10, page_size=64)
    reqs = [(0, 100, 28), (1, 64, 0), (2, 600, 40), (3, 10, 10)]
    for rid, plen, mnew in reqs:
        py.enqueue(Request(rid, plen, mnew))
        nat.enqueue(rid, plen, mnew)
    first = _admitted(py)
    assert first == nat.admit() != []
    assert py.queued == nat.queued
    lengths = {rid: plen + mnew for rid, plen, mnew in reqs}
    for rid, slot in first:
        pages = -(-lengths[rid] // 64)
        py.release(slot, pages)
        nat.release(slot, pages)
    assert _admitted(py) == nat.admit()
    assert py.queued == nat.queued


def test_scheduler_refund_and_pages_cap_decide_as_the_jax_spec():
    """A refund (a window model's eviction) unblocks admission alike, and a
    capped request reserves only its cap."""
    py = Scheduler(max_seqs=2, n_pages=4, page_size=64)
    nat = native.NativeScheduler(max_seqs=2, n_pages=4, page_size=64)
    for rid, plen, mnew in ((0, 128, 64), (1, 64, 64)):   # 3 + 2 pages
        py.enqueue(Request(rid, plen, mnew))
        nat.enqueue(rid, plen, mnew)
    assert _admitted(py) == nat.admit() != []
    assert py.admit() == [] and nat.admit() == []         # rid 1 needs 2, 1 left
    py.refund(1)
    nat.refund(1)
    assert _admitted(py) == nat.admit() != []

    py = Scheduler(max_seqs=3, n_pages=4, page_size=64)
    nat = native.NativeScheduler(max_seqs=3, n_pages=4, page_size=64)
    for rid, plen, mnew, cap in ((0, 640, 64, 2), (1, 64, 64, -1), (2, 64, 0, -1)):
        py.enqueue(Request(rid, plen, mnew, pages_cap=cap))
        nat.enqueue(rid, plen, mnew, pages_cap=cap)
    assert _admitted(py) == nat.admit() == [(0, 0), (1, 1)]
    assert py.queued == nat.queued == 1


class _EveryOther(trules.MaskRule):
    def check(self, pack, q_coords, k_coords, q_flat, k_flat):
        return (q_flat + k_flat) % 2 == 0

    def tile_live(self, pack, *bounds):
        return True

    def tile_fully_visible(self, pack, *bounds):
        return False


def test_custom_rule_has_no_native_kind():
    """A custom rule has no C++ kind: the classifier gives None and the
    schedule (as ``native.custom_mask`` builds it) is the NumPy spec's."""
    pack = tsync.make_sync_pack("none_front", (200,), (200,))
    assert native.native_tile_classes(pack, _EveryOther(), 64, 64) is None
    got = tsched.build_schedule(pack, _EveryOther(), 64, 64)
    want = tsched.build_schedule(pack, _EveryOther(), 64, 64, use_native=False)
    for field in ("kv_table", "kv_counts", "needs_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    index, _ = native.custom_mask(pack, _EveryOther())
    assert index.shape == (4, 4)


def test_fa_no_native_turns_the_runtime_off(monkeypatch):
    monkeypatch.setenv("FA_NO_NATIVE", "1")
    pack = tsync.make_sync_pack("none_front", (200,), (200,))
    assert native.get_lib() is None
    assert native.native_tile_classes(pack, trules.CausalRule(), 64, 64) is None
    assert native.native_estimate_forward_flops(np.ones((2, 2), bool), 2, 2, 1, 1, 1, 1, 1) is None
    with pytest.raises(RuntimeError, match="FA_NO_NATIVE"):
        native.NativeScheduler(1, 1, 1)
    # the NumPy spec still schedules
    assert tsched.build_schedule(pack, trules.CausalRule(), 64, 64).live.shape == (4, 4)


def test_failed_host_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's message,
    and leaves no library or temporary file behind."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / native.HOST_SOURCE).write_text("extern \"C\" int fa_broken( {\n")
    monkeypatch.setattr(native, "_CSRC", csrc)
    monkeypatch.setattr(native, "_BUILD_DIR", build)
    monkeypatch.setattr(native, "_host_lib", None)
    with pytest.raises(RuntimeError, match="host build failed"):
        native.get_lib()
    assert list(build.iterdir()) == []
    assert native._host_lib is None


def test_host_library_is_built_under_build_with_its_hash():
    path = native._host_lib_path()
    assert native.get_lib() is not None and path.exists()
    assert path.parent == native._BUILD_DIR and path.name.startswith("libfa_native_")
