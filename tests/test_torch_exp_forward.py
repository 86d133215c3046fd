"""The experiment tools' forward kernels, ported, against the tools on the CPU.

``tools/exp_resident.py``, ``tools/exp_vpu_attrib.py`` and
``tools/exp_kv_unroll.py`` run their Pallas kernels in interpret mode at
S 512, B 2, d 128 (blocks cut with the sequence, the modules' sizes set by
``monkeypatch``).  The port's plain versions take the same numpy inputs;
its CUDA kernels are held against those plain versions on the card
(``chip_smoke.py`` phase 8, ``test_torch_cuda.py``).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tf_flash_attention_tpu_torch import native
from tf_flash_attention_tpu_torch.experiments import exp_kv_unroll as tunroll
from tf_flash_attention_tpu_torch.experiments._steps import forward_steps
from tf_flash_attention_tpu_torch.experiments import exp_resident as tres
from tf_flash_attention_tpu_torch.experiments import exp_vpu_attrib as tvpu
from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
B, S, D = 2, 512, 128

# Both sides take the same float32 steps and round p and o to bf16 at the
# same points; XLA's and PyTorch's float32 products sum in other orders,
# which moves a score by a float32 ulp and may flip the bf16 rounding of a p
# element (2**-8 relative) or of an output (one ulp).  Bound: two bf16 ulps
# at the output's scale (2 * 2**-8 of its largest magnitude).
ULPS = 2
# bf16exp (exp_resident and the ladder's rung): JAX lowers a bf16 exp2 to
# exp(bf16(0.69140625 * x)), ln 2 rounded to bf16, where the port takes
# exp2 of x rounded once; a weight that matters (x > -4) moves by up to
# 4 * (ln 2 - 0.69140625) + a bf16 rounding of the product, about 1%, and o
# by that share of the spread of v: four ulps at the output's scale
ULPS_BF16EXP = 4
# Against the dense float32 causal oracle, exp_resident's p is an exp2 of a
# bf16 input rounded to bf16 (up to 3 bf16 roundings of a p near s - m ~ -3,
# ~1% of a weight) and o is rounded once: the tool's own parity bound, 1e-2
ORACLE_ATOL = 1e-2
# the tool's (block_q, block_kv) pairs cut from S 4096 to S 512
PAIRS = tuple((bq // 8, bkv // 8) for bq, bkv in tres.PAIRS)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (B, S, D)).astype(np.float32) for _ in range(n)]


def _bf16(x):
    """numpy float32 rounded to bf16, as (JAX array, torch tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _close(got, want, ulps=ULPS):
    """Within ``ulps`` bf16 ulps at the scale of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=ulps * 2.0 ** -8 * np.abs(want).max(), rtol=0)


def _np(x):
    """A JAX array or a torch tensor as float32 numpy."""
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


# ---- exp_resident ----

@pytest.fixture(scope="module")
def resident_inputs():
    return [_bf16(x) for x in _inputs(0)]


@pytest.mark.parametrize("bq,bkv", [p for p in PAIRS if p[0] == p[1]])
def test_resident_matches_tool_where_the_tool_is_exact(interpret, resident_inputs, bq, bkv):
    """At block_q == block_kv the tool's mask (last sub-tile only) is exact."""
    (jq, tq), (jk, tk), (jv, tv) = resident_inputs
    want = _np(_load("exp_resident").resident_forward(jq, jk, jv, block_q=bq, block_kv=bkv))
    got = _np(tres.resident_forward(tq, tk, tv, block_q=bq, block_kv=bkv))
    _close(got, want, ULPS_BF16EXP)


@pytest.mark.parametrize("bq,bkv", PAIRS)
def test_resident_matches_dense_causal_oracle(resident_inputs, bq, bkv):
    (_, tq), (_, tk), (_, tv) = resident_inputs
    got = tres.resident_forward(tq, tk, tv, block_q=bq, block_kv=bkv).float()
    want = tres.causal_oracle(tq.float(), tk.float(), tv.float())
    assert float((got - want).abs().max()) < ORACLE_ATOL


def test_tool_resident_is_wrong_when_block_q_exceeds_block_kv(interpret, resident_inputs):
    """The reference's fault the port does not copy: at (128, 64) the tool
    runs the first sub-tile crossing the diagonal unmasked."""
    (jq, tq), (jk, tk), (jv, tv) = resident_inputs
    tool = _np(_load("exp_resident").resident_forward(jq, jk, jv, block_q=128, block_kv=64))
    oracle = tres.causal_oracle(tq.float(), tk.float(), tv.float()).numpy()
    assert np.abs(tool - oracle).max() > 0.1


@pytest.fixture(scope="module")
def stage_inputs():
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.uniform(-1, 1, (1, 2048, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("bq,bkv", tres.PAIRS)
def test_resident_stage_merge_within_card_gate(stage_inputs, bq, bkv):
    """The card's kernel (``csrc/exp_forward_kernels.cu``) walks a q block
    of ``block_q`` rows as 128-row tiles, one CTA an item, each tile merging
    every ``block_kv`` keys against that step's row maximum and skipping
    the steps past its own diagonal: the plain version at block_q 128 and
    the pair's block_kv.  That is the pair's plain version (the steps a
    q block walks past a row's diagonal change none of its sums), within
    the card comparison's bound (``ULPS`` bf16 ulps at the output's scale)
    at S 2048 for every pair of the tool."""
    q, k, v = stage_inputs
    tiles = forward_steps(tres._prescale(q, None), k, v, step=bkv, group=bkv, block_q=128,
                          causal=True, elem_mask=True, policy="bf16exp")
    want = tres.resident_forward_plain(q, k, v, block_q=bq, block_kv=bkv)
    _close(_np(tiles), _np(want))


# ---- exp_vpu_attrib: the ladder, block-causal at BQ = BK = S / 2 ----

@pytest.fixture(scope="module")
def ladder_inputs():
    q, k, v = _inputs(1)
    c = jnp.bfloat16(1.0 / np.sqrt(D) * LOG2E)
    jq = jnp.asarray(q, jnp.bfloat16) * c               # the tool's bf16 prescale
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16)
    return (jq, tq), _bf16(k), _bf16(v)


@pytest.mark.parametrize("rung", tvpu.RUNGS)
def test_ladder_rung_matches_tool(interpret, monkeypatch, ladder_inputs, rung):
    tool = _load("exp_vpu_attrib")
    for name, value in dict(B=B, S=S, D=D, BQ=S // 2, BK=S // 2).items():
        monkeypatch.setattr(tool, name, value)
    (jq, tq), (jk, tk), (jv, tv) = ladder_inputs
    want = _np(tool.build(rung)(jq, jk, jv))
    got = _np(tvpu.ladder(rung, tq, tk, tv, block_q=S // 2, block_kv=S // 2))
    assert np.isfinite(got).all()
    _close(got, want, ULPS_BF16EXP if rung == "bf16exp" else ULPS)


@pytest.mark.parametrize("block", [256, 512, 2048])
@pytest.mark.parametrize("rung", ["nomax", "mm"])
def test_ladder_stage_merge_within_card_gate(rung, block):
    """The card's ladder (``csrc/exp_forward_kernels.cu``) merges the rungs
    that take no maximum every 128-key stage, where the tool merges each
    block_kv group at once: the plain version at group 128 against the
    rung's own, within the card comparison's bound (``ULPS`` bf16 ulps at
    the output's scale) at the card test's sizes, (2, 2 block, 128) with
    block_q = block_kv = block."""
    rng = np.random.default_rng(block)
    q, k, v = (torch.from_numpy(rng.uniform(-1, 1, (2, 2 * block, D)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    q = q * torch.tensor(0.1275, dtype=torch.bfloat16)
    stages = forward_steps(q, k, v, step=block, group=128, block_q=block, causal=True,
                           elem_mask=False, policy=rung)
    want = tvpu.ladder_plain(rung, q, k, v, block_q=block, block_kv=block)
    _close(_np(stages), _np(want))


def test_ladder_live_tiles():
    assert tvpu.live_tiles() == 3 and tvpu.live_tiles(512, 128, 128) == 10


# ---- exp_kv_unroll: full attention, nkv blocks a step ----

@pytest.fixture(scope="module")
def unroll_inputs():
    q, kv = _inputs(2, 2)
    return _bf16(q), _bf16(kv)


@pytest.mark.parametrize("name,nkv,fused", tunroll.VARIANTS)
def test_kv_unroll_matches_tool(interpret, monkeypatch, unroll_inputs, name, nkv, fused):
    tool = _load("exp_kv_unroll")
    for attr, value in dict(B=B, S=S, D=D, BQ=S // 4, BK=S // 4).items():
        monkeypatch.setattr(tool, attr, value)
    (jq, tq), (jkv, tkv) = unroll_inputs
    jkkv = jkv.reshape(B, 4, S // 4, D)        # K = V, blocked as the tool's
    want = _np(tool.build(nkv, fused)(jq, jkkv, jkkv))
    got = _np(tunroll.kv_unroll(tq, tkv, tkv, nkv=nkv, fused=fused, block_kv=S // 4))
    _close(got, want)


# ---- the card's bodies and build report ----

def test_experiment_forwards_run_the_tensor_core_body():
    assert native.EXP_FWD_BODY == {name: "tensor-core" for name in
                                   ("exp_resident_fwd", "exp_vpu_ladder", "exp_kv_unroll")}


def test_ptxas_summary_reads_registers_spills_and_serialization(monkeypatch):
    """``chip_smoke.py`` prints each experiment forward's registers and
    spills, and any kernel's serialized ``wgmma``, from nvcc's ``-Xptxas
    -v`` report of the build."""
    monkeypatch.setitem(native.BUILD_LOG, "x.cu", dict(seconds=1.0, ptxas="""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1ai' for 'sm_90a'
ptxas info    : Function properties for _Z1ai
    0 bytes stack frame, 56 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bi' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are \
serialized in the function '_Z1bi'
ptxas info    : Function properties for _Z1bi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 164 registers, used 1 barriers
"""))
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    a, b = native.ptxas_summary("x.cu")
    assert (a["name"], a["registers"], a["spill_stores"], a["spill_loads"], a["warnings"]) == (
        "_Z1ai", 168, 56, 96, [])
    assert (b["name"], b["registers"], b["spill_stores"]) == ("_Z1bi", 164, 0)
    assert len(b["warnings"]) == 1 and b["warnings"][0].startswith("(C7515)")


def test_ptxas_report_prints_the_matching_kernels(monkeypatch, capsys):
    """``utils/ptxas_report.py`` compiles the named sources of a tree (here
    a stand-in that records a ptxas report, since there is no nvcc) and
    prints one JSON line per kernel whose name contains a ``--match``
    string; without nvcc it exits non-zero and prints nothing."""
    import json

    from tf_flash_attention_tpu_torch.utils import ptxas_report

    ptxas = """\
ptxas info    : Compiling entry function '_Z13bwd_tc_kerneli' for 'sm_90a'
    0 bytes stack frame, 104 bytes spill stores, 176 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z8other_ki' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
"""
    seen = {}

    def fake_compile(csrc, outputs):
        seen.update(csrc=csrc, sources=sorted(outputs))
        for src in outputs:
            native.BUILD_LOG[src] = dict(seconds=1.0, ptxas=ptxas)

    monkeypatch.setattr(native, "BUILD_LOG", {})
    monkeypatch.setattr(native, "compile_sources", fake_compile)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    ptxas_report.main(["attention_kernels.cu", "band_kernels.cu", "--csrc", "/elsewhere",
                       "--match", "bwd_tc_kernel"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert seen["sources"] == ["attention_kernels.cu", "band_kernels.cu"]
    assert str(seen["csrc"]) == "/elsewhere"
    assert [(x["source"], x["name"], x["registers"], x["spill_stores"], x["spill_loads"])
            for x in lines] == [("attention_kernels.cu", "_Z13bwd_tc_kerneli", 168, 104, 176),
                                ("band_kernels.cu", "_Z13bwd_tc_kerneli", 168, 104, 176)]
    monkeypatch.undo()
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(SystemExit) as e:
        ptxas_report.main(["attention_kernels.cu"])
    assert "nvcc not found" in str(e.value.code) and capsys.readouterr().out == ""
