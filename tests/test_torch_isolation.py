"""The port stands apart from JAX: it imports no jax, reaches no library
kernel, and its chip smoke test refuses to run without a GPU."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tf_flash_attention_tpu_torch"
PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*")
                      if p.suffix in (".py", ".cu", ".cuh", ".cc"))
EXAMPLES = sorted(str(p) for p in (REPO / "examples").glob("torch_*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_engine_import_leaves_jax_out():
    code = ("import sys; import tf_flash_attention_tpu_torch.serving.engine; "
            "import tf_flash_attention_tpu_torch.native; "
            "import tf_flash_attention_tpu_torch.parallel; "
            "import tf_flash_attention_tpu_torch.serving.seq_sharded_decode; "
            "import tf_flash_attention_tpu_torch.serving.sharded_decode; "
            "import tf_flash_attention_tpu_torch.ops.chunked; "
            "import tf_flash_attention_tpu_torch.testing; "
            "import tf_flash_attention_tpu_torch.api; "
            "import tf_flash_attention_tpu_torch.flops; "
            "import tf_flash_attention_tpu_torch.models.transformer; "
            "import tf_flash_attention_tpu_torch.models.moe; "
            "import tf_flash_attention_tpu_torch.models.pipeline; "
            "import tf_flash_attention_tpu_torch.ops.quant; "
            "import tf_flash_attention_tpu_torch.ops.reference; "
            "import tf_flash_attention_tpu_torch.utils.profiling; "
            "import tf_flash_attention_tpu_torch.experiments.exp_decode; "
            "import tf_flash_attention_tpu_torch.experiments.exp_int4_unpack; "
            "import tf_flash_attention_tpu_torch.experiments.exp_resident; "
            "import tf_flash_attention_tpu_torch.experiments.exp_kv_unroll; "
            "import tf_flash_attention_tpu_torch.experiments.exp_vpu_attrib; "
            "import tf_flash_attention_tpu_torch.utils.checkpoint; "
            "import tf_flash_attention_tpu_torch.graft_entry; "
            "import importlib.util; "
            f"paths = {EXAMPLES!r}; "
            "specs = [importlib.util.spec_from_file_location(f'ex{i}', p) "
            "for i, p in enumerate(paths)]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in specs]; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('tf_flash_attention_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_builds_its_own_host_runtime():
    """The port's schedules go through the library it builds from its own
    copy of csrc/fa_native.cc, never the JAX package's committed one."""
    code = ("from tf_flash_attention_tpu_torch import native, schedule, sync_modes, mask_rules; "
            "pack = sync_modes.make_sync_pack('none_front', (300,), (300,)); "
            "schedule.build_schedule(pack, mask_rules.CausalRule(), 128, 128); "
            "print(native.get_lib()._name); "
            "print([l.split()[-1] for l in open('/proc/self/maps') if 'fa_native' in l][0])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120, check=True)
    lib, mapped = out.stdout.split()
    assert pathlib.Path(lib).parent == REPO / "build" / "torch_kernels", lib
    assert mapped == lib and "tf_flash_attention_tpu/csrc" not in out.stdout


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_source_uses_no_jax_and_no_library_kernel(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M), path
    for banned in ("scaled_dot_product_attention", "torch.compile", "cudnn",
                   "flash_attn", "--use_fast_math\""):
        assert banned not in text, (path, banned)


def _run_smoke(cwd):
    env = _env()
    env.pop("PYTHONPATH")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("tool", ["exp_decode", "exp_int4_unpack", "exp_resident",
                                  "exp_kv_unroll", "exp_vpu_attrib"])
def test_experiment_main_fails_without_a_gpu(tool):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", f"tf_flash_attention_tpu_torch.experiments.{tool}"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr


def test_graft_entry_main_fails_without_a_gpu():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "tf_flash_attention_tpu_torch.graft_entry"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
