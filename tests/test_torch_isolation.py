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
                      if p.suffix in (".py", ".cu", ".cuh"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_engine_import_leaves_jax_out():
    code = ("import sys; import tf_flash_attention_tpu_torch.serving.engine; "
            "import tf_flash_attention_tpu_torch.native; "
            "import tf_flash_attention_tpu_torch.api; "
            "import tf_flash_attention_tpu_torch.flops; "
            "import tf_flash_attention_tpu_torch.models.transformer; "
            "import tf_flash_attention_tpu_torch.ops.reference; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('tf_flash_attention_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


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


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
