"""No module a run loads has the top-level name of JAX or of the JAX
package, and the reference loads nothing of the port.  Each check runs in
a fresh interpreter."""

import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "tf_flash_attention_tpu")

ENTRY = f"""
import sys, runpy, importlib.util, pathlib
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH_DIR)!r}]
import run
from benchlib import bench, check, program, serve, counts, devtrace, traffic, weights, arith
root = pathlib.Path({str(ROOT)!r})
for p in sorted((root / "bench_port/metrics").glob("*.py")):
    bench.reader(root, p.stem)
bench.reference(root, {{"reference": "decoder"}})
program.model_config(bench.load_json(root / "bench_port/configs/mistral-7b-v0.1.json"))
import tf_flash_attention_tpu_torch.serving.engine, tf_flash_attention_tpu_torch.models.transformer
print(sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}))
print(any(m.split(".")[0] == "tf_flash_attention_tpu_torch" for m in sys.modules))
"""

REFERENCE = f"""
import sys, importlib.util
spec = importlib.util.spec_from_file_location("ref", {str(BENCH_DIR / "references" / "decoder.py")!r})
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r} + ("tf_flash_attention_tpu_torch", "benchlib")))
"""


def fresh(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env={"PATH": "/usr/bin:/bin"}).stdout
    return out.strip().splitlines()


def test_the_run_loads_no_jax():
    forbidden, port = fresh(ENTRY)
    assert forbidden == "[]" and port == "True"


def test_the_reference_loads_nothing_of_the_port():
    assert fresh(REFERENCE) == ["[]"]


def test_the_names_compare_whole():
    from benchlib import bench
    sys.modules.setdefault("tf_flash_attention_tpu_torch", sys.modules[__name__])
    assert "tf_flash_attention_tpu_torch" not in bench.forbidden_modules()
