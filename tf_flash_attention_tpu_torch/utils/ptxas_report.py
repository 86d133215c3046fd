"""ptxas's report of the port's kernel sources, one JSON line a kernel.

    python -m tf_flash_attention_tpu_torch.utils.ptxas_report [SOURCE ...]
        [--csrc DIR] [--match NAME ...]

Compiles each SOURCE (default: every source ``native`` builds) with
``native.NVCC_FLAGS`` into a temporary directory, one nvcc process a
source, all at once (``native.compile_sources``), and prints each kernel
whose demangled name contains one of the ``--match`` strings (default:
every kernel): its source, registers, spill stores and loads in bytes and
ptxas's notes on serialized ``wgmma`` (``native.ptxas_summary``).
``--csrc`` compiles the sources of another tree (an unpacked earlier
commit's ``tf_flash_attention_tpu_torch/csrc``) with the same flags, so two
trees' registers and spills compare in one run on one toolkit.  Needs
nvcc; prints nothing and exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from .. import native


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=native._CSRC,
                    help="the directory of the sources (default: this tree's)")
    ap.add_argument("--match", nargs="*", default=[],
                    help="print only kernels whose name contains one of these")
    ap.add_argument("sources", nargs="*", default=list(native._SIGNATURES))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            native.compile_sources(args.csrc, {src: Path(tmp) / f"{src}.so"
                                               for src in args.sources})
        except RuntimeError as e:
            sys.exit(str(e))
    for src in args.sources:
        for k in native.ptxas_summary(src):
            if not args.match or any(m in k["name"] for m in args.match):
                print(json.dumps(dict(csrc=str(args.csrc), source=src, **k)), flush=True)


if __name__ == "__main__":
    main()
