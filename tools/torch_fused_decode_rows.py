#!/usr/bin/env python3
"""The fused decode kernels' rows of ``chip_smoke.py`` alone, on the CUDA
card, for this checkout's port or another's.

    python3 tools/torch_fused_decode_rows.py [--package-root DIR]
        [--dtype bf16 fp32]

Runs ``chip_smoke.check_fused_block_decode`` and
``check_fused_multi_block_decode`` (the one-layer and N-layer decode at
serve's and serve_long's decode contexts, Llama-2-7B layers, native and
int8 pools, native and int4 weights: each held to its plain version,
timed beside its bound) and prints each row as one JSON line, then the
card's name and power limit. ``chip_smoke.py`` is this checkout's; the
``paddle_tpu_torch`` package (and its kernel build) comes from
``--package-root`` when given, so one call can time a parent commit
unpacked elsewhere with the same rows as this one. Exits non-zero without
a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

from torch_trace import card  # this script's folder

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=ROOT)
    ap.add_argument("--dtype", nargs="+", default=["bf16"],
                    choices=sorted(DTYPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_decode_rows: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.package_root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    for name in args.dtype:
        rows = []
        for check in (cs.check_fused_block_decode,
                      cs.check_fused_multi_block_decode):
            check(DTYPES[name], device, rows)
        for row in rows:
            print(json.dumps(row), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
