#!/usr/bin/env python3
"""How the bf16 prefill and chunk attention kernels time against the
number of parts their kv walk is split into, on the CUDA card.

    python3 tools/torch_prefill_splits.py [--splits 1 2 4 8]

At ``chip_smoke.py``'s kernel shapes (Llama-2-7B heads, bf16, random
inputs from ``--seed``): ``paged_chunk_attention`` for a 256-token chunk
from start 3328 and a 100-token chunk from 3840 against the 4096-token
table, native and int8 pools, and ``flash_prefill`` at S = 77 and 256.
For each split count it forces that count in place of the wrappers' rule
(``decode_attention.prefill_splits``), checks the output against the
plain version (chip_smoke's bf16 OUT_TOL), and prints one JSON line with
the kernel's mean device time (CUDA events over back-to-back calls) beside
the count the rule picks. Then the card's name and power limit. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import decode_attention as da  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from torch_trace import card  # noqa: E402  (this script's folder)


def force(nsplit):
    """Make both wrappers use ``nsplit`` parts (None: their rule)."""
    rule = force.rule
    fn = rule if nsplit is None else (lambda dtype, *a: nsplit)
    da.prefill_splits = pa.prefill_splits = fn


force.rule = da.prefill_splits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefill_splits: no CUDA card", file=sys.stderr)
        return 1
    dev, dtype = torch.device("cuda"), torch.bfloat16
    atol, rtol = cs.OUT_TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bt, num_pages = cs._block_tables([cs.LONG_MAX_SEQ], 0, dev,
                                     cs.LONG_MAX_SEQ)
    shape = (cs.KV_HEADS, num_pages, cs.PAGE, cs.HEAD_DIM)
    cases = []
    for start, s in cs.CHUNK_SHAPES:
        kp, vp = (cs._rand(gen, shape, dtype, dev) for _ in range(2))
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        q = cs._rand(gen, (1, s, cs.HEADS, cs.HEAD_DIM), dtype, dev)
        rule = force.rule(dtype, cs.HEADS, s, bt.shape[1] * cs.PAGE, dev)
        for pool, pools in (("native", (kp, vp)),
                            ("int8", (cs.quantized(kp), cs.quantized(vp)))):
            cases.append((dict(kernel="paged_chunk_attention", pool=pool,
                               start=start, S=s, rule=rule),
                          lambda q=q, p=pools, st=st:
                          pa.paged_chunk_attention(q, *p, bt, st),
                          lambda q=q, p=pools, st=st:
                          pa.paged_chunk_attention_ref(q, *p, bt, st)))
    for s in cs.PREFILL_LENS:
        q, k, v = (cs._rand(gen, (1, s, cs.HEADS, cs.HEAD_DIM), dtype, dev)
                   for _ in range(3))
        rule = force.rule(dtype, cs.HEADS, s, s, dev)
        cases.append((dict(kernel="flash_prefill", S=s, rule=rule),
                      lambda q=q, k=k, v=v, s=s: da.flash_prefill(q, k, v, s),
                      lambda q=q, k=k, v=v, s=s:
                      da.flash_prefill_ref(q, k, v, s)))
    for info, kernel, plain in cases:
        want = plain()
        for nsplit in args.splits:
            force(nsplit)
            over = cs.excess(kernel(), want, rtol)
            cs.require(over <= atol, f"{info} splits={nsplit}: {over}")
            print(json.dumps(dict(info, splits=nsplit, excess=over,
                                  kernel_ms=cs.time_ms(kernel, iters=50))),
                  flush=True)
        force(None)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
