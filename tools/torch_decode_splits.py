#!/usr/bin/env python3
"""How the split-KV decode attention (kernel #2, ``paged_attention``) times
against the size of the parts its walk is cut into, on the CUDA card.

    python3 tools/torch_decode_splits.py [--part-keys 64 128 256 512 1024 0]

At ``chip_smoke.py``'s decode shapes (``PAGED_SHAPES``: generate_paged's
last step, serve's ragged lengths with an idle row, serve_long's decode
contexts; Llama-2-7B heads,
pages of 64, bf16, random pools from ``--seed``), native and int8 pools:
for each part size (in keys; 0: the whole table in one part, no merge) it
forces that size in place of the wrapper's rule
(``paged_attention.decode_splits``), checks the output against the plain
version (chip_smoke's TOL / QUANT_OUT_TOL), and prints one JSON line with
the call's device time (``chip_smoke.graph_ms``: calls replayed from a
CUDA graph, so the host's enqueue cost is left out) beside the part size
the rule picks. Then the card's name and power limit. Exits non-zero
without a CUDA card.
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
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from torch_trace import card  # noqa: E402  (this script's folder)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part-keys", type=int, nargs="+",
                    default=[64, 128, 256, 512, 1024, 0])
    ap.add_argument("--seed", type=int, default=cs.SEED + 22)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_splits: no CUDA card", file=sys.stderr)
        return 1
    dev, dtype = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rule = pa.decode_splits
    for case, seq_lens, max_seq, null_page in cs.PAGED_SHAPES:
        bt, num_pages = (cs._block_tables(list(seq_lens), 0, dev, max_seq)
                         if null_page else
                         cs._rect_tables(len(seq_lens), max_seq, dev))
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
        shape = (cs.KV_HEADS, num_pages, cs.PAGE, cs.HEAD_DIM)
        kp, vp = (cs._rand(gen, shape, dtype, dev) for _ in range(2))
        q = cs._rand(gen, (cs.BATCH, cs.HEADS, cs.HEAD_DIM), dtype, dev)
        maxp = bt.shape[1]
        picked = rule(cs.BATCH * cs.KV_HEADS, maxp, cs.PAGE,
                      torch.cuda.get_device_properties(0).multi_processor_count)
        for pool, pools in (("native", (kp, vp)),
                            ("int8", (cs.quantized(kp), cs.quantized(vp)))):
            want = pa.paged_attention_ref(q, *pools, bt, sl)
            times = {}
            try:
                for keys in args.part_keys:
                    part = maxp if keys == 0 else max(1, keys // cs.PAGE)
                    pa.decode_splits = (lambda *a, p=part:
                                        (p, -(-maxp // p)))
                    got = pa.paged_attention(q, *pools, bt, sl)
                    if pool == "int8":
                        atol, rtol = cs.QUANT_OUT_TOL[dtype]
                        over = cs.excess(got, want, rtol)
                    else:
                        atol, over = cs.TOL[dtype], cs.max_err(got, want)
                    cs.require(over <= atol, f"{case} {pool} {keys} keys a "
                               f"part: {over}")
                    times[part * cs.PAGE] = cs.graph_ms(
                        lambda: pa.paged_attention(q, *pools, bt, sl))
            finally:
                pa.decode_splits = rule
            print(json.dumps(dict(
                case=case, pool=pool, seq_lens=list(seq_lens),
                table_keys=maxp * cs.PAGE,
                rule_part_keys=picked[0] * cs.PAGE,
                device_ms_by_part_keys=times)), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
