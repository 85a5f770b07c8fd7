#!/usr/bin/env python3
"""How the bf16 flash backward times on the CUDA card, and how its dk/dv
kernel times against the number of parts its walk is split into.

    python3 tools/torch_flash_bwd_splits.py [--splits 1 2 3 4 8]

At ``chip_smoke.py``'s training attention shapes (``TRAIN_SHAPES``, causal)
and its packs (``VARLEN_PACKS``, segment ids), bf16, random inputs from
``--seed``: the dq kernel once, then for each split count the dk/dv kernel
with that count forced in place of the wrapper's rule
(``flash_attention.dkv_splits``), each held to the rule's own result
(chip_smoke's bf16 GRAD_TOL). Prints one JSON line per shape with the mean
device times (CUDA events over back-to-back calls) beside the count the
rule picks, then the card's name and power limit. Exits non-zero without a
CUDA card.
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
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from torch_trace import card  # noqa: E402  (this script's folder)


def shapes(gen, dev):
    """(case, q, k, v, do, kwargs) at chip_smoke's training shapes."""
    d, dt = cs.HEAD_DIM, torch.bfloat16
    for case, b, s, h, hkv in cs.TRAIN_SHAPES:
        q, do = (cs._rand(gen, (b * h, s, d), dt, dev) for _ in range(2))
        k, v = (cs._rand(gen, (b * hkv, s, d), dt, dev) for _ in range(2))
        yield case, q, k, v, do, dict(causal=True, n_heads=h, n_kv_heads=hkv)
    for case, lens, h, hkv in cs.VARLEN_PACKS:
        t = sum(lens)
        q, do = (cs._rand(gen, (h, t, d), dt, dev) for _ in range(2))
        k, v = (cs._rand(gen, (hkv, t, d), dt, dev) for _ in range(2))
        ids = cs.pack_ids(lens, dev)
        yield case, q, k, v, do, dict(causal=True, n_heads=h, n_kv_heads=hkv,
                                      seg_q=ids.repeat(h, 1),
                                      seg_kv=ids.repeat(hkv, 1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3, 4, 8])
    ap.add_argument("--seed", type=int, default=cs.SEED + 21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rule = fa.dkv_splits
    tol = cs.GRAD_TOL[torch.bfloat16]
    for case, q, k, v, do, kw in shapes(gen, dev):
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        bwd = (q, k, v, do, lse, (out.float() * do.float()).sum(-1))
        rep = kw["n_heads"] // kw["n_kv_heads"]
        row = dict(case=case, rule=rule(
            q.dtype, k.shape[0], k.shape[1],
            rep * -(-q.shape[1] // fa.SEG_TILE), dev))
        row["dq_ms"] = cs.time_ms(lambda: fa.flash_attention_bwd_dq(*bwd, **kw))
        want = fa.flash_attention_bwd_dkv(*bwd, **kw)
        dkv_ms = {}
        try:
            for n in args.splits:
                fa.dkv_splits = lambda *a, n=n: n
                got = fa.flash_attention_bwd_dkv(*bwd, **kw)
                err = max(cs.rel_err(a, b) for a, b in zip(got, want))
                cs.require(err <= tol, f"{case}, {n} parts: off by {err}")
                dkv_ms[n] = cs.time_ms(
                    lambda: fa.flash_attention_bwd_dkv(*bwd, **kw))
        finally:
            fa.dkv_splits = rule
        row["dkv_ms"] = dkv_ms
        print(json.dumps(row), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
