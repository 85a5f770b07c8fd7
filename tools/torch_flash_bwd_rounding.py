#!/usr/bin/env python3
"""Which operand roundings the bf16 flash backward (dq, dk/dv on the tensor
cores) can afford, emulated on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_flash_bwd_rounding.py [--heads 2]

At ``chip_smoke.py``'s ``TRAIN_SHAPES`` (head_dim 128, causal), cut to
``--heads`` query heads (the 70B and ragged shapes keep one kv head and
their GQA ratio), with inputs from ``--seed`` rounded to bf16, a spread q
and a peaked one (``PEAKED_Q`` times it): lse from the plain forward in
f32, delta from its output rounded to bf16 (the kernel's output), then
``tests/torch_numerics.flash_bwd_emulated`` under each rounding scheme
against autograd of the dense f32 reference, as chip_smoke holds the card.
Prints one JSON line per shape, case and scheme with dq's and dk/dv's
max |a - b| / max |b| beside ``GRAD_TOL[bf16]``. CPU arithmetic only: no
device number comes from it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from torch_numerics import (BWD_SCHEMES, flash_bwd_emulated,  # noqa: E402
                            rel_to_max)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seed", type=int, default=cs.SEED + 3)
    args = ap.parse_args()
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator().manual_seed(args.seed)
    d = cs.HEAD_DIM
    scale = 1.0 / math.sqrt(d)
    for case, _, s, h, hkv in cs.TRAIN_SHAPES:
        rep = h // hkv
        h = max(args.heads, rep) if rep > 1 else args.heads
        hkv = h // rep

        def rnd(rows):
            return torch.randn((rows, s, d), generator=gen).to(
                torch.bfloat16).float()

        q0, k, v, do = rnd(h), rnd(hkv), rnd(hkv), rnd(h)
        for qcase, q in (("spread", q0),
                         ("peaked", (q0 * cs.PEAKED_Q).to(
                             torch.bfloat16).float())):
            kw = dict(causal=True, n_heads=h, n_kv_heads=hkv)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = fa.flash_attention_ref(*leaves, **kw)
            want = torch.autograd.grad(ref, leaves, do)
            out, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
            delta = (out.to(torch.bfloat16).float() * do).sum(-1)
            for scheme in BWD_SCHEMES:
                dq, dk, dv = flash_bwd_emulated(q, k, v, do, lse, delta, True,
                                                h, hkv, scale, scheme)
                print(json.dumps(dict(
                    shape=case, S=s, H=h, Hkv=hkv, q=qcase, scheme=scheme,
                    dq_rel=rel_to_max(dq, want[0]),
                    dkv_rel=max(rel_to_max(dk, want[1]),
                                rel_to_max(dv, want[2])),
                    grad_tol=cs.GRAD_TOL[torch.bfloat16])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
