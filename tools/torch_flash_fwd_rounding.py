#!/usr/bin/env python3
"""Which rounding of the P·V operand the bf16 flash forward (#7 on the
tensor cores) can afford, emulated on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_flash_fwd_rounding.py [--heads 2]

At ``chip_smoke.py``'s ``TRAIN_SHAPES`` (head_dim 128, causal), cut to
``--heads`` query heads (the 70B and ragged shapes keep one kv head and
their GQA ratio), with inputs from ``--seed`` rounded to bf16, a spread q
and a peaked one (``PEAKED_Q`` times it): ``tests/torch_numerics.
flash_fwd_emulated`` under each scheme, its output rounded to bf16, against
the plain forward (f32 arithmetic, output rounded to bf16), as chip_smoke
holds the card: the out's excess over ``OUT_TOL[bf16]``'s rtol (held to
its atol) and the lse's max error (held to ``LSE_TOL[bf16]``). Prints one
JSON line per shape, case and scheme. CPU arithmetic only: no device
number comes from it.
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
from torch_numerics import (FWD_SCHEMES, flash_fwd_emulated,  # noqa: E402
                            out_excess)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seed", type=int, default=cs.SEED + 3)
    args = ap.parse_args()
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator().manual_seed(args.seed)
    d, bf16 = cs.HEAD_DIM, torch.bfloat16
    atol, rtol = cs.OUT_TOL[bf16]
    scale = 1.0 / math.sqrt(d)
    for case, _, s, h, hkv in cs.TRAIN_SHAPES:
        rep = h // hkv
        h = max(args.heads, rep) if rep > 1 else args.heads
        hkv = h // rep

        def rnd(rows):
            return torch.randn((rows, s, d), generator=gen).to(bf16).float()

        q0, k, v = rnd(h), rnd(hkv), rnd(hkv)
        for qcase, q in (("spread", q0),
                         ("peaked", (q0 * cs.PEAKED_Q).to(bf16).float())):
            kw = dict(causal=True, n_heads=h, n_kv_heads=hkv)
            want, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
            want = want.to(bf16).float()
            for scheme in FWD_SCHEMES:
                out, lse = flash_fwd_emulated(q, k, v, True, h, hkv, scale,
                                              scheme)
                print(json.dumps(dict(
                    shape=case, S=s, H=h, Hkv=hkv, q=qcase, scheme=scheme,
                    out_excess=out_excess(out.to(bf16).float(), want, rtol),
                    out_atol=atol,
                    lse_max_err=float((lse - want_lse).abs().max()),
                    lse_tol=cs.LSE_TOL[bf16])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
