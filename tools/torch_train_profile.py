#!/usr/bin/env python3
"""Where a training step's device time goes on the CUDA card (the port).

    python3 tools/torch_train_profile.py [--layers 8] [--seq 4096]

Builds Llama-2-7B width at ``--layers`` layers (bf16, f32 masters, random
weights from ``--seed``) and the training path of ``chip_smoke.py``:
``TrainStep(grad_accum_steps=2)`` with AdamW, global-norm clip and a
warmup/cosine LR, on one fixed batch of 2 x ``--seq`` tokens. After two
warm-up steps and two untraced steps (their median is the untraced step
time), it traces one step with ``torch.profiler``, counting device events
only (kernels, copies, memsets; one stream, so they do not overlap), in
two windows:

  fwd_bwd  ``compute_loss_grads``: forward and backward of both
           micro-batches, split into the flash-attention kernels, cuBLAS
           GEMMs and everything else (norms, rotary, SwiGLU, embedding,
           the loss's softmax, casts);
  update   ``apply_update``: the global-norm clip, AdamW with f32 masters,
           the scheduler step, clearing the gradients.

Then one more window, ``loss``: ``fused_linear_cross_entropy`` forward
and backward alone on one micro-batch's hidden states (GEMMs included),
times the micro-batches of a step. Each window prints one JSON line with
its device ms by group and its largest kernels; a last ``step`` line gives
the traced wall time, the device time, the idle share against the
untraced step, and the card's name and power limit follow. Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from torch_trace import card, window  # noqa: E402  (this script's folder)

FLASH = ("fa_fwd_kernel", "fa_dq_kernel", "fa_dkv_kernel",   # CUDA cores
         "fb_fwd_kernel", "fb_dq_kernel", "fb_dkv_kernel",        # bf16
         "fb_dkv_combine_kernel")
GEMM = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_", "sm80_")


def _group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in FLASH):
        return "flash"
    if any(k in low for k in GEMM):
        return "gemm"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 1

    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.incubate.nn import functional as FF
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    batch, accum = 2, 2
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = args.layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(args.seed, "cuda"))
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=10),
                         warmup_steps=2, start_lr=3e-5, end_lr=3e-4)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, opt, grad_accum_steps=accum)
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, args.seq + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()

    for _ in range(2):                                  # warm-up
        trainer(x, y)
    untraced = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer(x, y)
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(untraced))

    common = dict(layers=args.layers, batch=batch, seq=args.seq,
                  grad_accum_steps=accum, dtype="bf16, f32 masters")
    fb = window("fwd_bwd", lambda: trainer.compute_loss_grads(x, y),
                args.top, _group)
    up = window("update", trainer.apply_update, args.top, _group)
    hidden = torch.randn((1, args.seq, cfg.hidden_size), device="cuda",
                         dtype=torch.bfloat16, requires_grad=True)

    def loss_fwd_bwd():
        FF.fused_linear_cross_entropy(hidden, model.lm_head.weight,
                                      y[:1]).backward()

    loss_fwd_bwd()
    lo = window("loss", loss_fwd_bwd, args.top, _group)
    lo["micro_batches_per_step"] = accum
    for w in (fb, up, lo):
        w.update(common)
        print(json.dumps(w), flush=True)
    traced_wall = fb["wall_ms"] + up["wall_ms"]
    device = None
    if fb["device_ms"] is not None and up["device_ms"] is not None:
        device = fb["device_ms"] + up["device_ms"]
    print(json.dumps(dict(
        window="step", untraced_step_ms=step_ms, traced_wall_ms=traced_wall,
        device_ms=device,
        idle_share=None if device is None else 1.0 - device / step_ms,
        idle_share_traced=(None if device is None
                           else 1.0 - device / traced_wall), **common)),
          flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
