#!/usr/bin/env python3
"""Where a training step's device time goes on the CUDA card (the port).

    python3 tools/torch_train_profile.py [--layers 8] [--seq 4096]
    python3 tools/torch_train_profile.py --model moe_gpt [--layers 24]
                                         [--seq 1024]

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

With ``--model moe_gpt`` the model is ``MoEGPTConfig()`` (GPT-3 345M
widths, 8 experts top-2 on every 2nd block) at ``--layers``, trained as
``chip_smoke.py``'s moe phase does (one batch of 4 x ``--seq`` tokens, no
gradient accumulation), and the ``loss`` window gives way to three windows
over one MoE block's pieces alone, forward and backward, at the step's
shapes and times the MoE blocks of the model: ``moe_routing`` (the gate's
product, ``top_k_dispatch``), ``moe_dispatch_combine`` (the token ->
expert and expert -> token products over the one-hot tensors) and
``moe_experts`` (the two batched expert products and the GELU), each
also timed on the card's clock (``event_ms``, CUDA events over 5 calls).
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


def moe_windows(model, tokens, top) -> list:
    """One MoE block's routing, dispatch/combine products and experts,
    each forward and backward alone on seeded bf16 activations of
    ``tokens`` tokens, with each window's device ms also times the
    model's MoE blocks (``per_step_device_ms``)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        top_k_dispatch
    blocks = [b.moe for b in model.h if hasattr(b, "moe")]
    layer = blocks[0]
    d, k = layer.d_model, layer.top_k
    cap = layer.capacity(tokens)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, grad=True):
        t = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        return t.requires_grad_(grad)

    xt = rand(tokens, d)

    def routing():
        combine, _, aux = top_k_dispatch(layer.gate(xt), k, cap,
                                         layer.gate.aux_loss_mode)
        torch.autograd.backward([combine, aux],
                                [torch.ones_like(combine), torch.ones_like(
                                    aux)])

    with torch.no_grad():
        combine, dispatch, _ = top_k_dispatch(layer.gate(xt), k, cap,
                                              layer.gate.aux_loss_mode)
    e = combine.shape[1]
    combine = combine.requires_grad_(True)
    expert_out = rand(e * cap, d)
    g_disp, g_out = rand(e * cap, d, grad=False), rand(tokens, d,
                                                        grad=False)

    def dispatch_combine():
        mask = dispatch.reshape(tokens, e * cap).to(xt.dtype)
        disp = mask.transpose(0, 1) @ xt
        out = combine.reshape(tokens, e * cap).to(expert_out.dtype) \
            @ expert_out
        torch.autograd.backward([disp, out], [g_disp, g_out])

    disp = rand(e, cap, d)
    g_exp = rand(e, cap, d, grad=False)

    def experts():
        layer.experts(disp).backward(g_exp)

    out = []
    for name, fn in (("moe_routing", routing),
                     ("moe_dispatch_combine", dispatch_combine),
                     ("moe_experts", experts)):
        fn()
        w = window(name, fn, top, _group)
        ms = event_ms(fn)
        w.update(moe_blocks=len(blocks), tokens=tokens, capacity=cap,
                 event_ms=ms, per_step_event_ms=ms * len(blocks),
                 per_step_device_ms=(None if w["device_ms"] is None
                                     else w["device_ms"] * len(blocks)))
        out.append(w)
    return out


def event_ms(fn, iters: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls on the card's
    clock (CUDA events), beside the traced window's device sum."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama", choices=("llama",
                                                         "moe_gpt"))
    ap.add_argument("--layers", type=int, default=None,
                    help="default 8 (llama), 24 (moe_gpt)")
    ap.add_argument("--seq", type=int, default=None,
                    help="default 4096 (llama), 1024 (moe_gpt)")
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

    moe = args.model == "moe_gpt"
    if moe:
        from paddle_tpu_torch.models import MoEGPTConfig, MoEGPTForCausalLM
        batch, accum = 4, 1
        args.layers = args.layers or 24
        args.seq = args.seq or 1024
        cfg = MoEGPTConfig()
        cfg.num_hidden_layers = args.layers
        model = MoEGPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                  generator=seed(args.seed, "cuda"))
    else:
        batch, accum = 2, 2
        args.layers = args.layers or 8
        args.seq = args.seq or 4096
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

    common = dict(model=args.model, layers=args.layers, batch=batch,
                  seq=args.seq, grad_accum_steps=accum,
                  dtype="bf16, f32 masters")
    fb = window("fwd_bwd", lambda: trainer.compute_loss_grads(x, y),
                args.top, _group)
    up = window("update", trainer.apply_update, args.top, _group)
    if moe:
        extra = moe_windows(model, batch * args.seq, args.top)
    else:
        hidden = torch.randn((1, args.seq, cfg.hidden_size), device="cuda",
                             dtype=torch.bfloat16, requires_grad=True)

        def loss_fwd_bwd():
            FF.fused_linear_cross_entropy(hidden, model.lm_head.weight,
                                          y[:1]).backward()

        loss_fwd_bwd()
        lo = window("loss", loss_fwd_bwd, args.top, _group)
        lo["micro_batches_per_step"] = accum
        extra = [lo]
    for w in [fb, up] + extra:
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
