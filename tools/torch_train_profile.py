#!/usr/bin/env python3
"""Where a training step's device time goes on the CUDA card (the port).

    python3 tools/torch_train_profile.py [--layers 8] [--seq 4096]
    python3 tools/torch_train_profile.py --model moe_gpt [--layers 24]
                                         [--seq 1024]
    python3 tools/torch_train_profile.py --model unet
    python3 tools/torch_train_profile.py --model bert [--layers 12]
                                         [--seq 512]

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

With ``--model unet`` the model is ``UNetConfig.sd15()`` at full width
and depth, trained as ``chip_smoke.py``'s unet phase does (batch 2 of 4 x
64 x 64 latents, a 77 x 768 context, AdamW 1e-4 with f32 masters, no
clip, no schedule); ``fwd_bwd`` groups the device time into convolutions
(cuDNN), GEMMs, the flash kernels by padded head dim (``flash D=40`` pads
to 64, ``D=80`` to 96, ``D=160``) and everything else, and the ``loss``
window gives way to ``group_norm_silu``: every GroupNorm of the model (and
the SiLU after it where the model applies one), forward and backward,
replayed alone at the shapes one forward gave them. With ``--model
bert`` it is ``BertConfig.bert_base()`` pretraining as the bert phase
runs it (8 x ``--seq`` tokens, dropout 0.1, no kernel: attention is
SDPA's dense path), with no extra window.
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


CONV = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")
# the bf16 kernels' padded head dim -> the UNet's head dim it serves
UNET_HEAD = {"64": "40", "96": "80", "160": "160"}


def _group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in FLASH):
        return "flash"
    if any(k in low for k in GEMM):
        return "gemm"
    return "other"


def _unet_group(name: str) -> str:
    """Convolutions apart from GEMMs, the flash kernels by head dim."""
    low = name.lower()
    if any(k in name for k in FLASH):
        if "<" not in name:                    # fb_dkv_combine_kernel
            return "flash dkv combine"
        dp = name.split("<")[1].split(",")[0].strip()
        return f"flash D={UNET_HEAD.get(dp, dp)}"
    if any(k in low for k in CONV):
        return "conv"
    return _group(name)


def group_norm_window(model, batch, top) -> dict:
    """Every GroupNorm of ``model`` (with the SiLU the model puts after the
    ResNet blocks' and the output's norms), forward and backward, alone
    at the input shapes one forward of ``batch`` gave them."""
    from paddle_tpu_torch.nn import GroupNorm
    from paddle_tpu_torch.nn import functional as F
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: shapes.append(
            (mod, tuple(args[0].shape), not name.endswith(".norm"))))
        for name, m in model.named_modules() if isinstance(m, GroupNorm)]
    try:
        with torch.no_grad():
            model(*batch[:3])
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(shape, device="cuda", generator=gen,
                      dtype=torch.bfloat16).requires_grad_(True)
          for _, shape, _ in shapes]

    def run():
        for (mod, _, silu), x in zip(shapes, xs):
            y = mod(x)
            (F.silu(y) if silu else y).sum().backward()

    run()
    w = window("group_norm_silu", run, top, _group)
    w["calls"] = len(shapes)
    w["event_ms"] = event_ms(run)
    return w


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
    ap.add_argument("--model", default="llama",
                    choices=("llama", "moe_gpt", "unet", "bert"))
    ap.add_argument("--layers", type=int, default=None,
                    help="default 8 (llama), 24 (moe_gpt), 12 (bert)")
    ap.add_argument("--seq", type=int, default=None,
                    help="default 4096 (llama), 1024 (moe_gpt), 512 (bert)")
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

    if args.model in ("unet", "bert"):
        return image_or_encoder(args)
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

    def extra():
        if moe:
            return moe_windows(model, batch * args.seq, args.top)
        hidden = torch.randn((1, args.seq, cfg.hidden_size), device="cuda",
                             dtype=torch.bfloat16, requires_grad=True)

        def loss_fwd_bwd():
            FF.fused_linear_cross_entropy(hidden, model.lm_head.weight,
                                          y[:1]).backward()

        loss_fwd_bwd()
        lo = window("loss", loss_fwd_bwd, args.top, _group)
        lo["micro_batches_per_step"] = accum
        return [lo]

    return profile(trainer, (x, y), _group, extra, args.top, dict(
        model=args.model, layers=args.layers, batch=batch, seq=args.seq,
        grad_accum_steps=accum, dtype="bf16, f32 masters"))


def profile(trainer, batch, group, extra, top, common) -> int:
    """Two warm-up and two untraced steps (their median is the untraced
    step), then the fwd_bwd and update windows and ``extra()``'s, each
    printed as one JSON line with ``common``, the step line and the
    card."""
    for _ in range(2):                                  # warm-up
        trainer(*batch)
    untraced = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer(*batch)
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(untraced))
    fb = window("fwd_bwd", lambda: trainer.compute_loss_grads(*batch), top,
                group)
    up = window("update", trainer.apply_update, top, group)
    for w in [fb, up] + extra():
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


def image_or_encoder(args) -> int:
    """The unet and bert routes: chip_smoke.py's model, batch and trainer
    (its unet and bert phases), profiled as the others (for the UNet also
    the group_norm_silu window)."""
    import chip_smoke as cs
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    if args.model == "unet":
        cfg, model = cs.unet_model("cuda")
        batch = cs.unet_batch(cfg, cs.UNET_BATCH, "cuda", torch.bfloat16)
        return profile(
            cs.unet_trainer(model), batch, _unet_group,
            lambda: [group_norm_window(model, batch, args.top)], args.top,
            dict(model="unet", config="UNetConfig.sd15()",
                 batch=cs.UNET_BATCH, latent=cfg.sample_size,
                 context=cs.UNET_CONTEXT, dtype="bf16, f32 masters"))
    cfg = BertConfig.bert_base()
    cfg.num_hidden_layers = args.layers or cfg.num_hidden_layers
    args.seq = args.seq or cs.BERT_SEQ
    model = cs.bert_model(BertForPretraining, cfg, "cuda")
    *batch, _ = cs.bert_batch(cfg, cs.BERT_BATCH, args.seq, "cuda")
    return profile(cs.bert_trainer(model, cfg), batch, _group, lambda: [],
                   args.top, dict(model="bert",
                                  config="BertConfig.bert_base()",
                                  layers=cfg.num_hidden_layers,
                                  batch=cs.BERT_BATCH, seq=args.seq,
                                  dtype="bf16, f32 masters"))


if __name__ == "__main__":
    sys.exit(main())
