#!/usr/bin/env python3
"""Ring attention over ``sep`` and expert parallelism over ``dp`` across the
cards of one host, over NCCL.

    python3 tools/torch_long_context_cards.py [--cards 4] [--reps 5]
                                              [--moe-layers 4] [--steps 4]

One process a card (the port's ``spawn``, NCCL on ``cuda:<rank>``).

- Ring: Llama-2-7B's attention (32 heads of 128, bf16, B = 1) at sep =
  cards over S = 16384 and 65536 tokens, causal, through
  ``sep_scaled_dot_product_attention`` (zigzag order) and Ulysses with the
  flash kernel as ``attn_fn``: the median wall of the forward and
  backward of ``sum(out * do)`` over ``--reps`` repetitions after one
  warm-up (CUDA-synchronized, the slowest rank), beside the whole
  sequence's ``flash_attention_bshd`` on one card.
- Experts: ``MoEGPTConfig()`` widths at ``--moe-layers`` layers, bf16
  with f32 masters, 4 x 1024 tokens a rank, through ``TrainStep(mesh=
  ...)`` at dp = cards, with ``expert_axis="dp"`` (8 / cards experts a
  rank) and without (every expert on every rank, routing over the global
  batch): the median step ms of ``--steps`` steps after one warm-up, the
  losses, the peak memory and the collectives a step.

Prints one JSON line a row and a summary line with the cards' name and
power limit; exits 1 without enough cards.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 1234
HEADS, HEAD_DIM = 32, 128
SEQS = (16384, 65536)
MOE_BATCH, MOE_SEQ = 4, 1024


def _wall(fn, reps, dev, group):
    from paddle_tpu_torch import distributed as pdist
    times = []
    for i in range(reps + 1):
        pdist.barrier(group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        if i:
            times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _ring_rows(r, args, dev):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.distributed.fleet.utils import ring_flash_attention
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_bshd
    hcg = topo.create_hybrid_communicate_group(sep_degree=args.cards)
    group = hcg.get_sep_parallel_group()
    out = []
    for s in SEQS:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        c = s // args.cards
        full = [torch.randn((1, s, HEADS, HEAD_DIM), generator=gen,
                            device=dev).to(torch.bfloat16)
                for _ in range(4)]
        mine = [t[:, r * c:(r + 1) * c].clone().requires_grad_(True)
                for t in full[:3]]
        do = full[3][:, r * c:(r + 1) * c]
        methods = dict(
            ring=lambda: ring_flash_attention.sep_scaled_dot_product_attention(
                *mine, hcg, "ring", True),
            ulysses=lambda: ring_flash_attention.ulysses_attention(
                *mine, hcg, True, attn_fn=functools.partial(
                    flash_attention_bshd, causal=True), attn_fn_gqa=True))
        for name, fn in methods.items():
            kernels.reset_launches()
            ms = _wall(lambda: torch.autograd.backward(fn(), do), args.reps,
                       dev, group)
            out.append(dict(kind=name, S=s, sep=args.cards, fwd_bwd_ms=ms,
                            launches=kernels.launch_counts()[
                                "flash_attention_fwd"] // (args.reps + 1)))
        whole = [t.clone().requires_grad_(True) for t in full[:3]]
        ms = _wall(lambda: torch.autograd.backward(
            flash_attention_bshd(*whole, causal=True), full[3]), args.reps,
            dev, group)
        out.append(dict(kind="one card, whole sequence", S=s,
                        fwd_bwd_ms=ms))
        del full, mine, whole, do
        torch.cuda.empty_cache()
    topo._reset_hcg()
    return out


def _moe_rows(args, dev):
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models import MoEGPTConfig, MoEGPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    out = []
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(
        0, MoEGPTConfig().vocab_size, (MOE_BATCH * args.cards, MOE_SEQ + 1)))
    x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
    for axis in ("dp", None):
        hcg = topo.create_hybrid_communicate_group(dp_degree=args.cards)
        cfg = MoEGPTConfig(num_hidden_layers=args.moe_layers,
                           expert_axis=axis)
        model = MoEGPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                  generator=seed(SEED, dev))
        opt = AdamW(3e-4, parameters=model.named_parameters(),
                    weight_decay=0.01, multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, opt, mesh=hcg.get_mesh())
        losses = [float(step(x, y))]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pdist.reset_collective_counts()
        step_s = []
        for _ in range(args.steps):
            pdist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
        out.append(dict(
            kind="moe_gpt", expert_axis=axis, dp=args.cards,
            layers=args.moe_layers, tokens_per_rank=MOE_BATCH * MOE_SEQ,
            experts_here=model.h[1].moe.experts.w1.shape[0],
            losses=losses, step_ms=[1e3 * v for v in step_s],
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            collectives={k: v / args.steps for k, v in
                         pdist.collective_counts().items()}))
        topo._reset_hcg()
        del step, opt, model
        torch.cuda.empty_cache()
    return out


def rank(r, args):
    from paddle_tpu_torch import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    pdist.init_parallel_env()
    dev = torch.device(f"cuda:{r}")
    try:
        # NCCL: one collective on the world before the first p2p batch
        pdist.barrier()
        return _ring_rows(r, args, dev) + _moe_rows(args, dev)
    finally:
        pdist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--moe-layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < args.cards:
        print(f"needs {args.cards} CUDA cards", file=sys.stderr)
        return 1
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.kernels import _build
    _build.build_all()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    ctx = spawn(rank, args=(args,), nprocs=args.cards, join=False)
    try:
        ctx.join(1500)
    finally:
        ctx.terminate()
    summary = {}
    for i, row in enumerate(ctx.results[0]):
        per_rank = [res[i] for res in ctx.results]
        if row["kind"] == "moe_gpt":
            row = dict(row, step_ms_median=float(np.median(np.max(
                [p["step_ms"] for p in per_rank], axis=0))),
                peak_mem_gb=[p["peak_mem_gb"] for p in per_rank])
            ok = all(p["losses"] == row["losses"] for p in per_rank) \
                and all(np.isfinite(row["losses"]))
            summary[f"moe_gpt expert_axis={row['expert_axis']}"] = \
                row["step_ms_median"]
        else:
            row = dict(row, fwd_bwd_ms=max(p["fwd_bwd_ms"]
                                           for p in per_rank))
            ok = True
            summary[f"{row['kind']} S={row['S']}"] = row["fwd_bwd_ms"]
        print(json.dumps(row), flush=True)
        if not ok:
            print(f"{row['kind']}: ranks disagree", file=sys.stderr)
            return 1
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()
    print(json.dumps(dict(cards=smi, seconds=time.perf_counter() - t0,
                          ms=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
