#!/usr/bin/env python3
"""The pipeline's schedules across the cards of one host, over NCCL.

    python3 tools/torch_pipeline_cards.py [--cards 4] [--layers 16]
                                          [--micro 8] [--steps 4]

Each card is one pipeline stage (pp = cards, one process a card started
by the port's ``spawn``, NCCL on ``cuda:<rank>``). The model is the
Llama-2-7B width (``LlamaForCausalLMPipe``, ``--layers`` decoder layers,
bf16 with f32 masters, AdamW with the clip), its entries drawn per entry
from one seed, so every schedule starts from the same weights; the batch
is ``--micro`` rows of 4096 tokens, one row a microbatch. For each
schedule (FThenB, 1F1B, 1F1B under remat, ZBH1, interleaved 1F1B at V =
2) the tool reports the median step ms of ``--steps`` steps after one
warm-up step (CUDA-synchronized wall clock of the slowest rank), each
rank's peak memory, the losses and the collectives a step. It also times
one microbatch's forward and backward through each stage alone after the
measured steps (no transfer; the slowest stage's ``unit_ms``) and the
optimizer update, and gives the lockstep estimate ``(M + (S - 1) / V) x
unit_ms + update_ms`` beside the step, so the measured bubble reads
against ``(S - 1) / (M V + S - 1)``.
The losses of every schedule are held to FThenB's (bf16: within 1e-2
relative; the schedules accumulate the same microbatch gradients in other
orders). Prints one JSON line a schedule and a summary line; exits 1
without enough cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEQ = 4096
SEED = 1234
SCHEDULES = (("FThenB", False, 1), ("1F1B", False, 1), ("1F1B", True, 1),
             ("zbh1", False, 1), ("1F1B", False, 2))


def _optimizer(pipe, steps):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=steps + 1), 1,
                         3e-5, 3e-4)
    return AdamW(sched, parameters=pipe.named_parameters(),
                 weight_decay=0.01, multi_precision=True,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _unit_ms(step, x, y, dev):
    """One microbatch's forward and backward through this stage alone
    (what a transfer would deliver, made locally), and the update."""
    pipe, runner = step.pipe_layer, step._runner
    S, me = step.S, step.stage
    C = S * step.V
    chunks = [c for c in range(C) if c % S == me]
    width = pipe._layers_desc[0].inputs[0].hidden_size
    times = []
    for rep in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for c in chunks:
            xin = x[:1] if c == 0 else torch.randn(
                1, SEQ, width, device=dev, dtype=torch.bfloat16,
                requires_grad=True)
            out = pipe.run_entries(pipe.chunk_entries(c), xin,
                                   remat=runner.remat)
            if c == C - 1:
                step.loss_fn(out, y[:1]).backward()
            else:
                out.backward(torch.ones_like(out))
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step.optimizer.step()
    torch.cuda.synchronize(dev)
    update = time.perf_counter() - t0
    step.optimizer.clear_grad()
    return 1e3 * float(np.median(times)), 1e3 * update


def rank(r, args):
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineTrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLMPipe
    torch.backends.cuda.matmul.allow_tf32 = False
    pdist.init_parallel_env()
    dev = torch.device(f"cuda:{r}")
    out = []
    try:
        cfg = LlamaConfig.llama2_7b()
        cfg.num_hidden_layers = args.layers
        rng = np.random.default_rng(SEED)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (args.micro, SEQ + 1)))
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        for schedule, remat, V in SCHEDULES:
            hcg = topo.create_hybrid_communicate_group(pp_degree=args.cards)
            pipe = LlamaForCausalLMPipe(
                cfg, topology=hcg, num_virtual_pipeline_stages=V,
                device=dev, dtype=torch.bfloat16,
                generator=seed(SEED, dev))
            step = PipelineTrainStep(
                pipe, _optimizer(pipe, args.steps), hcg.get_mesh(),
                args.micro, remat=remat, virtual_pp_degree=V,
                schedule=schedule)
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
            peak = torch.cuda.max_memory_allocated(dev)
            unit_ms, update_ms = _unit_ms(step, x, y, dev)
            out.append(dict(
                schedule=schedule, remat=remat, V=V, losses=losses,
                step_ms=[1e3 * s for s in step_s], unit_ms=unit_ms,
                update_ms=update_ms, ticks=len(step._ticks),
                peak_mem_gb=peak / 1e9,
                collectives={k: v / args.steps for k, v in
                             pdist.collective_counts().items()}))
            topo._reset_hcg()
            del step, pipe
            torch.cuda.empty_cache()
    finally:
        pdist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--micro", type=int, default=8)
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
    S, M = args.cards, args.micro
    base = None
    summary = []
    for i, (schedule, remat, V) in enumerate(SCHEDULES):
        per_rank = [res[i] for res in ctx.results]
        step_ms = float(np.median(np.max(
            [r["step_ms"] for r in per_rank], axis=0)))
        unit = max(r["unit_ms"] for r in per_rank)
        update = max(r["update_ms"] for r in per_rank)
        losses = per_rank[-1]["losses"]
        if base is None:
            base = losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
        row = dict(
            schedule=schedule, remat=remat, V=V, cards=S, microbatches=M,
            layers=args.layers, seq=SEQ, dtype="bf16, f32 masters",
            step_ms_median=step_ms, unit_ms=unit, update_ms=update,
            lockstep_estimate_ms=(M + (S - 1) / V) * unit + update,
            bubble_share_lockstep=(S - 1) / (M * V + S - 1),
            ticks=per_rank[0]["ticks"], losses=losses,
            loss_rel_err_vs_fthenb=rel,
            peak_mem_gb=[r["peak_mem_gb"] for r in per_rank],
            collectives_per_step=per_rank[0]["collectives"])
        print(json.dumps(row), flush=True)
        summary.append(row)
        if not (all(np.isfinite(losses)) and rel <= 1e-2):
            print(f"{schedule}: losses {losses} vs FThenB's {base}",
                  file=sys.stderr)
            return 1
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()
    print(json.dumps(dict(cards=smi, seconds=time.perf_counter() - t0,
                          step_ms={f"{r['schedule']}{'+remat' if r['remat'] else ''}"
                                   f"{'/V2' if r['V'] > 1 else ''}":
                                   r["step_ms_median"] for r in summary})),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
