#!/usr/bin/env python3
"""Where a serving step's time goes on the CUDA card (the PyTorch port).

    python3 tools/torch_serving_profile.py [--layers 32] [--steps 8]
        [--package-root DIR]

Builds Llama-2-7B (bf16, random weights from ``--seed``) and a
``ServingEngine(max_batch=4, page_size=64, max_seq_len=1024)``, fills its
four slots with prompts of 17, 100, 200 and 256 tokens, and traces with
``torch.profiler``, for the fused decode one layer a launch, the generic
decode and the fused decode four layers a launch
(``FLAGS_fused_block_layers=4``) in turn:

  prefill  one engine step that admits a 256-token prompt into an empty
           engine (its whole-prompt prefill, then one decode step);
  decode   ``--steps`` decode-only engine steps with all four slots busy;
           its kernels also summed by group (GEMVs, attention, the rest).

Then, on an engine with a 4096-token context:

  chunk    one engine step that runs one 256-token prefill chunk of a
           3500-token prompt from start 3072 (its thirteenth chunk, after
           twelve untraced ones), with no slot decoding;
  long_decode
           ``--steps`` decode-only steps with the four slots holding
           serve_long's long prompts (3500, 2900, 1800 and 700 tokens,
           prefilled in untraced chunks first), on the native pool one
           layer a launch, on an int8 pool one layer a launch, and on an
           int8 pool with int4 weights four layers a launch; its kernels
           are also summed by group (GEMVs, attention, the rest).

Then speculative decoding at batch 1, with a TinyLlama-1.1B-shaped draft
(hidden 2048, 22 layers, 32 heads over 4 kv heads, inter 5632; random
weights from ``--seed``) and ``FLAGS_serving_spec_max_slots=9``, a
256-token prompt:

  spec_round
           ``--steps`` engine steps, each one speculation round (the
           draft scan and the verify, graphed), its kernels summed by
           group (the draft's fused decode kernels, the chunk attention,
           cuBLAS's GEMMs, the rest), beside
  decode_b1
           ``--steps`` plain decode steps of the same prompt at batch 1.

Per window it prints one JSON line (``torch_trace.window``): the
host-clock wall time (ending in a synchronise), the summed device time of
every kernel, copy and memset the trace saw (one stream, so they do not
overlap), the device's idle share (1 - device / wall), and the kernels
that took the most device time, with their launch counts. The decode
windows also give ``untraced_wall_ms``: the next ``--steps`` steps on the
host clock without the profiler. Then the card's name and power limit.
The package comes from ``--package-root`` when given (default: this
checkout), so one call can run a parent commit unpacked elsewhere with
this tool. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from torch_trace import card, window  # noqa: E402  (this script's folder)

PROMPT_LENS = (17, 100, 200, 256)
LONG_PROMPT, CHUNK, CHUNK_START = 3500, 256, 3072
# serve_long's long prompts, one a slot; (layers a launch, kv, weights)
LONG_DECODE_LENS = (3500, 2900, 1800, 700)
LONG_DECODE_RUNS = ((1, "native", "native"), (1, "int8", "native"),
                    (4, "int8", "int4"))


# the attention kernels: the split-KV decode routine (#2, and the fused
# decode's phase 2 with its append), the chunk and prompt attention, and
# any kernel named for it
ATTENTION_KERNELS = ("attention", "decode_split", "append_kv", "paged_chunk",
                     "prefill")


def kernel_group(name: str) -> str:
    """The decode step's kernels by kind: weight GEMVs, attention, other."""
    if "gemv" in name:
        return "gemv"
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention"
    return "other"


# a speculation round's kernels: the draft scan's fused decode (#3: GEMV
# partials, epilogues, the append and the split-KV walk), the verify's
# chunk attention (#4 and its split merge), cuBLAS's GEMMs (the verify's
# linears, both LM heads) and the rest
FUSED_DECODE_KERNELS = ("gemv", "epilogue", "append_kv", "decode_split",
                        "rms_kernel")
SPEC_DRAFT = dict(hidden_size=2048, num_hidden_layers=22,
                  num_attention_heads=32, num_key_value_heads=4,
                  intermediate_size=5632, max_position_embeddings=2048)


def spec_group(name: str) -> str:
    if any(k in name for k in FUSED_DECODE_KERNELS):
        return "draft_fused_decode"
    if "paged_chunk" in name or "prefill_combine" in name:
        return "chunk_attention"
    if any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "gemm"
    return "other"


def untraced_ms(fn) -> float:
    """Host-clock ms of ``fn`` between two synchronises, no profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--package-root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.package_root))

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = args.layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(args.seed, "cuda"))
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS + (LONG_PROMPT,)]
    new_tokens = len(PROMPT_LENS) + 4 + 2 * args.steps
    info = dict(layers=args.layers, batch=4, dtype="bf16")
    for fused, group in ((True, 1), (False, 1), (True, 4)):
        flags.set_flags({"fused_block_decode": fused,
                         "fused_block_layers": group})
        eng = ServingEngine(model, max_batch=4, page_size=64,
                            max_seq_len=1024)
        eng.submit(prompts[0][:9], 2)         # warm-up: library loads
        eng.run()
        eng.submit(prompts[len(PROMPT_LENS) - 1], new_tokens)
        pre = window("prefill", eng.step, args.top)
        for p in prompts[:len(PROMPT_LENS) - 1]:
            eng.submit(p, new_tokens)
        for _ in range(len(PROMPT_LENS) + 1):   # admit the rest, settle
            eng.step()
        dec = window("decode", lambda: [eng.step()
                                        for _ in range(args.steps)],
                     args.top, group=kernel_group)
        dec["steps"] = args.steps
        dec["untraced_wall_ms"] = untraced_ms(
            lambda: [eng.step() for _ in range(args.steps)])
        for w in (pre, dec):
            w.update(decode="fused" if fused else "generic",
                     fused_block_layers=group, **info)
            print(json.dumps(w), flush=True)
        flags.reset_flags()
        del eng
    eng = ServingEngine(model, max_batch=4, page_size=64, max_seq_len=4096,
                        prefill_chunk=CHUNK)
    eng.submit(prompts[0][:9], 2)             # warm-up: library loads
    eng.submit(prompts[-1][:CHUNK + 9], 2)    # and the chunk path
    eng.run()
    eng.submit(prompts[-1], 2)
    for _ in range(CHUNK_START // CHUNK):
        eng.step()
    chunk = window("chunk", eng.step, args.top)
    chunk.update(prompt=LONG_PROMPT, start=CHUNK_START, chunk=CHUNK,
                 decode="fused", **info)
    print(json.dumps(chunk), flush=True)
    del eng
    chunks = sum(-(-n // CHUNK) for n in LONG_DECODE_LENS)
    for group, kv_dtype, weight_dtype in LONG_DECODE_RUNS:
        flags.set_flags({"fused_block_layers": group})
        eng = ServingEngine(model, max_batch=4, page_size=64,
                            max_seq_len=4096, prefill_chunk=CHUNK,
                            kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        eng.submit(prompts[0][:9], 2)         # warm-up: library loads
        eng.submit(prompts[-1][:CHUNK + 9], 2)
        eng.run()
        for n in LONG_DECODE_LENS:
            eng.submit(prompts[-1][:n], chunks + 2 * args.steps + 4)
        for _ in range(chunks):               # one chunk a step, untraced
            eng.step()
        dec = window("long_decode", lambda: [eng.step()
                                             for _ in range(args.steps)],
                     args.top, group=kernel_group)
        dec["untraced_wall_ms"] = untraced_ms(
            lambda: [eng.step() for _ in range(args.steps)])
        dec.update(steps=args.steps, prompt_lens=list(LONG_DECODE_LENS),
                   decode="fused", fused_block_layers=group,
                   kv_dtype=kv_dtype, weight_dtype=weight_dtype, **info)
        print(json.dumps(dec), flush=True)
        flags.reset_flags()
        del eng
    draft = LlamaForCausalLM(LlamaConfig(**SPEC_DRAFT), device="cuda",
                             dtype=torch.bfloat16,
                             generator=seed(args.seed + 21, "cuda"))
    prompt = prompts[len(PROMPT_LENS) - 1]
    for name, d in (("spec_round", draft), ("decode_b1", None)):
        flags.set_flags({"serving_spec_max_slots": 9})
        eng = ServingEngine(model, max_batch=1, page_size=64,
                            max_seq_len=1024, draft_model=d)
        flags.reset_flags()
        eng.submit(prompts[0][:9], 8)         # warm-up: first calls,
        eng.run()                             # captures at γ 4 and 2
        eng.submit(prompt, 4 * args.steps + 8)
        for _ in range(4):                    # the prefill, and γ settles
            eng.step()
        w = window(name, lambda: [eng.step() for _ in range(args.steps)],
                   args.top, group=spec_group if d is not None else
                   kernel_group)
        w["untraced_wall_ms"] = untraced_ms(
            lambda: [eng.step() for _ in range(args.steps)])
        w.update(steps=args.steps, prompt=len(prompt), batch=1,
                 layers=args.layers, dtype="bf16")
        if d is not None:
            w.update(draft="tinyllama_1.1b shape",
                     gamma=eng.spec_last_gamma, rounds=eng.spec_rounds,
                     accepted=eng.spec_tokens_accepted)
        print(json.dumps(w), flush=True)
        del eng
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
