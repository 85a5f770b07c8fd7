#!/usr/bin/env python3
"""memwatch CLI for the PyTorch port: what-if memory planner and
per-program memory regression gate.

Four subcommands over ``paddle_tpu_torch/observability/memory.py`` (the
port's program capture, estimator and planner):

  **plan** -- a serving configuration's device-memory breakdown against a
  card, and the largest page budget that still fits (CPU, arithmetic
  only)::

      python3 tools/torch_memwatch.py plan --model llama2_7b \\
          --weight-dtype int8 --kv-dtype int8 --page-budget 1024 \\
          --page-size 64 --rung 32 --chunk 256 --max-seq 2048 --hbm-gb 80

  With ``--fused-layers N`` it also prices the N-layer fused decode
  (``plan_fused_layers``: the kernels' shared memory a block against
  ``--shared-kb``, the f32 scratch against the card) and refuses an N that
  does not fit.

  **bank** -- run the capture suite on the card (tiny Llama fused and
  chunked serving, on an int8 pool, N = 2 layers a launch, N = 2 on an
  int8 pool with int4 weights; tiny GPT generic serving and a train step;
  a tiny MoE-GPT train step) with memwatch on and bank every program's
  row with the estimator's predictions::

      python3 tools/torch_memwatch.py bank --out build/memwatch.json

  **check** -- run the suite again and flag any program whose ``temp`` or
  ``peak`` grew past ``--tol`` against a banked artifact (exit 1 on
  growth, or when no banked row matched a captured one)::

      python3 tools/torch_memwatch.py check --artifact build/memwatch.json

  **view** -- print a banked artifact's rows (or a bench line's
  ``"memory"`` section) as a table (CPU).

Differences from ``tools/memwatch.py``: the card defaults to the H100's
80 GB (``--hbm-gb``), the fused decode is priced against shared memory a
block (``--shared-kb``, 48) instead of TPU VMEM, the suite adds the
MoE-GPT train step, and ``bank`` / ``check`` take ``--device`` (default
the card; ``cpu`` records rows with ``temp`` 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

SCHEMA = 1
GB = 1 << 30

_MODELS = ("llama_tiny", "llama2_7b", "llama2_70b", "gpt_tiny", "gpt3_345m",
           "moe_gpt_tiny")


def _config(name: str):
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig, MoEGPTConfig
    table = {
        "llama_tiny": LlamaConfig.tiny,
        "llama2_7b": LlamaConfig.llama2_7b,
        # Llama-2-70B's published geometry (the port has no preset)
        "llama2_70b": lambda: LlamaConfig(
            hidden_size=8192, num_hidden_layers=80, num_attention_heads=64,
            num_key_value_heads=8, intermediate_size=28672),
        "gpt_tiny": GPTConfig.tiny,
        "gpt3_345m": GPTConfig.gpt3_345m,
        "moe_gpt_tiny": MoEGPTConfig.tiny,
    }
    if name not in table:
        raise SystemExit(f"unknown --model {name!r} (have {_MODELS})")
    return table[name]()


def _dims(name: str):
    from paddle_tpu_torch.observability.memory import ModelDims
    return ModelDims.of_config(_config(name))


# ------------------------------------------------------------------ plan
def cmd_plan(args) -> int:
    from paddle_tpu_torch.observability import memory as memwatch

    dims = _dims(args.model)
    kw = dict(page_size=args.page_size, max_batch=args.rung,
              max_seq_len=args.max_seq, chunk=args.chunk,
              weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
              host_tier_pages=args.host_tier_pages, tp=args.tp)
    if args.draft:
        kw.update(draft_dims=_dims(args.draft), spec_gamma=args.spec_gamma,
                  draft_weight_dtype=args.draft_weight_dtype
                  or args.weight_dtype)
    try:
        plan = memwatch.estimate_engine_memory(
            dims, page_budget=args.page_budget, **kw)
    except ValueError as e:
        # a degree the engine would refuse gets no number
        print(f"# memwatch plan: {args.model} tp={args.tp}")
        print(f"  -> REFUSED: {e}")
        return 1
    hbm = int(args.hbm_gb * GB)
    verdict = memwatch.fits(plan, hbm)

    def fmt(b):
        return f"{b / GB:8.3f} GB" if b >= 1 << 20 else f"{b:8d} B "

    spec_note = (f" draft={args.draft} gamma={args.spec_gamma}"
                 if args.draft else "")
    tp_note = f" tp={args.tp} [one shard's bill]" if args.tp > 1 else ""
    print(f"# memwatch plan: {args.model} weights={args.weight_dtype} "
          f"kv={args.kv_dtype} rung={args.rung} chunk={args.chunk} "
          f"pages={plan['config']['usable_pages']}x{args.page_size} "
          f"max_seq={args.max_seq} host_tier={args.host_tier_pages}"
          f"{spec_note}{tp_note}")
    for k, v in plan["breakdown"].items():
        print(f"  {k:32s} {fmt(v)}")
    print(f"  {'TOTAL (device memory)':32s} {fmt(plan['total'])}")
    print(f"  {'card memory':32s} {fmt(hbm)}")
    print(f"  -> {'FITS' if verdict['fits'] else 'DOES NOT FIT'} "
          f"(headroom {verdict['headroom_bytes'] / GB:+.3f} GB)")
    ht = plan["host_tier"]
    if ht["pages"]:
        eff = ht["pages"] + plan["config"]["usable_pages"]
        print(f"  {'host KV tier (host RAM)':32s} {fmt(ht['bytes'])}  "
              f"[{ht['pages']} pages -> effective prefix working set "
              f"{eff} pages]")
        if args.host_ram_gb:
            host = int(args.host_ram_gb * GB)
            print(f"  {'host RAM':32s} {fmt(host)}  "
                  f"(tier headroom {(host - ht['bytes']) / GB:+.3f} GB)")
    # the largest page budget that still fits (each probe is arithmetic)
    lo, hi = 0, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        p = memwatch.estimate_engine_memory(dims, page_budget=mid, **kw)
        if p["total"] <= hbm:
            lo = mid
        else:
            hi = mid - 1
    toks = lo * args.page_size
    print(f"  max usable page budget at this card: {lo} pages "
          f"({toks} KV tokens, ~{toks // max(args.max_seq, 1)} full-length "
          f"sequences)")
    fplan = None
    if args.fused_layers > 1:
        io = 4 if args.weight_dtype == "float32" else 2
        fplan = memwatch.plan_fused_layers(
            dims, fused_layers=args.fused_layers, batch=args.rung,
            page_size=args.page_size, io_dtype_bytes=io,
            vmem_limit=int(args.shared_kb * 1024),
            max_seq_len=args.max_seq,
            int4_weights=args.weight_dtype == "int4", hbm_bytes=hbm)
        print(f"# fused decode: N={args.fused_layers} rung={args.rung} "
              f"io={io}B nsplit={fplan['nsplit']}")
        for k, v in fplan["breakdown"].items():
            print(f"  {k:32s} {v:10d} B")
        print(f"  {'shared memory a block':32s} "
              f"{fplan['shared_per_block']:10d} B")
        print(f"  {'shared memory limit':32s} {fplan['vmem_limit']:10d} B")
        if not fplan["fits"]:
            print(f"  -> REFUSED: --fused-layers {args.fused_layers} does "
                  f"not fit {args.shared_kb:g} KiB a block or the card; "
                  f"lower N or the decode rung")
        else:
            print(f"  -> FITS (shared headroom {fplan['headroom_bytes']} B)")
    if args.json:
        print(json.dumps({"plan": plan, "verdict": verdict,
                          "max_page_budget": lo,
                          **({"fused_decode": fplan} if fplan else {})}))
    if fplan is not None and not fplan["fits"]:
        return 1
    return 0 if verdict["fits"] else 1


# ------------------------------------------------- capture suite (bank)
def capture_suite(device=None) -> dict:
    """Run the capture suite with memwatch on and return ``{schema, bench,
    device, rows, estimates, watermarks}``: tiny-Llama serving (fused
    decode, chunked prefill; on an int8 pool; N = 2 layers a launch; N = 2
    on an int8 pool with int4 weights), tiny-GPT serving (generic decode)
    and a train step, and a tiny MoE-GPT train step. Seeded: the byte
    sizes are deterministic on one card, which the gate diffs."""
    import numpy as np
    import torch

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.device import resolve_device, seed
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache)
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM,
                                         MoEGPTConfig, MoEGPTForCausalLM)
    from paddle_tpu_torch.observability import memory as memwatch

    dev = resolve_device(device)
    prior = {k: flags.get_flag(k)
             for k in ("telemetry", "memwatch", "fused_block_layers")}
    flags.set_flags({"telemetry": True, "memwatch": True})
    clear_decode_program_cache()
    memwatch.clear_program_table()
    rng = np.random.default_rng(13)
    estimates = []

    def prompt(cfg, n):
        return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)

    def serve(model, cfg, lens, **kw):
        eng = ServingEngine(model, max_batch=2, page_size=8, max_seq_len=48,
                            **kw)
        for n in lens:
            eng.submit(prompt(cfg, n), 4)
        eng.run()
        return eng

    try:
        lcfg = LlamaConfig.tiny()
        runs = (((6, 20), dict(prefill_chunk=8), 1),
                ((6,), dict(kv_dtype="int8"), 1),
                ((6,), {}, 2),
                ((6,), dict(kv_dtype="int8", weight_dtype="int4"), 2))
        for lens, kw, group in runs:
            flags.set_flags({"fused_block_layers": group})
            model = LlamaForCausalLM(lcfg, device=dev, generator=seed(13, dev))
            eng = serve(model, lcfg, lens, **kw)
            estimates += _engine_estimates(eng, model, lcfg,
                                           chunk=kw.get("prefill_chunk"),
                                           fused_layers=group)
            del eng, model
        flags.set_flags({"fused_block_layers": prior["fused_block_layers"]})
        gcfg = GPTConfig.tiny()
        gmodel = GPTForCausalLM(gcfg, device=dev, generator=seed(13, dev))
        eng = serve(gmodel, gcfg, (6,))
        estimates += _engine_estimates(eng, gmodel, gcfg)
        del eng
        _run_train_step(gmodel, gcfg, rng, gpt_loss=True)
        mcfg = MoEGPTConfig.tiny(num_hidden_layers=2)
        _run_train_step(MoEGPTForCausalLM(mcfg, device=dev,
                                          generator=seed(13, dev)),
                        mcfg, rng)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rows = memwatch.program_table()
    finally:
        flags.set_flags(prior)
        clear_decode_program_cache()
    return {"schema": SCHEMA, "bench": "memwatch", "device": str(dev),
            "rows": rows, "estimates": estimates,
            "watermarks": memwatch.sample_device_memory(publish=False)}


def _engine_estimates(eng, model, cfg, chunk=None, fused_layers=1):
    """The estimator's prediction for each of this engine's captured decode
    and chunk programs, beside the captured row."""
    from paddle_tpu_torch.generation.program_cache import (TAG_KV, TAG_WT,
                                                           model_signature)
    from paddle_tpu_torch.observability import memory as memwatch

    dims = memwatch.ModelDims.of_config(cfg)
    geom = memwatch.PoolGeometry.of_pool(eng.pool)
    pb = memwatch.tensor_bytes(model)
    sig = model_signature(model)[:8]
    tag_kv, tag_wt = str((TAG_KV, eng.kv_dtype)), str((TAG_WT,
                                                        eng.weight_dtype))
    out = []
    for row in memwatch.program_table():
        if (row["model"] != sig or tag_kv not in row["extra"]
                or tag_wt not in row["extra"]):
            continue
        kind = row["kind"]
        if kind == "decode_fused_nlayer":
            est = memwatch.estimate_decode_program(
                dims, geom, row["bucket"], pb, fused_layers=fused_layers,
                int4_weights=eng.weight_dtype == "int4")
        elif kind.startswith("decode"):
            est = memwatch.estimate_decode_program(dims, geom,
                                                   row["bucket"], pb)
        elif kind == "prefill_chunk" and chunk:
            est = memwatch.estimate_prefill_program(dims, geom, chunk, pb,
                                                    chunked=True)
        else:
            continue
        comp = row["temp"] + row["output"]
        pred = est["temp"] + est["output"]
        out.append({"model": sig, "kind": kind, "bucket": row["bucket"],
                    "extra": row["extra"], "estimate": est,
                    "captured_temp_plus_output": comp,
                    "estimated_temp_plus_output": pred,
                    "rel_err": round(pred / comp - 1.0, 4) if comp else None})
    return out


def _run_train_step(model, cfg, rng, gpt_loss=False):
    """Two AdamW steps on one batch of 2 x 8 tokens (the first is the
    measured one); GPT through a cross-entropy ``loss_fn`` on its logits,
    MoE-GPT through its own loss."""
    import torch

    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    def loss_fn(logits, y):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))

    step = TrainStep(model, AdamW(1e-4, parameters=model.named_parameters()),
                     loss_fn=loss_fn if gpt_loss else None)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    step(x, y)
    step(x, y)
    step.sync()


def cmd_bank(args) -> int:
    doc = capture_suite(args.device)
    text = json.dumps(doc, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"banked {len(doc['rows'])} program rows -> {args.out}")
    else:
        print(text)
    return 0


def check_rows(banked_rows, rows, tol: float, artifact: str) -> int:
    """Print the gate's findings for ``rows`` against ``banked_rows``;
    1 when a program grew or no banked row was captured again, else 0."""
    from paddle_tpu_torch.observability import memory as memwatch

    findings = memwatch.compare_program_rows(banked_rows, rows,
                                             tolerance=tol)
    grew = [f for f in findings if f["verdict"] == "grew"]
    info = [f for f in findings if f["verdict"] != "grew"]
    missing = [f for f in info if f["verdict"] == "missing"]
    matched = len(banked_rows) - len(missing)

    def where(f):
        return (f"{f['model']}:{f['kind']}/b{f['bucket']}"
                f"{('/' + f['extra']) if f['extra'] else ''}")

    for f in grew:
        why = (f"{f['growth']:+.1%} > {tol:.0%} tolerance"
               if f["growth"] is not None else "banked 0 -> nonzero")
        print(f"GREW  {where(f)} {f['section']}: {f['banked']} -> "
              f"{f['current']} ({why})")
    for f in info:
        print(f"note  {where(f)}: {f['verdict']}")
    if not matched:
        # a gate that compares nothing must not pass
        print(f"memwatch gate FAILED: no banked program matched a captured "
              f"row ({len(banked_rows)} banked, {len(rows)} captured): "
              f"re-bank or fix the capture")
        return 1
    if not grew:
        print(f"memwatch gate OK: {matched} programs within {tol:.0%} of "
              f"{artifact}")
    return 1 if grew else 0


def cmd_check(args) -> int:
    with open(args.artifact) as f:
        banked = json.load(f)
    doc = capture_suite(args.device)
    return check_rows(banked["rows"], doc["rows"], args.tol, args.artifact)


def cmd_view(args) -> int:
    from paddle_tpu_torch.observability import memory as memwatch

    with open(args.artifact) as f:
        doc = json.load(f)
    rows = doc.get("rows") or doc.get("memory", {}).get("programs") or []
    if not rows:
        raise SystemExit("no program rows in artifact")
    print(memwatch.format_program_table(rows))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    dtypes = ("float32", "bfloat16", "int8", "int4")

    p = sub.add_parser("plan", help="what-if device-memory planner")
    p.add_argument("--model", default="llama2_7b", choices=_MODELS)
    p.add_argument("--weight-dtype", default="bfloat16", choices=dtypes)
    p.add_argument("--kv-dtype", default="bfloat16",
                   choices=("bfloat16", "int8"))
    p.add_argument("--page-budget", type=int, default=None,
                   help="usable KV pages (default: the worst case)")
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--rung", type=int, default=8,
                   help="decode batch bucket (ladder rung)")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--hbm-gb", type=float, default=80.0,
                   help="the card's memory (H100: 80)")
    p.add_argument("--host-tier-pages", type=int, default=0,
                   help="host-RAM KV tier pages, priced against host RAM")
    p.add_argument("--host-ram-gb", type=float, default=0.0)
    p.add_argument("--draft", default=None, choices=_MODELS,
                   help="price speculative serving with this draft")
    p.add_argument("--spec-gamma", type=int, default=4)
    p.add_argument("--draft-weight-dtype", default=None, choices=dtypes)
    p.add_argument("--tp", type=int, default=1,
                   help="price one shard of a tensor-parallel engine")
    p.add_argument("--fused-layers", type=int, default=1,
                   help="price the N-layer fused decode; an N that does "
                        "not fit is refused (exit 1)")
    p.add_argument("--shared-kb", type=float, default=48.0,
                   help="static shared memory a block for --fused-layers")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("bank", help="capture and bank program rows")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card")
    p.set_defaults(fn=cmd_bank)

    p = sub.add_parser("check", help="regression gate vs a banked artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--tol", type=float, default=0.10)
    p.add_argument("--device", default=None)
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("view", help="render a banked artifact")
    p.add_argument("artifact")
    p.set_defaults(fn=cmd_view)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
