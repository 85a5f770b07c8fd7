#!/usr/bin/env python3
"""Drive the PyTorch port's Llama serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):
  1. build    compile every kernel in paddle_tpu_torch/kernels/csrc with
              nvcc (sm_90a) into build/kernels/, and time it;
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version on the card at the serving path's Llama-2-7B shapes,
              in bf16 (2e-2 abs) and fp32 (1e-4 abs), and time the kernel,
              the plain version, one library call where PyTorch has one,
              and the card's least time for the same work (bound);
  3. serve    Llama-2-7B width (32 layers, bf16, random weights from a
              seed) through ServingEngine: 8 requests, 32 new tokens each,
              some submitted mid-run, once with fused block decode and once
              with the generic decode; the kernel launch counters show
              which kernels the run went through;
  4. parity   the same engine in fp32 at full width with 2 layers, its
              per-token logits held against a teacher-forced no-cache
              forward of the model (plain PyTorch) on the card.
Then the card's name and power limit (nvidia-smi), the per-kernel summary
line, and as the last line {"ok": true, "device": {...}}.

Without a CUDA card the script exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "fp32"}

# Llama-2-7B geometry (the serving path's kernel shapes)
HIDDEN, HEADS, KV_HEADS, HEAD_DIM, INTER = 4096, 32, 32, 128, 11008
PAGE, MAX_SEQ, BATCH = 64, 1024, 4
PREFILL_LENS = (77, 256)
PROMPT_LENS = (17, 256, 64, 100, 200, 33, 128, 250)
NEW_TOKENS = 32
SEED = 1234
PARITY_LENS, PARITY_NEW_TOKENS = (17, 77, 130, 256), 8
PARITY_TOL = 1e-3      # fp32 logits: kernel sums vs torch.matmul order

SOURCES = {
    "flash_prefill": ("paddle_tpu_torch/kernels/csrc/flash_prefill.cu",
                      "paddle_tpu/kernels/decode_attention.py:140"),
    "paged_attention": ("paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                        "paddle_tpu/kernels/paged_attention.py:154"),
    "fused_block_decode": (
        "paddle_tpu_torch/kernels/csrc/fused_block_decode.cu",
        "paddle_tpu/kernels/fused_block_decode.py:265"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, **kw):
    """The library yardstick: PyTorch's fused attention, (B, H, S, D)."""
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# --------------------------------------------------------------- kernels
def _rand(gen, shape, dtype, device, scale=1.0):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * scale).to(dtype)


def _block_tables(seq_lens, extra_tokens, device):
    """Shuffled block tables over a pool whose page 0 is the null page;
    an idle row (seq_len 0) keeps an all-zero table."""
    maxp = -(-MAX_SEQ // PAGE)
    num_pages = 1 + BATCH * maxp
    perm = np.random.default_rng(SEED).permutation(num_pages - 1) + 1
    bt = np.zeros((len(seq_lens), maxp), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        pages = -(-(n + extra_tokens) // PAGE) if n else 0
        bt[i, :pages] = perm[used:used + pages]
        used += pages
    return torch.from_numpy(bt).to(device), num_pages


def check_flash_prefill(dtype, device, results):
    from paddle_tpu_torch.kernels import decode_attention as da
    gen = torch.Generator(device=device).manual_seed(SEED)
    for s in PREFILL_LENS:
        q = _rand(gen, (1, s, HEADS, HEAD_DIM), dtype, device)
        k = _rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
        v = _rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
        got = da.flash_prefill(q, k, v, s)
        want = da.flash_prefill_ref(q, k, v, s)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= TOL[dtype], f"flash_prefill S={s} {dtype}: max err "
                f"{err} > {TOL[dtype]}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        elem = q.element_size()
        nbytes = elem * (2 * q.numel() + k.numel() + v.numel())
        pairs = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 4.0 * pairs * HEADS * HEAD_DIM
        bms, by = bound_ms(nbytes, flops, dtype)
        results.append(dict(
            kernel="flash_prefill", dtype=DTYPE_NAME[dtype], S=s,
            max_err=err, tol=TOL[dtype],
            kernel_ms=time_ms(lambda: da.flash_prefill(q, k, v, s)),
            plain_ms=time_ms(lambda: da.flash_prefill_ref(q, k, v, s)),
            library_ms=lib, bound_ms=bms, bound_by=by))
    # GQA, a cache longer than the prompt (cur_len > S) and a ragged tail
    q = _rand(gen, (2, 50, HEADS, HEAD_DIM), dtype, device)
    k = _rand(gen, (2, 301, HEADS // 4, HEAD_DIM), dtype, device)
    v = _rand(gen, (2, 301, HEADS // 4, HEAD_DIM), dtype, device)
    err = max_err(da.flash_prefill(q, k, v, 290),
                  da.flash_prefill_ref(q, k, v, 290))
    require(err <= TOL[dtype], f"flash_prefill GQA/ragged {dtype}: {err}")
    results.append(dict(kernel="flash_prefill", dtype=DTYPE_NAME[dtype],
                        case="gqa rep=4, T=301, cur_len=290, S=50",
                        max_err=err, tol=TOL[dtype]))


def check_paged_attention(dtype, device, results):
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    # ragged (1024, 517, 79 at 7B), one idle row
    seq_lens = [MAX_SEQ, MAX_SEQ // 2 + 5, MAX_SEQ // 13 + 1, 0]
    bt, num_pages = _block_tables(seq_lens, 0, device)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
    kp, vp = _rand(gen, shape, dtype, device), _rand(gen, shape, dtype, device)
    q = _rand(gen, (BATCH, HEADS, HEAD_DIM), dtype, device)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    want = pa.paged_attention_ref(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err <= TOL[dtype], f"paged_attention {dtype}: max err {err}")
    require(not got[3].any(), "paged_attention: idle row must read zeros")
    # library yardstick: SDPA over the gathered contiguous view
    t = bt.shape[1] * PAGE
    kg = kp[:, bt.long()].movedim(1, 0).reshape(BATCH, KV_HEADS, t, HEAD_DIM)
    vg = vp[:, bt.long()].movedim(1, 0).reshape(BATCH, KV_HEADS, t, HEAD_DIM)
    mask = (torch.arange(t, device=device)[None, :] < sl[:, None])
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    lib = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    elem = q.element_size()
    live = sum(seq_lens)
    nbytes = (elem * (2 * q.numel() + 2 * live * KV_HEADS * HEAD_DIM)
              + 4 * (bt.numel() + sl.numel()))
    flops = 4.0 * live * HEADS * HEAD_DIM
    bms, by = bound_ms(nbytes, flops, dtype)
    results.append(dict(
        kernel="paged_attention", dtype=DTYPE_NAME[dtype],
        seq_lens=seq_lens, max_err=err, tol=TOL[dtype],
        kernel_ms=time_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
        plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kp, vp, bt, sl)),
        library_ms=lib, bound_ms=bms, bound_by=by))


def block_weights(gen, dtype, device):
    """One 7B decoder layer's weights, (in, out) layout, scaled so the
    activations stay below 2 in magnitude, where one bf16 rounding step
    (2^-7 .. 2^-6) stays inside the bf16 tolerance."""
    from paddle_tpu_torch.kernels.fused_block_decode import BlockDecodeWeights
    qd, kd = HEADS * HEAD_DIM, KV_HEADS * HEAD_DIM

    def mat(k, n):
        return _rand(gen, (k, n), dtype, device, 0.5 / math.sqrt(k))

    def norm():
        return (1.0 + 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
                ).to(dtype)

    return BlockDecodeWeights(
        ln1=norm(), wq=mat(HIDDEN, qd), wk=mat(HIDDEN, kd),
        wv=mat(HIDDEN, kd), wo=mat(qd, HIDDEN), ln2=norm(),
        wg=mat(HIDDEN, INTER), wu=mat(HIDDEN, INTER), wd=mat(INTER, HIDDEN))


def check_fused_block_decode(dtype, device, results):
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    # tokens already in the pool (1023, 517, 78 at 7B), one idle row
    seq_lens = [MAX_SEQ - 1, MAX_SEQ // 2 + 5, MAX_SEQ // 13, 0]
    bt, num_pages = _block_tables(seq_lens, 1, device)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
    kp, vp = _rand(gen, shape, dtype, device), _rand(gen, shape, dtype, device)
    w = block_weights(gen, dtype, device)
    x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    kk, vk = kp.clone(), vp.clone()
    got, kk, vk = fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)
    kr, vr = kp.clone(), vp.clone()
    want, kr, vr = fb.fused_block_decode_ref(x, w, kr, vr, bt, sl, **kw)
    torch.cuda.synchronize()
    err = max(max_err(got, want), max_err(kk, kr), max_err(vk, vr))
    require(err <= TOL[dtype], f"fused_block_decode {dtype}: max err {err}")
    elem = x.element_size()
    wbytes = sum(t.numel() for t in w) * elem
    live = sum(seq_lens)
    nbytes = (wbytes + elem * (2 * x.numel()
                               + 2 * (live + BATCH) * KV_HEADS * HEAD_DIM)
              + 4 * (bt.numel() + sl.numel()))
    mats = sum(t.numel() for t in w if t.dim() == 2)
    flops = (2.0 * BATCH * mats
             + 4.0 * (live + BATCH) * HEADS * HEAD_DIM)
    bms, by = bound_ms(nbytes, flops, dtype)
    results.append(dict(
        kernel="fused_block_decode", dtype=DTYPE_NAME[dtype],
        seq_lens=seq_lens, max_err=err, tol=TOL[dtype],
        kernel_ms=time_ms(lambda: fb.fused_block_decode(
            x, w, kk, vk, bt, sl, **kw)),
        plain_ms=time_ms(lambda: fb.fused_block_decode_ref(
            x, w, kr, vr, bt, sl, **kw), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by))


# ----------------------------------------------------------------- serve
def prompts(vocab: int, lens) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def serve(model, fused: bool, new_tokens: int, lens, record_logits=False):
    """One engine run over ``lens`` prompts, half submitted up front and
    the rest mid-run. Returns (engine, [(rid, prompt, tokens)], seconds,
    launch counts)."""
    from paddle_tpu_torch import flags, kernels
    from paddle_tpu_torch.generation.serving import ServingEngine
    flags.set_flags({"fused_block_decode": fused})
    eng = ServingEngine(model, max_batch=BATCH, page_size=PAGE,
                        max_seq_len=MAX_SEQ, record_logits=record_logits)
    require((eng._spec is not None) == fused, "decode route not as asked")
    # warm-up request (first-call costs: library loads, cuBLAS handles)
    eng.submit(prompts(model.config.vocab_size, (9,))[0], 2)
    eng.run()
    eng.decode_step_seconds.clear()
    eng.prefill_seconds.clear()
    eng.ttft_seconds.clear()
    eng.logits.clear()
    ps = prompts(model.config.vocab_size, lens)
    half = len(ps) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in ps[:half]]
    for _ in range(6):
        eng.step()
    rids += [eng.submit(p, new_tokens) for p in ps[half:]]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    flags.reset_flags()
    return (eng, [(r, ps[i], out[r]) for i, r in enumerate(rids)],
            seconds, counts)


def run_serve(device):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             generator=seed(SEED, device))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers = cfg.num_hidden_layers
    counts_by_mode = {}
    for fused in (True, False):
        eng, res, seconds, counts = serve(model, fused, NEW_TOKENS,
                                          PROMPT_LENS)
        for _, prompt, toks in res:
            require(len(toks) == NEW_TOKENS,
                    f"request of {len(prompt)} tokens returned {len(toks)}")
            require(all(0 <= t < cfg.vocab_size for t in toks),
                    "token out of the vocabulary")
        steps = len(eng.decode_step_seconds)
        want_prefill = layers * len(PROMPT_LENS)
        require(counts["flash_prefill"] == want_prefill,
                f"flash_prefill ran {counts['flash_prefill']} times, "
                f"want {want_prefill}")
        if fused:
            require(counts["fused_block_decode"] == layers * steps,
                    f"fused_block_decode ran {counts['fused_block_decode']}"
                    f" times over {steps} steps")
            require(counts["paged_attention"] == 0, "paged_attention ran "
                    "in the fused run")
        else:
            require(counts["paged_attention"] == layers * steps,
                    f"paged_attention ran {counts['paged_attention']} "
                    f"times over {steps} steps")
            require(counts["fused_block_decode"] == 0,
                    "fused_block_decode ran in the generic run")
        counts_by_mode[fused] = counts
        gen = sum(len(t) for _, _, t in res)
        emit("serve", model="llama2_7b", layers=layers, dtype="bf16",
             decode="fused" if fused else "generic",
             requests=len(res), prompt_lens=list(PROMPT_LENS),
             new_tokens=NEW_TOKENS, generated=gen, seconds=seconds,
             tokens_per_s=gen / seconds,
             ttft_ms_median=1e3 * float(np.median(eng.ttft_seconds)),
             ttft_ms_max=1e3 * float(np.max(eng.ttft_seconds)),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             launches=counts, model_build_s=build_s,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    torch.cuda.empty_cache()
    return counts_by_mode


# ---------------------------------------------------------------- parity
def run_parity(device):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                             generator=seed(SEED + 7, device))
    for fused in (True, False):
        eng, res, _, _ = serve(model, fused, PARITY_NEW_TOKENS, PARITY_LENS,
                               record_logits=True)
        worst, checked, skipped = 0.0, 0, 0
        for rid, prompt, toks in res:
            rows = torch.from_numpy(np.stack(eng.logits[rid])).to(device)
            ids = torch.from_numpy(np.concatenate(
                [prompt, np.asarray(toks[:-1], np.int32)]).astype(np.int64))
            with torch.inference_mode():
                ref = model(ids[None].to(device))[0, len(prompt) - 1:].float()
            require(ref.shape == rows.shape, "parity: logits shape")
            require(bool(torch.isfinite(rows).all()), "parity: non-finite")
            worst = max(worst, max_err(rows, ref))
            top2 = ref.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > PARITY_TOL
            ref_tok = ref.argmax(-1).cpu().numpy()
            for j, tok in enumerate(toks):
                if bool(decided[j]):
                    require(int(ref_tok[j]) == tok,
                            f"parity: token {j} of request {rid}: engine "
                            f"{tok}, reference {int(ref_tok[j])}")
                    checked += 1
                else:
                    skipped += 1
        require(worst <= PARITY_TOL, f"parity: logits err {worst} > "
                f"{PARITY_TOL}")
        emit("parity", model="llama2_7b width, 2 layers", dtype="fp32",
             decode="fused" if fused else "generic", requests=len(res),
             max_logit_err=worst, tol=PARITY_TOL, tokens_checked=checked,
             tokens_within_tol_gap=skipped)
    del model
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    emit("build", seconds=_build.build_all(),
         libraries=sorted(_build.sources()), dir=str(_build.build_dir()))

    results = []
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_prefill(dtype, device, results)
        check_paged_attention(dtype, device, results)
        check_fused_block_decode(dtype, device, results)
    for r in results:
        emit("kernels", **r)

    counts = run_serve(device)
    run_parity(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    summary = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in results if r["kernel"] == name
                and r["dtype"] == "bf16" and "kernel_ms" in r]
        main_row = rows[-1]          # the largest serving shape in bf16
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[True][name] + counts[False][name],
            max_abs_err=max(r["max_err"] for r in rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
