#!/usr/bin/env python3
"""Drive the PyTorch port's Llama serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):
  1. build    compile every kernel in paddle_tpu_torch/kernels/csrc with
              nvcc (sm_90a) into build/kernels/, and time it;
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version on the card at the serving path's Llama-2-7B shapes,
              in bf16 (2e-2 abs; the chunk attention 1e-3 + one bf16 ulp
              of the plain output) and fp32 (1e-4 abs), and time the kernel,
              the plain version, one library call where PyTorch has one,
              and the card's least time for the same work (bound; the
              prefill, decode and chunk rows also give bound_frac, bound /
              kernel time). The decode attention and the one-layer and
              N-layer fused decode run at serve's ragged lengths (one idle
              row) and at serve_long's decode contexts (3500/2900/1800/700
              of a 4096-token table), with device_ms from calls replayed
              from a CUDA graph; the chunk
              attention a 256-token chunk from
              start 3328 and a ragged 100-token final chunk, each with a
              spread and a peaked softmax; the N-layer decode a group of
              4 layers, also held bit for bit to 4 launches of the
              one-layer kernel and timed beside them. Every kernel with
              an int8-pool variant (decode, chunk, one-layer and N-layer
              decode attention) runs it on the
              same pools quantized (decode and chunk held to 1e-5 in fp32
              and 1e-3 + one bf16 ulp in bf16; the fused kernels to their
              native tolerance, the one-layer kernel's appended int8 rows
              within one payload step and SCALE_RTOL of the plain rows, the
              N-layer one bit for bit to 4 int8 one-layer launches), and the
              N-layer decode also runs int4 weights on native and int8
              pools;
  3. serve    Llama-2-7B (32 layers, bf16, random weights from a seed)
              through ServingEngine: 8 requests of at most 256 tokens, 32
              new tokens each, some submitted mid-run, with fused block
              decode, with the generic decode, with the generic decode on
              an int8 pool, and 4 layers a launch on an int8 pool and with
              int4 weights; the kernel launch counters show which kernels
              (and variants) each run went through, exactly;
     serve_long
              the same model with a 4096-token context: 8 prompts of 40 to
              3500 tokens (the long ones prefilled in 256-token chunks
              between decode steps), half submitted mid-run, 32 new tokens
              each, with one fused kernel per layer and one per group of 4
              layers (FLAGS_fused_block_layers=4) on the native pool (the
              streams must be identical), then one per layer on an int8
              pool and one per group on an int8 pool with int4 weights
              (the first tokens must be identical); launch counts exact;
  4. parity   the same engine in fp32 at full width with 2 layers, prompts
              of 17 to 700 tokens (two of them chunked), its per-token
              logits held against a teacher-forced no-cache forward of the
              model on the card, with fused decode one layer and two
              layers a launch, and with the generic decode. That forward
              runs the flash-attention forward kernel, which train_kernels
              holds to its plain version;
  5. train_kernels
              the training attention kernels (forward, dq, dk/dv) against
              autograd of the dense flash_attention_ref on the card, causal,
              at Llama-2-7B heads (S=4096), Llama-2-70B heads (GQA, S=2048)
              and a ragged length (S=1000), bf16 (out within 1e-3 + one
              bf16 ulp of the reference, lse 1e-3, grads 2e-2 of their
              largest element) and fp32 (1e-4 each), with kernel, plain,
              library (SDPA forward, forward + backward, and its backward
              alone) and bound times (forward, dq and dk/dv also
              bound_frac); then flash_attention_with_lse at the 7B and
              70B head shapes, bf16 and fp32: out, lse and dq/dk/dv under
              a seeded (dO, dlse) against autograd of the plain forward
              (the same tolerances), each kernel launched once; two
              non-causal calls over the halves of the keys merged in log
              space against the whole call (out 2e-3 bf16 / 1e-4 fp32
              abs, lse as above); with_lse forward and forward + backward
              timed beside flash_attention's on the same shape;
  6. train    Llama-2-7B width cut to 8 layers, bf16 with f32 masters,
              TrainStep(grad_accum_steps=2) + AdamW + global-norm clip +
              warmup/cosine LR, 5 steps on one fixed batch of 2 x 4096
              tokens: finite, falling losses, each flash kernel launched
              8 layers x 2 micro-batches x 5 steps = 80 times;
     train_remat
              the same model, batch and trainer with remat=True: the first
              step's gradients equal (bit for bit) to the same step
              without remat, then 5 steps timed as train, with a lower
              peak memory than train's and the forward kernel launched
              twice a layer and micro-batch (160), dq and dk/dv 80;
     fit      the slice's main path: Model.fit on the same width and
              depth, amp.decorate(O2, bf16) without f32 masters (its two
              checkpoints must stay within what a call may write), AdamW over
              two parameter groups with no decay on the norms,
              warmup/cosine LR, global-norm clip and
              LlamaPretrainingCriterion, over a DataLoader of 16 seeded
              4096-token rows (batch 2, shuffled under a seed, split in 2
              micro-batches, prefetched to the card), 6 steps, the loss
              pulled every 2 steps, with the LRScheduler, EarlyStopping
              and ModelCheckpoint callbacks (under build/fit_ckpt, removed
              after): finite losses, the first equal to a bare
              TrainStep's on the same first batch, each flash kernel
              launched 96 times, the final checkpoint loading back into a
              fresh model with equal parameters; step time on the card's
              clock beside a bare TrainStep loop's on the same batches,
              tokens/s, MFU, peak memory and the host's share of time
              blocked on loss reads;
  7. train_parity
              one fp32 TrainStep at full width, 2 layers, S=512 on the card
              (kernels) and on a CPU copy (plain versions): losses and every
              gradient before the update agree;
  8. train_varlen
              packed-sequence training and the fused RMSNorm, bf16, through
              the public entry points with the launch counts read around
              them (exact): fused_rms_norm with a residual, forward and
              backward, at 8192 x 4096 (7B) and 4096 x 8192 (70B);
              flash_attn_unpadded, forward and backward, on an 8192-token
              pack of 6 documents at Llama-2-7B heads and a 4096-token pack
              of 4 at Llama-2-70B heads (GQA); variable_length_memory_
              efficient_attention forward at B=4, S=2048, ragged lengths.
              The packs are held document by document to the plain causal
              attention of each document alone, the RMSNorm to autograd of
              its plain twin. Then each kernel (RMSNorm forward and dx, the
              segment-id variants of the flash kernels) against its plain
              twin on the same card tensors, bf16 and fp32 (the flash twins
              in groups of kv heads, so the dense f32 scores stay small),
              with kernel, plain, library (torch.nn.functional.rms_norm;
              SDPA per document, summed) and bound times (the flash
              kernels also bound_frac).
Then the card's name and power limit (nvidia-smi), the per-kernel summary
line, and as the last line {"ok": true, "device": {...}}.

Without a CUDA card the script exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
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
# serve_long: the model's whole context, the default 256-token chunk
LONG_MAX_SEQ, CHUNK = 4096, 256
LONG_PROMPT_LENS = (3500, 40, 1800, 257, 700, 120, 2900, 512)
# the decode contexts of serve_long's four long prompts (one batch slot each)
LONG_DECODE_LENS = (3500, 2900, 1800, 700)
GROUP_LAYERS = 4                  # FLAGS_fused_block_layers of the N run
# chunk attention: (start, S) of the main chunk and of a ragged final one
CHUNK_SHAPES = ((3840, 100), (3328, 256))
# and a second query, 8x the first: logits spread ~8, so a few keys carry
# each row's softmax and the outputs are O(1) (at spread 1 over ~3.4 k keys
# they are ~0.03), where one key masked or paged wrongly shows
PEAKED_Q = 8.0
PARITY_LENS, PARITY_NEW_TOKENS = (17, 77, 130, 256, 300, 700), 8
PARITY_TOL = 1e-3      # fp32 logits: kernel sums vs torch.matmul order

# training attention: (case, batch, S, heads, kv heads), head_dim 128
TRAIN_SHAPES = (("llama2_7b heads", 1, 4096, 32, 32),
                ("llama2_70b heads, GQA", 1, 2048, 64, 8),
                ("ragged, GQA", 2, 1000, 32, 8))
# flash forward: out within atol + rtol |ref| elementwise (rtol: one bf16
# ulp, as both sides round the same f32 value), the f32 lse within abs
OUT_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7), torch.float32: (1e-4, 0.0)}
# the int8-pool attention kernels against their plain versions on the same
# pool bits (the dequantized values are identical; only sums differ)
QUANT_OUT_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7),
                 torch.float32: (1e-5, 0.0)}
# a new token's appended int8 row, kernel vs plain: the two f32 k/v may
# differ in the last bits (another summation order), so a payload may
# differ by 1 and a scale by relative 1e-6; in bf16 the row is quantized
# from bf16 k/v, where such a difference can become one bf16 step of the
# row's amax (2^-8 relative)
SCALE_RTOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-6}
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # max|a-b|/max|b|
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 8, 4096, 2, 2
TRAIN_STEPS = 5
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 512
TRAIN_PARITY_LOSS_TOL = 1e-4    # relative, fp32 (TF32 off)
TRAIN_PARITY_GRAD_TOL = 1e-3    # relative L2 per parameter
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# flash_attention_with_lse: the Llama-2-7B and Llama-2-70B head shapes; the
# log-space merge of two half-key calls against the whole call, abs
WITH_LSE_SHAPES = TRAIN_SHAPES[:2]
MERGE_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# fit: Model.fit at the train phase's width and depth over a DataLoader of
# seeded 4096-token rows, batch 2 split in 2 micro-batches, 6 steps
FIT_ROWS, FIT_BATCH, FIT_ACCUM, FIT_STEPS, FIT_METRICS_EVERY = 16, 2, 2, 6, 2
FIT_CKPT_DIR = "build/fit_ckpt"
# train_varlen: fused RMSNorm (case, rows, width), eps of Llama-2
RMS_SHAPES = (("llama2_7b width", 8192, 4096),
              ("llama2_70b width", 4096, 8192))
RMS_EPS = 1e-5
# packed documents through flash_attn_unpadded: (case, lengths, H, Hkv)
VARLEN_PACKS = (("llama2_7b heads, 8192-token pack",
                 (3500, 2900, 1000, 700, 75, 17), 32, 32),
                ("llama2_70b heads, 4096-token pack, GQA",
                 (2000, 1500, 300, 296), 64, 8))
# variable_length_memory_efficient_attention: B x S at 7B heads
VLMEA_LENS, VLMEA_SEQ = (2048, 1500, 700, 33), 2048
PLAIN_KV_GROUPS = 8     # the dense twins run over 8 slices of the kv heads
VARLEN_KERNELS = ("rms_norm_fwd", "rms_norm_bwd_dx",
                  "flash_attention_fwd_seg", "flash_attention_bwd_dq_seg",
                  "flash_attention_bwd_dkv_seg")

# the quantized variants of a kernel: an int8 KV pool, int4 weight tiles
# and the flash kernels' segment-id variant
VARIANTS = {"paged_attention": ("int8",), "paged_chunk_attention": ("int8",),
            "fused_block_decode": ("int8",),
            "fused_multi_block_decode": ("int8", "int4", "int8_int4"),
            "flash_attention_fwd": ("seg",),
            "flash_attention_bwd_dq": ("seg",),
            "flash_attention_bwd_dkv": ("seg",)}
SOURCES = {
    "flash_prefill": ("paddle_tpu_torch/kernels/csrc/flash_prefill.cu",
                      "paddle_tpu/kernels/decode_attention.py:140"),
    "paged_attention": ("paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                        "paddle_tpu/kernels/paged_attention.py:154"),
    "paged_chunk_attention": (
        "paddle_tpu_torch/kernels/csrc/paged_chunk_attention.cu",
        "paddle_tpu/kernels/paged_attention.py:311"),
    "fused_block_decode": (
        "paddle_tpu_torch/kernels/csrc/fused_block_decode.cu",
        "paddle_tpu/kernels/fused_block_decode.py:265"),
    "fused_multi_block_decode": (
        "paddle_tpu_torch/kernels/csrc/fused_multi_block_decode.cu",
        "paddle_tpu/kernels/fused_block_decode.py:903"),
    "flash_attention_fwd": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:253"),
    "flash_attention_bwd_dq": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:453"),
    "flash_attention_bwd_dkv": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:486"),
    "rms_norm_fwd": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:46"),
    "rms_norm_bwd_dx": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                        "paddle_tpu/kernels/rms_norm.py:53"),
}
# each variant is a branch of its kernel's source and of its TPU kernel
SOURCES = {name: entry for base, src in SOURCES.items()
           for name, entry in [(base, src)] + [
               (f"{base}_{v}", src) for v in VARIANTS.get(base, ())]}


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


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph and replayed, so the host's enqueue cost is
    left out (a kernel of a few tens of microseconds is otherwise timed at
    the pace of the host's Python)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, iters=reps, warmup=2) / calls


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
    return float((a.detach().float() - b.detach().float()).abs().max())


def excess(a: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """The largest amount by which |a - ref| exceeds rtol |ref|, held to
    an atol (OUT_TOL's elementwise check)."""
    ref = ref.detach().float()
    return float(((a.detach().float() - ref).abs() - rtol * ref.abs()).max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def quantized(pool):
    """A native pool, quantized per row into an int8 QuantizedPages."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    return pa.QuantizedPages(*pa.quantize_kv_rows(pool))


def clone_pool(pool):
    if isinstance(pool, torch.Tensor):
        return pool.clone()
    return type(pool)(pool.q.clone(), pool.scale.clone())


def row_bytes(quant: bool, elem: int) -> int:
    """Bytes of one stored k or v row: D + 4 (int8 + f32 scale) or D elem."""
    return HEAD_DIM + 4 if quant else HEAD_DIM * elem


def rows_differ(got, want, dtype, what):
    """Appended int8 rows, kernel vs plain: payload within 1, scales within
    SCALE_RTOL; returns how many payload and scale elements differ."""
    dq = (got.q.int() - want.q.int()).abs()
    rel = ((got.scale - want.scale).abs()
           / want.scale.abs().clamp_min(1e-30))
    require(int(dq.max()) <= 1, f"{what}: payload off by {int(dq.max())}")
    require(float(rel.max()) <= SCALE_RTOL[dtype],
            f"{what}: scale off by {float(rel.max())} relative")
    return int((dq > 0).sum()), int((rel > 0).sum())


# --------------------------------------------------------------- kernels
def _rand(gen, shape, dtype, device, scale=1.0):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * scale).to(dtype)


def _block_tables(seq_lens, extra_tokens, device, max_seq=MAX_SEQ):
    """Shuffled block tables over a pool whose page 0 is the null page;
    an idle row (seq_len 0) keeps an all-zero table."""
    maxp = -(-max_seq // PAGE)
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
        kms = time_ms(lambda: da.flash_prefill(q, k, v, s))
        results.append(dict(
            kernel="flash_prefill", dtype=DTYPE_NAME[dtype], S=s,
            max_err=err, tol=TOL[dtype], kernel_ms=kms,
            plain_ms=time_ms(lambda: da.flash_prefill_ref(q, k, v, s)),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
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


# paged_attention's shapes: (case, seq_lens, the table's max_seq); at
# serve_long's decode contexts the split-KV walk has the most parts to fill
PAGED_SHAPES = (("serve", (MAX_SEQ, MAX_SEQ // 2 + 5, MAX_SEQ // 13 + 1, 0),
                 MAX_SEQ),
                ("serve_long decode", LONG_DECODE_LENS, LONG_MAX_SEQ))


def check_paged_attention(dtype, device, results):
    """The split-KV decode attention on native and int8 pools against its
    plain version, at serve's ragged lengths (1024, 517, 79 at 7B, one
    idle row) and at serve_long's decode contexts; SDPA over the gathered
    pool (native) and the bytes bound beside each, and bound_frac. Besides
    the back-to-back times (the host's pace at these sizes), device_ms
    replays the kernel's and SDPA's calls from a CUDA graph."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    for case, seq_lens, max_seq in PAGED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = _block_tables(seq_lens, 0, device, max_seq)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        idle = sl == 0
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        kp, vp = (_rand(gen, shape, dtype, device) for _ in range(2))
        q = _rand(gen, (BATCH, HEADS, HEAD_DIM), dtype, device)
        got = pa.paged_attention(q, kp, vp, bt, sl)
        want = pa.paged_attention_ref(q, kp, vp, bt, sl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= TOL[dtype], f"paged_attention {case} {dtype}: max "
                f"err {err}")
        require(not got[idle].any(), "paged_attention: idle row must read "
                "zeros")
        # library yardstick: SDPA over the gathered contiguous view
        t = bt.shape[1] * PAGE
        kg, vg = (x[:, bt.long()].movedim(1, 0).reshape(
            BATCH, KV_HEADS, t, HEAD_DIM) for x in (kp, vp))
        mask = (torch.arange(t, device=device)[None, :] < sl[:, None])
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        lib = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
        elem = q.element_size()
        live = sum(seq_lens)
        index_bytes = 4 * (bt.numel() + sl.numel())
        nbytes = (elem * (2 * q.numel() + 2 * live * KV_HEADS * HEAD_DIM)
                  + index_bytes)
        flops = 4.0 * live * HEADS * HEAD_DIM
        bms, by = bound_ms(nbytes, flops, dtype)
        kms = time_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl))
        dev_ms = dict(
            kernel=graph_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
            library=graph_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)))
        del kg, vg
        results.append(dict(
            kernel="paged_attention", dtype=DTYPE_NAME[dtype], case=case,
            seq_lens=seq_lens, max_err=err, tol=TOL[dtype], kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kp, vp, bt,
                                                            sl)),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dev_ms))
        # the int8 pool: the same rows quantized, kernel vs plain on its bits
        kq, vq = quantized(kp), quantized(vp)
        got = pa.paged_attention(q, kq, vq, bt, sl)
        want = pa.paged_attention_ref(q, kq, vq, bt, sl)
        torch.cuda.synchronize()
        atol, rtol = QUANT_OUT_TOL[dtype]
        err, over = max_err(got, want), excess(got, want, rtol)
        require(over <= atol, f"paged_attention int8 {case} {dtype}: {over} "
                f"over {rtol} |ref|, max err {err}")
        require(not got[idle].any(), "paged_attention int8: idle row must "
                "read 0")
        nbytes = (elem * 2 * q.numel()
                  + 2 * live * KV_HEADS * row_bytes(True, 0) + index_bytes)
        bms, by = bound_ms(nbytes, flops, dtype)
        kms = time_ms(lambda: pa.paged_attention(q, kq, vq, bt, sl))
        results.append(dict(
            kernel="paged_attention_int8", dtype=DTYPE_NAME[dtype],
            case=case, seq_lens=seq_lens, max_err=err, excess=over,
            atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kq, vq, bt,
                                                            sl)),
            library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dict(kernel=graph_ms(
                lambda: pa.paged_attention(q, kq, vq, bt, sl)))))
        del kp, vp, kq, vq
        torch.cuda.empty_cache()


def check_paged_chunk_attention(dtype, device, results):
    """A prefill chunk at Llama-2-7B heads against the 4096-token table of
    serve_long: its k/v written first (write-then-attend), then the kernel
    against the plain version for a spread and a peaked softmax, each
    within OUT_TOL elementwise (in bf16 1e-3 + one bf16 ulp of the plain
    output), SDPA on the gathered prefix with an explicit bottom-right
    causal mask, and the bound."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    bt, num_pages = _block_tables([LONG_MAX_SEQ], 0, device, LONG_MAX_SEQ)
    shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
    for start, s in CHUNK_SHAPES:
        kp, vp = (_rand(gen, shape, dtype, device) for _ in range(2))
        st = torch.tensor([start], dtype=torch.int32, device=device)
        k_new, v_new = (_rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
                        for _ in range(2))
        pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
        q = _rand(gen, (1, s, HEADS, HEAD_DIM), dtype, device)
        atol, rtol = OUT_TOL[dtype]
        errs, over = {}, {}
        for case, qc in (("spread", q), ("peaked", q * PEAKED_Q)):
            got = pa.paged_chunk_attention(qc, kp, vp, bt, st)
            want = pa.paged_chunk_attention_ref(qc, kp, vp, bt, st)
            torch.cuda.synchronize()
            errs[case], over[case] = max_err(got, want), excess(got, want,
                                                                rtol)
            require(over[case] <= atol, f"paged_chunk_attention start="
                    f"{start} S={s} {dtype} {case}: {over[case]} over "
                    f"{rtol} |ref|, max err {errs[case]}")
        t = start + s
        kg, vg = (p[:, bt[0].long()].reshape(KV_HEADS, -1, HEAD_DIM)
                  [None, :, :t] for p in (kp, vp))
        mask = (torch.arange(t, device=device)[None, :]
                <= start + torch.arange(s, device=device)[:, None])
        qt = q.transpose(1, 2)
        lib = time_ms(lambda: sdpa(qt, kg, vg, attn_mask=mask))
        elem = q.element_size()
        nbytes = (elem * (2 * q.numel() + 2 * t * KV_HEADS * HEAD_DIM)
                  + 4 * (bt.numel() + 1))
        pairs = s * start + s * (s + 1) // 2     # (query, key) pairs seen
        bms, by = bound_ms(nbytes, 4.0 * pairs * HEADS * HEAD_DIM, dtype)
        kms = time_ms(lambda: pa.paged_chunk_attention(q, kp, vp, bt, st))
        results.append(dict(
            kernel="paged_chunk_attention", dtype=DTYPE_NAME[dtype],
            start=start, S=s, max_err=max(errs.values()),
            max_err_spread=errs["spread"], max_err_peaked=errs["peaked"],
            excess=max(over.values()), atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_ref(
                q, kp, vp, bt, st), iters=5, warmup=1),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
        # the int8 pool: the written pool quantized, kernel vs plain on its
        # bits, spread and peaked
        kq, vq = quantized(kp), quantized(vp)
        del kp, vp, kg, vg
        atol, rtol = QUANT_OUT_TOL[dtype]
        for case, qc in (("spread", q), ("peaked", q * PEAKED_Q)):
            got = pa.paged_chunk_attention(qc, kq, vq, bt, st)
            want = pa.paged_chunk_attention_ref(qc, kq, vq, bt, st)
            torch.cuda.synchronize()
            errs[case], over[case] = max_err(got, want), excess(got, want,
                                                                rtol)
            require(over[case] <= atol, f"paged_chunk_attention int8 start="
                    f"{start} S={s} {dtype} {case}: {over[case]} over "
                    f"{rtol} |ref|, max err {errs[case]}")
        nbytes = (elem * 2 * q.numel() + 2 * t * KV_HEADS
                  * row_bytes(True, 0) + 4 * (bt.numel() + 1))
        bms, by = bound_ms(nbytes, 4.0 * pairs * HEADS * HEAD_DIM, dtype)
        kms = time_ms(lambda: pa.paged_chunk_attention(q, kq, vq, bt, st))
        results.append(dict(
            kernel="paged_chunk_attention_int8", dtype=DTYPE_NAME[dtype],
            start=start, S=s, max_err=max(errs.values()),
            max_err_spread=errs["spread"], max_err_peaked=errs["peaked"],
            excess=max(over.values()), atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_ref(
                q, kq, vq, bt, st), iters=5, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
        del kq, vq
        torch.cuda.empty_cache()


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


def weight_bytes(weights) -> int:
    """Stored bytes of a layer's or a group's weights (tensors or int4
    tiles: packed payload and f32 tile scales)."""
    from paddle_tpu_torch.kernels.fused_block_decode import Int4Tiles
    return sum(t.q.numel() + 4 * t.scale.numel() if isinstance(t, Int4Tiles)
               else t.numel() * t.element_size() for t in weights)


def block_bytes(weights, layers, x, live, quant) -> float:
    """Least bytes of a decode step of ``layers`` layers: the weights and x
    read once, out written once, each layer's live k and v rows read and
    the new ones written once."""
    elem = x.element_size()
    return (weight_bytes(weights) + elem * 2 * x.numel()
            + layers * 2 * (live + BATCH) * KV_HEADS * row_bytes(quant, elem))


def pool_err(a, b) -> float:
    """Max abs difference of two pools' values; for int8 pools beyond one
    quantization step of the row (the larger of the two scales)."""
    if isinstance(a, torch.Tensor):
        return max_err(a, b)
    diff = (a.q.float() * a.scale - b.q.float() * b.scale).abs()
    return float((diff - torch.maximum(a.scale, b.scale)).clamp_min(0).max())


def pool_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)


# the fused decode rows: (case, tokens already in the pool, table width):
# serve's (1023, 517, 78 at 7B, one idle row) and serve_long's decode
# contexts in its 4096-token table
FUSED_SHAPES = (("serve", (MAX_SEQ - 1, MAX_SEQ // 2 + 5, MAX_SEQ // 13, 0),
                 MAX_SEQ),
                ("serve_long decode", LONG_DECODE_LENS, LONG_MAX_SEQ))


def check_fused_block_decode(dtype, device, results):
    """The one-layer kernel on a native and on an int8 pool at FUSED_SHAPES:
    output within TOL of the plain version, the appended rows as the plain
    version's (an int8 row within one payload step and SCALE_RTOL); the
    bound and bound_frac beside each, and device_ms from a CUDA graph."""
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    w = None
    for case, seq_lens, max_seq in FUSED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = _block_tables(seq_lens, 1, device, max_seq)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        kp, vp = (_rand(gen, shape, dtype, device),
                  _rand(gen, shape, dtype, device))
        if w is None:
            w = block_weights(gen, dtype, device)
            x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
        live = sum(seq_lens)
        mats = sum(t.numel() for t in w if t.dim() == 2)
        flops = (2.0 * BATCH * mats
                 + 4.0 * (live + BATCH) * HEADS * HEAD_DIM)
        for quant in (False, True):
            pools = (quantized(kp), quantized(vp)) if quant else (kp, vp)
            kk, vk = (clone_pool(t) for t in pools)
            got, kk, vk = fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)
            kr, vr = (clone_pool(t) for t in pools)
            want, kr, vr = fb.fused_block_decode_ref(x, w, kr, vr, bt, sl,
                                                     **kw)
            torch.cuda.synchronize()
            name = "fused_block_decode" + ("_int8" if quant else "")
            err = max_err(got, want)
            extra = {}
            if quant:
                for half, a, b in (("k", kk, kr), ("v", vk, vr)):
                    nq, ns = rows_differ(a, b, dtype,
                                         f"{name} {case} {dtype} {half}")
                    extra[f"{half}_payload_diffs"] = nq
                    extra[f"{half}_scale_diffs"] = ns
                extra["scale_rtol"] = SCALE_RTOL[dtype]
            else:
                err = max(err, max_err(kk, kr), max_err(vk, vr))
            require(err <= TOL[dtype], f"{name} {case} {dtype}: max err "
                    f"{err}")
            nbytes = (block_bytes(w, 1, x, live, quant)
                      + 4 * (bt.numel() + sl.numel()))
            bms, by = bound_ms(nbytes, flops, dtype)

            def call():
                fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)

            kms = time_ms(call)
            results.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                seq_lens=seq_lens, max_err=err, tol=TOL[dtype], **extra,
                kernel_ms=kms,
                plain_ms=time_ms(lambda: fb.fused_block_decode_ref(
                    x, w, kr, vr, bt, sl, **kw), iters=5),
                library_ms=None, bound_ms=bms, bound_by=by,
                bound_frac=bms / kms,
                device_ms=dict(kernel=graph_ms(call, calls=5, reps=4))))
            del kk, vk, kr, vr, pools
        del kp, vp
        torch.cuda.empty_cache()


def check_fused_multi_block_decode(dtype, device, results):
    """A group of 4 Llama-2-7B layers at #3's FUSED_SHAPES: the N-layer
    kernel against the plain version for native and int8 pools and native
    and int4 weights; with native weights also bit for bit against 4
    launches of the one-layer kernel on the same kind of pool, timed beside
    them; bound and bound_frac beside each row."""
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    layers = None
    for case, seq_lens, max_seq in FUSED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = _block_tables(seq_lens, 1, device, max_seq)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        pools = [(_rand(gen, shape, dtype, device),
                  _rand(gen, shape, dtype, device))
                 for _ in range(GROUP_LAYERS)]
        qpools = [(quantized(k), quantized(v)) for k, v in pools]
        if layers is None:
            layers = [block_weights(gen, dtype, device)
                      for _ in range(GROUP_LAYERS)]
            stacks = {"native": fb.stack_block_weights(layers),
                      "int4": fb.stack_block_weights(layers,
                                                     weight_dtype="int4")}
            x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
        live = sum(seq_lens)
        mats = (sum(t.numel() for t in layers[0] if t.dim() == 2)
                * GROUP_LAYERS)
        flops = (2.0 * BATCH * mats
                 + GROUP_LAYERS * 4.0 * (live + BATCH) * HEADS * HEAD_DIM)
        for quant, wdt in ((False, "native"), (True, "native"),
                           (False, "int4"), (True, "int4")):
            results.append(_check_group(fb, case, dtype, x, layers,
                                        stacks[wdt], wdt, quant,
                                        qpools if quant else pools, bt, sl,
                                        kw, seq_lens, live, flops))
        del pools, qpools
        torch.cuda.empty_cache()
    del layers, stacks
    torch.cuda.empty_cache()


def _check_group(fb, case, dtype, x, layers, mw, wdt, quant, group, bt, sl,
                 kw, seq_lens, live, flops) -> dict:
    """One N-layer variant at one FUSED_SHAPES case (see
    check_fused_multi_block_decode): its result row."""
    def fresh():
        return ([clone_pool(k) for k, _ in group],
                [clone_pool(v) for _, v in group])

    tags = [t for t, on in (("int8", quant), ("int4", wdt == "int4")) if on]
    name = "_".join(["fused_multi_block_decode"] + tags)
    got, gk, gv = fb.fused_multi_block_decode(x, mw, *fresh(), bt, sl, **kw)
    want, wk, wv = fb.fused_multi_block_decode_ref(x, mw, *fresh(), bt, sl,
                                                   **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    row = dict(kernel=name, dtype=DTYPE_NAME[dtype], case=case,
               layers=GROUP_LAYERS, seq_lens=seq_lens, tol=TOL[dtype])
    # past the first layer the kernel's and the plain version's inputs
    # differ by the earlier layers' rounding: the pools are held to the
    # output's tolerance, an int8 row's values beyond one quantization
    # step of the row (a payload one step apart)
    for i in range(GROUP_LAYERS):
        err = max(err, pool_err(gk[i], wk[i]), pool_err(gv[i], wv[i]))
    require(err <= TOL[dtype], f"{name} {case} {dtype}: max err {err}")
    if wdt == "native":
        # the same pools through 4 launches of the one-layer kernel
        out, ck, cv = x, *fresh()
        for i, w in enumerate(layers):
            out, ck[i], cv[i] = fb.fused_block_decode(
                out, w, ck[i], cv[i], bt, sl, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, out) and all(
            pool_equal(a, b) for a, b in zip(gk + gv, ck + cv))
        require(same, f"{name} {case} {dtype}: not bit for bit the chain "
                "of one-layer launches")

        def chain():
            o = x
            for i, w in enumerate(layers):
                o, _, _ = fb.fused_block_decode(o, w, ck[i], cv[i], bt, sl,
                                                **kw)

        row.update(bitwise_vs_one_layer_chain=same,
                   one_layer_kernel_x4_ms=time_ms(chain))
    nbytes = (block_bytes(mw, GROUP_LAYERS, x, live, quant)
              + 4 * (bt.numel() + sl.numel()))
    bms, by = bound_ms(nbytes, flops, dtype)

    def call():
        fb.fused_multi_block_decode(x, mw, gk, gv, bt, sl, **kw)

    kms = time_ms(call)
    row.update(
        max_err=err, kernel_ms=kms,
        plain_ms=time_ms(lambda: fb.fused_multi_block_decode_ref(
            x, mw, wk, wv, bt, sl, **kw), iters=5, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
        device_ms=dict(kernel=graph_ms(call, calls=5, reps=4)),
        weight_bytes=weight_bytes(mw))
    return row


# ----------------------------------------------------------------- serve
def prompts(vocab: int, lens) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def serve(model, fused: bool, new_tokens: int, lens, record_logits=False,
          max_seq=MAX_SEQ, group=1, kv_dtype="native", weight_dtype="native"):
    """One engine run over ``lens`` prompts, half submitted up front and
    the rest mid-run, with ``FLAGS_fused_block_layers=group`` and the
    engine's ``kv_dtype`` and ``weight_dtype``. Returns (engine, [(rid,
    prompt, tokens)], seconds, launch counts, peak device bytes of the run,
    engine included)."""
    from paddle_tpu_torch import flags, kernels
    from paddle_tpu_torch.generation.serving import ServingEngine

    class Engine(ServingEngine):
        """Times each prefill chunk, a synchronise on both sides (the
        engine's next host->device copy synchronises the stream anyway)."""

        def _prefill_chunk(self, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._prefill_chunk(req)
            torch.cuda.synchronize()
            self.chunk_seconds.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    flags.set_flags({"fused_block_decode": fused,
                     "fused_block_layers": group})
    eng = Engine(model, max_batch=BATCH, page_size=PAGE, max_seq_len=max_seq,
                 record_logits=record_logits, kv_dtype=kv_dtype,
                 weight_dtype=weight_dtype)
    eng.chunk_seconds = []
    require((eng._spec is not None) == fused, "decode route not as asked")
    require((eng._stacked is not None) == (fused and group > 1),
            "N-layer route not as asked")
    # warm-up requests, one whole and one chunked (first-call costs:
    # library loads, cuBLAS handles)
    for p in prompts(model.config.vocab_size, (9, CHUNK + 9)):
        eng.submit(p, 2)
    eng.run()
    for probe in (eng.decode_step_seconds, eng.prefill_seconds,
                  eng.ttft_seconds, eng.logits, eng.chunk_seconds):
        probe.clear()
    eng.chunk_dispatches = 0
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
            seconds, counts, torch.cuda.max_memory_allocated())


def check_tokens(res, vocab, new_tokens):
    for _, prompt, toks in res:
        require(len(toks) == new_tokens,
                f"request of {len(prompt)} tokens returned {len(toks)}")
        require(all(0 <= t < vocab for t in toks),
                "token out of the vocabulary")


def expected_launches(counts, layers, steps, whole, chunks, fused, group,
                      kv_dtype, weight_dtype) -> dict:
    """Every kernel variant's launches in one serving run: ``whole``
    whole-prompt prefills and ``chunks`` chunks over ``layers`` layers,
    ``steps`` decode steps through the route asked for; 0 for the rest."""
    int8 = kv_dtype == "int8"
    if not fused:
        decode = "paged_attention", layers * steps, [int8]
    elif group == 1:
        decode = "fused_block_decode", layers * steps, [int8]
    else:
        decode = ("fused_multi_block_decode", -(-layers // group) * steps,
                  [int8, weight_dtype == "int4"])
    base, n, flags = decode
    name = "_".join([base] + [t for t, on in zip(("int8", "int4"), flags)
                              if on])
    want = dict.fromkeys(counts, 0)
    want["flash_prefill"] = layers * whole
    want["paged_chunk_attention" + ("_int8" if int8 else "")] = (
        layers * chunks)
    want[name] = n
    return want


def require_launches(counts, want, what):
    for name, n in want.items():
        require(counts[name] == n,
                f"{what}: {name} ran {counts[name]} times, want {n}")


# (fused decode, FLAGS_fused_block_layers, kv_dtype, weight_dtype)
SERVE_RUNS = ((True, 1, "native", "native"), (False, 1, "native", "native"),
              (False, 1, "int8", "native"),
              (True, GROUP_LAYERS, "int8", "native"),
              (True, GROUP_LAYERS, "native", "int4"))
LONG_RUNS = ((1, "native", "native"), (GROUP_LAYERS, "native", "native"),
             (1, "int8", "native"), (GROUP_LAYERS, "int8", "int4"))


def run_serve(device):
    """The serve and serve_long phases on one Llama-2-7B. Returns the
    kernel launch counts of every run, summed."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             generator=seed(SEED, device))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers = cfg.num_hidden_layers
    total: dict = {}
    for fused, group, kv_dtype, weight_dtype in SERVE_RUNS:
        eng, res, seconds, counts, peak = serve(
            model, fused, NEW_TOKENS, PROMPT_LENS, group=group,
            kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        require_launches(counts, expected_launches(
            counts, layers, steps, len(PROMPT_LENS), 0, fused, group,
            kv_dtype, weight_dtype),
            f"serve {'fused' if fused else 'generic'} N={group} "
            f"{kv_dtype}/{weight_dtype}")
        gen = sum(len(t) for _, _, t in res)
        emit("serve", model="llama2_7b", layers=layers, dtype="bf16",
             decode="fused" if fused else "generic",
             fused_block_layers=group, kv_dtype=kv_dtype,
             weight_dtype=weight_dtype,
             requests=len(res), prompt_lens=list(PROMPT_LENS),
             new_tokens=NEW_TOKENS, generated=gen, seconds=seconds,
             tokens_per_s=gen / seconds,
             ttft_ms_median=1e3 * float(np.median(
                 list(eng.ttft_seconds.values()))),
             ttft_ms_max=1e3 * max(eng.ttft_seconds.values()),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             launches=counts, model_build_s=build_s,
             peak_mem_gb=peak / 1e9)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng
        torch.cuda.empty_cache()
    counts = run_serve_long(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del model
    torch.cuda.empty_cache()
    return total


def run_serve_long(model) -> dict:
    """Prompts up to 3500 tokens of a 4096-token context, chunked, with one
    fused kernel a layer and one a group of GROUP_LAYERS layers, on the
    native pool and weights, then on the int8 pool (one layer a launch)
    and the int8 pool with int4 weights (a group a launch): exact launch
    counts; the native runs' streams identical, the int8 runs' first
    tokens identical (their prefill and chunks are the same). Returns the
    summed launch counts."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    chunks = sum(-(-n // CHUNK) for n in LONG_PROMPT_LENS if n > CHUNK)
    whole = sum(1 for n in LONG_PROMPT_LENS if n <= CHUNK)
    streams, total = {}, {}
    for group, kv_dtype, weight_dtype in LONG_RUNS:
        eng, res, seconds, counts, peak = serve(
            model, True, NEW_TOKENS, LONG_PROMPT_LENS, max_seq=LONG_MAX_SEQ,
            group=group, kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        require_launches(counts, expected_launches(
            counts, layers, steps, whole, chunks, True, group, kv_dtype,
            weight_dtype), f"serve_long N={group} {kv_dtype}/{weight_dtype}")
        require(eng.chunk_dispatches == chunks,
                f"serve_long: {eng.chunk_dispatches} chunks, want {chunks}")
        streams[group, kv_dtype] = [toks for _, _, toks in res]
        ttft = {True: [], False: []}
        for rid, prompt, _ in res:
            ttft[len(prompt) > CHUNK].append(1e3 * eng.ttft_seconds[rid])
        gen = sum(len(t) for t in streams[group, kv_dtype])
        emit("serve_long", model="llama2_7b", layers=layers, dtype="bf16",
             fused_block_layers=group, kv_dtype=kv_dtype,
             weight_dtype=weight_dtype, max_seq_len=LONG_MAX_SEQ,
             prefill_chunk=CHUNK, requests=len(res),
             prompt_lens=list(LONG_PROMPT_LENS), new_tokens=NEW_TOKENS,
             generated=gen, seconds=seconds, tokens_per_s=gen / seconds,
             ttft_ms_long_median=float(np.median(ttft[True])),
             ttft_ms_long_max=max(ttft[True]),
             ttft_ms_short_median=float(np.median(ttft[False])),
             ttft_ms_short_max=max(ttft[False]),
             chunks=eng.chunk_dispatches,
             chunk_ms_median=1e3 * float(np.median(eng.chunk_seconds)),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             launches=counts, peak_mem_gb=peak / 1e9)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng
        torch.cuda.empty_cache()
    require(streams[1, "native"] == streams[GROUP_LAYERS, "native"],
            f"serve_long: the N={GROUP_LAYERS} streams differ from N=1")
    first = {key: [t[0] for t in toks] for key, toks in streams.items()}
    require(first[1, "int8"] == first[GROUP_LAYERS, "int8"],
            "serve_long: the int8 runs' first tokens differ")
    return total


# ---------------------------------------------------------------- parity
def run_parity(device):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                             generator=seed(SEED + 7, device))
    chunks = sum(-(-n // CHUNK) for n in PARITY_LENS if n > CHUNK)
    for fused, group in ((True, 1), (False, 1), (True, 2)):
        eng, res, _, counts, _ = serve(model, fused, PARITY_NEW_TOKENS,
                                       PARITY_LENS, record_logits=True,
                                       group=group)
        require(counts["paged_chunk_attention"] == 2 * chunks,
                f"parity: paged_chunk_attention ran "
                f"{counts['paged_chunk_attention']} times")
        require((counts["fused_multi_block_decode"] > 0) == (group > 1),
                "parity: N-layer route not as asked")
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
             decode="fused" if fused else "generic",
             fused_block_layers=group, prompt_lens=list(PARITY_LENS),
             prefill_chunk=CHUNK, chunks=eng.chunk_dispatches,
             requests=len(res), max_logit_err=worst, tol=PARITY_TOL,
             tokens_checked=checked, tokens_within_tol_gap=skipped,
             launches=counts)
        del eng
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------- train_kernels
def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# the flash kernels whose rows give bound_frac (bound / kernel time): the
# forward and the backward, redesigned for the tensor cores
BOUND_FRAC_KEYS = ("fwd", "dq", "dkv")


def frac(bounds, times, key) -> dict:
    """``{"bound_frac": bound / kernel ms}`` for a BOUND_FRAC_KEYS row."""
    if key not in BOUND_FRAC_KEYS:
        return {}
    return dict(bound_frac=bounds[key][0] / times[key])


def check_flash_attention(dtype, device, rows):
    """Forward, dq and dk/dv against autograd of the dense reference on
    the card; then each kernel's time beside its plain version's, SDPA's
    (forward; forward + backward; backward alone), and the card's bound.
    Appends one row per kernel and shape."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    for case, b, s, h, hkv in TRAIN_SHAPES:
        q = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        k = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        v = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        do = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        kw = dict(causal=True, n_heads=h, n_kv_heads=hkv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.flash_attention_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad(ref, leaves, do)
        _, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (out.float() * do.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        out_err, lse_err = max_err(out, ref), max_err(lse, lse_ref)
        out_excess = excess(out, ref, rtol)
        dq_rel = rel_err(dq, ref_grads[0])
        dkv_rel = max(rel_err(dk, ref_grads[1]), rel_err(dv, ref_grads[2]))
        dq_abs = max_err(dq, ref_grads[0])
        dkv_abs = max(max_err(dk, ref_grads[1]), max_err(dv, ref_grads[2]))
        tag = f"{case} B={b} S={s} H={h} Hkv={hkv} {DTYPE_NAME[dtype]}"
        require(out_excess <= atol, f"flash fwd out {tag}: {out_excess} "
                f"over {rtol} |ref|")
        require(lse_err <= LSE_TOL[dtype], f"flash fwd lse {tag}: {lse_err}")
        require(dq_rel <= GRAD_TOL[dtype], f"flash dq {tag}: {dq_rel}")
        require(dkv_rel <= GRAD_TOL[dtype], f"flash dk/dv {tag}: {dkv_rel}")
        del leaves, ref, ref_grads, dq, dk, dv
        torch.cuda.empty_cache()

        bwd = (q, k, v, do, lse, delta)
        t = dict(
            fwd=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                        iters=10, warmup=2),
            dq=time_ms(lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                       iters=10, warmup=2),
            dkv=time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                        iters=10, warmup=2),
            fwd_plain=time_ms(lambda: fa.flash_attention_fwd_ref(
                q, k, v, **kw), iters=5, warmup=1),
            dq_plain=time_ms(lambda: fa.flash_attention_bwd_dq_ref(
                *bwd, **kw), iters=5, warmup=1),
            dkv_plain=time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
                *bwd, **kw), iters=5, warmup=1))
        qs, ks, vs, dos = (x.reshape(b, -1, s, HEAD_DIM)
                           for x in (q, k, v, do))
        t["sdpa_fwd"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True),
                                iters=10, warmup=2)
        lq, lk, lv = (x.clone().requires_grad_(True) for x in (qs, ks, vs))

        def sdpa_fwd_bwd():
            o = sdpa(lq, lk, lv, is_causal=True)
            torch.autograd.grad(o, (lq, lk, lv), dos)

        t["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters=10, warmup=2)
        # SDPA's backward alone: one saved forward, then its backward op
        # (of the backend SDPA picked on this card) again and again
        o = sdpa(lq, lk, lv, is_causal=True)
        t["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(
            o, (lq, lk, lv), dos, retain_graph=True), iters=10, warmup=2)
        del o

        elem = q.element_size()
        pairs = b * h * s * (s + 1) // 2          # causal (query, key) pairs
        fwd_ops = 4.0 * pairs * HEAD_DIM          # QK^T and PV
        stats = 4 * 2 * q.shape[0] * s            # lse and delta, f32
        bounds = dict(
            fwd=bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                         + 4 * q.shape[0] * s, fwd_ops, dtype),
            # dq recomputes S and dP and forms dS K: 3 products
            dq=bound_ms(elem * (3 * q.numel() + k.numel() + v.numel())
                        + stats, 1.5 * fwd_ops, dtype),
            # dk/dv recompute S and dP and form P^T dO and dS^T Q: 4
            dkv=bound_ms(elem * (2 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats,
                         2.0 * fwd_ops, dtype),
            # the fused backward (dq and dk/dv from one recompute): 2.5x
            bwd=bound_ms(elem * (3 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats,
                         2.5 * fwd_ops, dtype))
        emit("train_kernels", case=case, dtype=DTYPE_NAME[dtype], B=b, S=s,
             H=h, Hkv=hkv, D=HEAD_DIM, out_max_err=out_err,
             out_excess=out_excess, out_atol=atol, out_rtol=rtol,
             lse_max_err=lse_err, lse_tol=LSE_TOL[dtype],
             dq_rel_err=dq_rel, dkv_rel_err=dkv_rel,
             grad_tol=GRAD_TOL[dtype],
             kernel_ms=dict(fwd=t["fwd"], bwd=t["dq"] + t["dkv"],
                            dq=t["dq"], dkv=t["dkv"]),
             plain_ms=dict(fwd=t["fwd_plain"],
                           bwd=t["dq_plain"] + t["dkv_plain"],
                           dq=t["dq_plain"], dkv=t["dkv_plain"]),
             library_ms=dict(sdpa_fwd=t["sdpa_fwd"],
                             sdpa_fwd_bwd=t["sdpa_fwd_bwd"],
                             sdpa_bwd=t["sdpa_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()},
             bound_frac={key: bounds[key][0] / t[key]
                         for key in BOUND_FRAC_KEYS})
        # library: SDPA's forward; for dq and dk/dv, SDPA's one backward
        # op, which computes both
        for name, key, err, lib in (
                ("flash_attention_fwd", "fwd", max(out_err, lse_err),
                 t["sdpa_fwd"]),
                ("flash_attention_bwd_dq", "dq", dq_abs, t["sdpa_bwd"]),
                ("flash_attention_bwd_dkv", "dkv", dkv_abs, t["sdpa_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], S=s, case=case,
                max_err=err, kernel_ms=t[key], plain_ms=t[key + "_plain"],
                library_ms=lib, bound_ms=bounds[key][0],
                bound_by=bounds[key][1], **frac(bounds, t, key)))
        del q, k, v, do, lse, delta, out, lq, lk, lv
        torch.cuda.empty_cache()


def check_flash_with_lse(dtype, device):
    """flash_attention_with_lse on the kernels: out, lse and the gradients
    under a seeded (dO, dlse) against autograd of the plain forward
    (flash_attention_fwd_ref, which returns the differentiable lse) on the
    card, each kernel launched once; the log-space merge of two non-causal
    calls over the halves of the keys against the whole call; and the
    with_lse forward and forward + backward timed beside flash_attention's
    on the same shape (the fold of dlse into delta should not show), the
    plain version's and SDPA's. Returns the phase's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    total: dict = {}
    for case, b, s, h, hkv in WITH_LSE_SHAPES:
        q = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        k = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        v = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        do = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        dlse = _rand(gen, (b * h, s), torch.float32, device)
        kw = dict(causal=True, n_heads=h, n_kv_heads=hkv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref, ref_lse = fa.flash_attention_fwd_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad((ref, ref_lse), leaves, (do, dlse))
        ref, ref_lse = ref.detach(), ref_lse.detach()
        lq = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_launches()
        out, lse = fa.flash_attention_with_lse(*lq, **kw)
        grads = torch.autograd.grad((out, lse), lq, (do, dlse))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name in TRAIN_KERNELS:
            require(counts[name] == 1, f"with_lse: {name} ran "
                    f"{counts[name]} times, want 1")
        total = {n: total.get(n, 0) + c for n, c in counts.items()}
        atol, rtol = OUT_TOL[dtype]
        tag = f"{case} B={b} S={s} H={h} Hkv={hkv} {DTYPE_NAME[dtype]}"
        out_excess = excess(out, ref, rtol)
        lse_err = max_err(lse, ref_lse)
        grad_rel = [rel_err(g, r) for g, r in zip(grads, ref_grads)]
        require(out_excess <= atol, f"with_lse out {tag}: {out_excess}")
        require(lse_err <= LSE_TOL[dtype], f"with_lse lse {tag}: {lse_err}")
        require(max(grad_rel) <= GRAD_TOL[dtype],
                f"with_lse grads {tag}: {grad_rel}")
        del leaves, ref_grads, grads
        torch.cuda.empty_cache()

        # the merge ring attention relies on: halves of the keys
        half = s // 2
        nk = dict(causal=False, n_heads=h, n_kv_heads=hkv)
        with torch.no_grad():
            whole, whole_lse = fa.flash_attention_with_lse(q, k, v, **nk)
            parts = [fa.flash_attention_with_lse(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), **nk)
                for sl in (slice(0, half), slice(half, s))]
        lse_m = torch.logaddexp(parts[0][1], parts[1][1])
        out_m = sum(torch.exp(part_lse - lse_m)[..., None] * part.float()
                    for part, part_lse in parts)
        merge_out_err = max_err(out_m, whole)
        merge_lse_err = max_err(lse_m, whole_lse)
        require(merge_out_err <= MERGE_TOL[dtype]
                and merge_lse_err <= LSE_TOL[dtype],
                f"with_lse merge {tag}: out {merge_out_err}, lse "
                f"{merge_lse_err}")
        del whole, parts, out_m
        torch.cuda.empty_cache()

        def lse_fwd_bwd():
            o, l = fa.flash_attention_with_lse(*lq, **kw)
            torch.autograd.grad((o, l), lq, (do, dlse))

        def flash_fwd_bwd():
            torch.autograd.grad(fa.flash_attention(*lq, **kw), lq, do)

        def plain_fwd_bwd():
            o, l = fa.flash_attention_fwd_ref(*lq, **kw)
            torch.autograd.grad((o, l), lq, (do, dlse))

        with torch.no_grad():
            t = dict(
                fwd=time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, **kw), iters=10, warmup=2),
                flash_fwd=time_ms(lambda: fa.flash_attention(
                    q, k, v, **kw), iters=10, warmup=2),
                plain_fwd=time_ms(lambda: fa.flash_attention_fwd_ref(
                    q, k, v, **kw), iters=5, warmup=1))
        t.update(fwd_bwd=time_ms(lse_fwd_bwd, iters=10, warmup=2),
                 flash_fwd_bwd=time_ms(flash_fwd_bwd, iters=10, warmup=2),
                 plain_fwd_bwd=time_ms(plain_fwd_bwd, iters=3, warmup=1))
        qs, ks, vs = (x.reshape(b, -1, s, HEAD_DIM) for x in (q, k, v))
        t["sdpa_fwd"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True),
                                iters=10, warmup=2)
        elem = q.element_size()
        pairs = b * h * s * (s + 1) // 2
        fwd_ops = 4.0 * pairs * HEAD_DIM
        stats = 4 * q.shape[0] * s
        fwd_bound = bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                             + stats, fwd_ops, dtype)
        # forward, then dq and dk/dv (with dlse read once more)
        bwd_bound = bound_ms(elem * (3 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel()) + 3 * stats,
                             2.5 * fwd_ops, dtype)
        emit("train_kernels", case=f"flash_attention_with_lse, {case}",
             dtype=DTYPE_NAME[dtype], B=b, S=s, H=h, Hkv=hkv, D=HEAD_DIM,
             out_excess=out_excess, out_atol=atol, out_rtol=rtol,
             lse_max_err=lse_err, lse_tol=LSE_TOL[dtype],
             grad_rel_err=dict(zip(("dq", "dk", "dv"), grad_rel)),
             grad_tol=GRAD_TOL[dtype], merge_out_max_err=merge_out_err,
             merge_lse_max_err=merge_lse_err, merge_out_tol=MERGE_TOL[dtype],
             launches=counts,
             kernel_ms=dict(fwd=t["fwd"], fwd_bwd=t["fwd_bwd"]),
             flash_attention_ms=dict(fwd=t["flash_fwd"],
                                     fwd_bwd=t["flash_fwd_bwd"]),
             plain_ms=dict(fwd=t["plain_fwd"], fwd_bwd=t["plain_fwd_bwd"]),
             library_ms=dict(sdpa_fwd=t["sdpa_fwd"]),
             bound_ms=dict(fwd=fwd_bound[0], fwd_bwd=fwd_bound[0]
                           + bwd_bound[0]),
             bound_by=dict(fwd=fwd_bound[1], bwd=bwd_bound[1]))
        del q, k, v, do, dlse, lq, out, lse
        torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- train
def make_trainer(model, lr, steps=None, grad_accum_steps=1, remat=False):
    """AdamW(multi_precision) + global-norm clip, through TrainStep; with
    ``steps`` a 2-step linear warmup into a cosine decay."""
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = lr if steps is None else LinearWarmup(
        CosineAnnealingDecay(lr, T_max=steps), warmup_steps=2,
        start_lr=lr / 10, end_lr=lr)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, grad_accum_steps=grad_accum_steps,
                     remat=remat)


def token_batch(vocab, batch, seq, seed_offset):
    """Seeded (inputs, shifted labels), int64, on the host."""
    rng = np.random.default_rng(SEED + seed_offset)
    ids = torch.from_numpy(rng.integers(0, vocab, (batch, seq + 1)))
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def run_train(device):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             generator=seed(SEED, device))
    trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                           grad_accum_steps=TRAIN_ACCUM)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, TRAIN_BATCH,
                                              TRAIN_SEQ, 5))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer(x, y))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    require(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    require(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    want = TRAIN_LAYERS * TRAIN_ACCUM * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == want,
                f"{name} ran {counts[name]} times, want {want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = (3.5 * 4.0 * pairs * cfg.hidden_size * TRAIN_LAYERS
            * TRAIN_BATCH)                       # forward 1x + backward 2.5x
    flops = 6.0 * n_matmul * tokens + attn
    step_ms = 1e3 * float(np.median(step_s))
    peak = torch.cuda.max_memory_allocated()
    emit("train", model="llama2_7b width", layers=TRAIN_LAYERS,
         params=cfg.num_params(), dtype="bf16, f32 masters",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, grad_accum_steps=TRAIN_ACCUM,
         steps=TRAIN_STEPS, losses=losses,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3),
         peak_mem_gb=peak / 1e9,
         model_flops_per_step=flops, attention_flops_per_step=attn,
         mfu_vs_989_tflops=flops / (step_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         launches=counts, model_build_s=build_s)
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts, dict(peak=peak, step_ms=step_ms, losses=losses,
                        flops=flops)


def train_flops(cfg, batch) -> float:
    """The train phase's model FLOPs of one step of ``batch`` rows of
    TRAIN_SEQ tokens: 6 x the matmul parameters x tokens, plus causal
    attention (forward 1x, backward 2.5x)."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3.5 * 4.0 * pairs * cfg.hidden_size * TRAIN_LAYERS * batch
    return 6.0 * n_matmul * batch * TRAIN_SEQ + attn


def train_model(device, generator_seed, dtype=torch.bfloat16):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    return cfg, LlamaForCausalLM(cfg, device=device, dtype=dtype,
                                 generator=seed(generator_seed, device))


def run_train_remat(device, train):
    """TrainStep(remat=True) on the train phase's model (same seed) and
    batch: the first step's gradients against the same step without remat
    (bit for bit: the same deterministic kernels recompute the same
    activations), then TRAIN_STEPS steps timed as in train, with a peak
    below train's and the flash forward launched twice a layer and
    micro-batch (the recompute runs it again)."""
    from paddle_tpu_torch import kernels
    cfg, model = train_model(device, SEED)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, TRAIN_BATCH,
                                              TRAIN_SEQ, 5))
    plain = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                         grad_accum_steps=TRAIN_ACCUM)
    trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                           grad_accum_steps=TRAIN_ACCUM, remat=True)

    def grads_of(step):
        """The step's loss and gradients, the launches, and the memory its
        forward and backward add at their peak (activations and
        gradients; the optimizer state is not made yet)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss, grads = step.compute_loss_grads(x, y)
        torch.cuda.synchronize()
        return (loss, grads, kernels.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    loss_plain, ref, _, plain_added = grads_of(plain)
    loss_remat, grads, first_counts, remat_added = grads_of(trainer)
    unequal = [k for k, g in grads.items() if not torch.equal(g, ref[k])]
    worst = max(rel_err(g, ref[k]) for k, g in grads.items())
    require(sorted(grads) == sorted(ref), "train_remat: gradient names")
    require(not unequal and float(loss_remat) == float(loss_plain),
            f"train_remat: first-step gradients differ from train's "
            f"without remat ({len(unequal)} tensors, worst rel {worst})")
    micro = TRAIN_LAYERS * TRAIN_ACCUM
    require(first_counts["flash_attention_fwd"] == 2 * micro
            and first_counts["flash_attention_bwd_dq"] == micro,
            f"train_remat: first-step launches {first_counts}")
    require(remat_added < plain_added, f"train_remat: forward + backward "
            f"add {remat_added / 1e9} GB, without remat {plain_added / 1e9}")
    del plain, ref, grads
    trainer.optimizer.clear_grad()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer(x, y))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    require(all(math.isfinite(v) for v in losses), f"remat losses {losses}")
    want = dict(flash_attention_fwd=2 * micro * TRAIN_STEPS,
                flash_attention_bwd_dq=micro * TRAIN_STEPS,
                flash_attention_bwd_dkv=micro * TRAIN_STEPS)
    for name, n in want.items():
        require(counts[name] == n, f"train_remat: {name} ran {counts[name]}"
                f" times, want {n}")
    require(peak < train["peak"], f"train_remat: peak {peak / 1e9} GB not "
            f"below train's {train['peak'] / 1e9} GB")
    step_ms = 1e3 * float(np.median(step_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("train_remat", model="llama2_7b width", layers=TRAIN_LAYERS,
         dtype="bf16, f32 masters", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         grad_accum_steps=TRAIN_ACCUM, steps=TRAIN_STEPS, losses=losses,
         losses_equal_train=losses == train["losses"],
         first_step_grads_bitwise_equal=True,
         first_step_grad_rel_err_max=worst, first_step_launches=first_counts,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         train_step_ms_median=train["step_ms"],
         tokens_per_s=tokens / (step_ms / 1e3),
         mfu_vs_989_tflops=train["flops"] / (step_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         peak_mem_gb=peak / 1e9, train_peak_mem_gb=train["peak"] / 1e9,
         fwd_bwd_added_gb=remat_added / 1e9,
         fwd_bwd_added_gb_without_remat=plain_added / 1e9,
         launches=counts)
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts


def run_fit(device, train):
    """The slice's main path: Model.fit over a DataLoader, with the model
    decorated by amp (O2, bf16, f32 masters), AdamW over two parameter
    groups (embedding and head at half the rate), no decay on the norms,
    LinearWarmup(CosineAnnealingDecay), global-norm clip and
    LlamaPretrainingCriterion; batches prefetched to the card; the
    LRScheduler, EarlyStopping and ModelCheckpoint callbacks."""
    import shutil
    from paddle_tpu_torch import amp, kernels
    from paddle_tpu_torch.hapi import Model, TrainStep
    from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                                 LRScheduler,
                                                 ModelCheckpoint)
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    cfg, model = train_model(device, SEED + 21, dtype=torch.float32)
    outer = ("llama.embed_tokens.weight", "lm_head.weight")
    named = list(model.named_parameters())
    opt = AdamW(LinearWarmup(CosineAnnealingDecay(3e-4, T_max=FIT_STEPS),
                             warmup_steps=2, start_lr=3e-5, end_lr=3e-4),
                parameters=[
                    {"params": [e for e in named if e[0] in outer],
                     "learning_rate": 0.5},
                    {"params": [e for e in named if e[0] not in outer]}],
                weight_decay=0.01,
                apply_decay_param_fun=lambda n: "norm" not in n,
                grad_clip=ClipGradByGlobalNorm(1.0))
    # bf16 parameters without f32 masters: the reference's ModelCheckpoint
    # saves twice (epoch 0 and the end), and with masters the two saves
    # would write 52.7 GB, past the 45 GiB a chip call may write
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    require(all(p.dtype == torch.bfloat16 for p in model.parameters())
            and not opt._multi_precision, "fit: amp.decorate O2")
    crit = LlamaPretrainingCriterion(cfg)
    x, y = token_batch(cfg.vocab_size, FIT_ROWS, TRAIN_SEQ, 7)
    data = TensorDataset([x, y])

    def loader():
        return DataLoader(data, batch_size=FIT_BATCH, shuffle=True,
                          seed=SEED + 31)

    # the reference: a bare TrainStep's loss on the loader's first batch,
    # on a copy of the same weights
    first = next(iter(loader()))
    twin = copy.deepcopy(model)
    bare = TrainStep(twin, AdamW(3e-4, parameters=twin.named_parameters()),
                     loss_fn=crit, grad_accum_steps=FIT_ACCUM)
    ref_loss = float(bare.compute_loss_grads(*(t.to(device)
                                               for t in first))[0])
    del twin, bare
    torch.cuda.empty_cache()

    class Record(Callback):
        """Each step's logs; the host's clock and a CUDA event on the
        card's stream at each step's start and at the epoch's end (after
        its sync)."""

        def __init__(self):
            super().__init__()
            self.logs, self.begin, self.events = [], [], []

        def _mark(self):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self.begin.append(self._mark())

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))

        def on_epoch_end(self, epoch, logs=None):
            self.end = self._mark()
            self.epoch_loss = logs.get("loss")

    shutil.rmtree(FIT_CKPT_DIR, ignore_errors=True)
    os.makedirs(FIT_CKPT_DIR, exist_ok=True)
    disk_free_gb = shutil.disk_usage(FIT_CKPT_DIR).free / 1e9
    rec = Record()
    ckpt = ModelCheckpoint(save_freq=1, save_dir=FIT_CKPT_DIR)
    fitted = Model(model)
    fitted.prepare(opt, loss=crit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fitted.fit(loader(), epochs=1, accumulate_grad_batches=FIT_ACCUM,
               metrics_every=FIT_METRICS_EVERY, num_iters=FIT_STEPS,
               prefetch_to_device=True, verbose=0,
               callbacks=[rec, LRScheduler(), EarlyStopping(patience=2),
                          ckpt])
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_obj = fitted._train_step
    losses = {r["loss_step"]: r["loss"] for r in rec.logs
              if r.get("loss") is not None}
    require(len(rec.logs) == FIT_STEPS, f"fit ran {len(rec.logs)} steps")
    require(all(math.isfinite(v) for v in losses.values())
            and math.isfinite(rec.epoch_loss), f"fit losses {losses}")
    require(losses.get(0) == ref_loss, f"fit: first loss {losses.get(0)} "
            f"!= a bare TrainStep's {ref_loss}")
    micro = TRAIN_LAYERS * FIT_ACCUM * FIT_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == micro, f"fit: {name} ran {counts[name]} "
                f"times, want {micro}")
    # the checkpoint loads back into a fresh model with equal parameters
    _, fresh = train_model(device, SEED + 22)
    Model(fresh).load(os.path.join(FIT_CKPT_DIR, "final"),
                      reset_optimizer=True)
    torch.cuda.synchronize()
    differ = [n for (n, a), b in zip(model.named_parameters(),
                                     fresh.parameters())
              if not torch.equal(a, b)]
    require(not differ, f"fit: checkpoint parameters differ: {differ[:3]}")
    ckpt_gb = sum(os.path.getsize(os.path.join(FIT_CKPT_DIR, f))
                  for f in os.listdir(FIT_CKPT_DIR)) / 1e9
    del fresh
    shutil.rmtree(FIT_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # steps 1.. of fit (the first also makes the optimizer state) on the
    # card's clock: from the event queued at step 1's start (it fires when
    # step 0's work is done) to the epoch's end; then a bare TrainStep
    # loop over the same batches staged on the card, timed the same way
    fit_ms = rec.events[1].elapsed_time(rec.events[-1]) / (FIT_STEPS - 1)
    gaps = np.diff(rec.begin) * 1e3
    batches = [tuple(t.to(device) for t in b) for _, b in zip(
        range(FIT_STEPS), loader())]
    loop = TrainStep(model, opt, loss_fn=crit, grad_accum_steps=FIT_ACCUM,
                     metrics_every=FIT_METRICS_EVERY)
    loop(*batches[0])
    loop.sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for b in batches[1:]:
        loop(*b)
    loop.sync()
    end.record()
    end.synchronize()
    bare_ms = start.elapsed_time(end) / (FIT_STEPS - 1)
    tokens = FIT_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, FIT_BATCH)
    emit("fit", model="llama2_7b width", layers=TRAIN_LAYERS,
         dtype="bf16 (amp O2), no masters", rows=FIT_ROWS,
         batch=FIT_BATCH, seq=TRAIN_SEQ, accumulate_grad_batches=FIT_ACCUM,
         metrics_every=FIT_METRICS_EVERY, steps=FIT_STEPS,
         losses={str(k): v for k, v in sorted(losses.items())},
         epoch_loss=rec.epoch_loss, first_loss=losses[0],
         bare_trainstep_first_loss=ref_loss,
         step_ms=fit_ms, host_gap_ms=[float(g) for g in gaps],
         bare_trainstep_step_ms=bare_ms, fit_overhead_ms=fit_ms - bare_ms,
         train_step_ms_median=train["step_ms"],
         tokens_per_s=tokens / (fit_ms / 1e3),
         mfu_vs_989_tflops=flops / (fit_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         host_wait_share=step_obj.wait_s / (rec.end - rec.begin[0]),
         host_wait_s=step_obj.wait_s, pulls=step_obj.sync_count,
         peak_mem_gb=peak / 1e9, fit_s=fit_s, checkpoint_gb=ckpt_gb,
         disk_free_gb=disk_free_gb, launches=counts)
    del model, opt, fitted, loop, batches
    torch.cuda.empty_cache()
    return counts


def run_train_parity(device):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = TRAIN_PARITY_LAYERS
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=seed(SEED + 11))
    card = copy.deepcopy(cpu).to(device)
    x, y = token_batch(cfg.vocab_size, 1, TRAIN_PARITY_SEQ, 6)
    results = {}
    for name, model, dev in (("card", card, device), ("cpu", cpu, "cpu")):
        trainer = make_trainer(model, 3e-4)
        kernels.reset_launches()
        loss, grads = trainer.compute_loss_grads(x.to(dev), y.to(dev))
        counts = kernels.launch_counts()
        grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        trainer.apply_update()
        require(all(bool(torch.isfinite(p).all())
                    for p in model.parameters()),
                f"train_parity: non-finite parameters on the {name}")
        results[name] = (float(loss), grads, counts)
        del trainer
    (l_card, g_card, counts), (l_cpu, g_cpu, cpu_counts) = (
        results["card"], results["cpu"])
    for k in TRAIN_KERNELS:
        require(counts[k] == TRAIN_PARITY_LAYERS,
                f"train_parity: {k} ran {counts[k]} times on the card")
        require(cpu_counts[k] == 0, f"train_parity: {k} launched on the CPU")
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    require(loss_rel <= TRAIN_PARITY_LOSS_TOL,
            f"train_parity: loss {l_card} vs {l_cpu}")
    require(sorted(g_card) == sorted(g_cpu), "train_parity: grad names")
    worst, worst_name = 0.0, None
    for k, g in g_cpu.items():
        err = float((g_card[k] - g).norm() / g.norm().clamp_min(1e-30))
        if err > worst:
            worst, worst_name = err, k
    require(worst <= TRAIN_PARITY_GRAD_TOL,
            f"train_parity: grad of {worst_name} off by {worst} (rel L2)")
    emit("train_parity", model="llama2_7b width", layers=TRAIN_PARITY_LAYERS,
         dtype="fp32", batch=1, seq=TRAIN_PARITY_SEQ, loss_card=l_card,
         loss_cpu=l_cpu, loss_rel_err=loss_rel, loss_tol=TRAIN_PARITY_LOSS_TOL,
         grads=len(g_cpu), grad_rel_l2_max=worst, grad_worst=worst_name,
         grad_tol=TRAIN_PARITY_GRAD_TOL, launches=counts)
    del card, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------- train_varlen
def pack_ids(lens, device) -> torch.Tensor:
    """A pack's token segment ids: document j's tokens carry j + 1."""
    return torch.repeat_interleave(
        torch.arange(1, len(lens) + 1, dtype=torch.int32, device=device),
        torch.tensor(lens, device=device))


def in_kv_groups(call, h, hkv):
    """``call(q_rows, kv_rows, n_kv)`` over up to PLAIN_KV_GROUPS equal
    slices of the kv heads (B = 1: rows are heads) and their query heads,
    concatenated along the rows: the plain flash twins are independent per
    head, and a slice's dense f32 scores stay a fraction of the card's
    memory."""
    groups = math.gcd(hkv, PLAIN_KV_GROUPS)
    per, rep = hkv // groups, h // hkv
    outs = [call(slice(g * per * rep, (g + 1) * per * rep),
                 slice(g * per, (g + 1) * per), per) for g in range(groups)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def per_document(q, k, v, do, lens, h, hkv):
    """The pack's reference: plain causal attention (dense f32, autograd)
    of each document alone, ``(T, H, D)`` tensors in and out, with the
    gradients of q, k and v."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    outs, grads, s0 = [], ([], [], []), 0
    for n in lens:
        rows = slice(s0, s0 + n)
        s0 += n
        leaves = [t[rows].transpose(0, 1).contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        o = fa.flash_attention_ref(*leaves, causal=True, n_heads=h,
                                   n_kv_heads=hkv)
        gs = torch.autograd.grad(o, leaves,
                                 do[rows].transpose(0, 1).contiguous())
        outs.append(o.detach().transpose(0, 1))
        for acc, g in zip(grads, gs):
            acc.append(g.transpose(0, 1))
        del leaves, o, gs
    return torch.cat(outs), [torch.cat(acc) for acc in grads]


def hold(tag, out, ref_out, grads, ref_grads, dtype):
    """Outputs within OUT_TOL elementwise, gradients within GRAD_TOL of
    their largest element; returns (max abs err, worst grad rel err)."""
    atol, rtol = OUT_TOL[dtype]
    over = excess(out, ref_out, rtol)
    require(over <= atol, f"{tag}: out {over} over {rtol} |ref|")
    worst = max(rel_err(g, r) for g, r in zip(grads, ref_grads))
    require(worst <= GRAD_TOL[dtype], f"{tag}: grads off by {worst}")
    return max_err(out, ref_out), worst


def run_train_varlen(device):
    """The varlen path through its public entry points, bf16, launch counts
    exact; then each public result against its plain reference. Returns
    the counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.nn import functional as F
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    norms = [(case, [_rand(gen, (n, hid), dtype, device) for _ in range(3)],
              (1.0 + 0.1 * torch.randn(hid, generator=gen, device=device)
               ).to(dtype)) for case, n, hid in RMS_SHAPES]
    packs = []
    for case, lens, h, hkv in VARLEN_PACKS:
        t = sum(lens)
        cu = torch.tensor((0,) + tuple(np.cumsum(lens)), dtype=torch.int32,
                          device=device)
        packs.append((case, lens, h, hkv, cu, [
            _rand(gen, (t, n_h, HEAD_DIM), dtype, device)
            for n_h in (h, hkv, hkv, h)]))
    vl = [_rand(gen, (len(VLMEA_LENS), HEADS, VLMEA_SEQ, HEAD_DIM), dtype,
                device) for _ in range(3)]
    vl_lens = torch.tensor(VLMEA_LENS, dtype=torch.int32, device=device)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    norm_res = []
    for case, (x, res, g), w in norms:
        leaves = [t.clone().requires_grad_(True) for t in (x, res, w)]
        out, hsum = IF.fused_rms_norm(leaves[0], leaves[2], epsilon=RMS_EPS,
                                      residual=leaves[1])
        norm_res.append((out.detach(), hsum.detach(),
                         torch.autograd.grad(out, leaves, g)))
    pack_res = []
    for case, lens, h, hkv, cu, (q, k, v, do) in packs:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, _ = F.flash_attn_unpadded(*leaves, cu, cu, max(lens), max(lens),
                                       causal=True)
        pack_res.append((out.detach(), torch.autograd.grad(out, leaves, do)))
    vl_out = IF.variable_length_memory_efficient_attention(*vl, vl_lens,
                                                           causal=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = dict(rms_norm_fwd=len(norms), rms_norm_bwd_dx=len(norms),
                flash_attention_fwd_seg=len(packs) + 1,
                flash_attention_bwd_dq_seg=len(packs),
                flash_attention_bwd_dkv_seg=len(packs))
    require_launches(counts, {**dict.fromkeys(counts, 0), **want},
                     "train_varlen")

    for (case, (x, res, g), w), (out, hsum, grads) in zip(norms, norm_res):
        leaves = [t.clone().requires_grad_(True) for t in (x, res, w)]
        ref_h = leaves[0] + leaves[1]
        ref = rn.rms_norm_ref(ref_h, leaves[2], RMS_EPS)
        ref_grads = torch.autograd.grad(ref, leaves, g)
        require(torch.equal(hsum, (x + res)), f"fused_rms_norm {case}: h")
        err, grad_rel = hold(f"fused_rms_norm {case}", out, ref, grads,
                             ref_grads, dtype)
        emit("train_varlen", entry="fused_rms_norm", case=case,
             rows=x.shape[0], hidden=x.shape[1], dtype="bf16",
             out_max_err=err, grad_rel_err=grad_rel)
        del leaves, ref, ref_grads
    for (case, lens, h, hkv, cu, (q, k, v, do)), (out, grads) in zip(
            packs, pack_res):
        ref_out, ref_grads = per_document(q, k, v, do, lens, h, hkv)
        err, grad_rel = hold(f"flash_attn_unpadded {case}", out, ref_out,
                             grads, ref_grads, dtype)
        emit("train_varlen", entry="flash_attn_unpadded", case=case,
             doc_lens=list(lens), H=h, Hkv=hkv, dtype="bf16",
             reference="each document alone", out_max_err=err,
             grad_rel_err=grad_rel)
        del ref_out, ref_grads
        torch.cuda.empty_cache()
    b = len(VLMEA_LENS)
    seg = (torch.arange(VLMEA_SEQ, device=device)[None, :]
           >= vl_lens[:, None]).to(torch.int32).repeat_interleave(HEADS, 0)
    ref = in_kv_groups(lambda qr, kr, n: fa.flash_attention_fwd_ref(
        *(t.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM)[qr] for t in vl[:1]),
        *(t.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM)[kr] for t in vl[1:]),
        True, None, n, n, seg[qr], seg[kr])[0], b * HEADS, b * HEADS)
    atol, rtol = OUT_TOL[dtype]
    over = excess(vl_out.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM), ref, rtol)
    require(over <= atol, f"variable_length_memory_efficient_attention: "
            f"{over} over {rtol} |ref|")
    emit("train_varlen", entry="variable_length_memory_efficient_attention",
         B=b, S=VLMEA_SEQ, seq_lens=list(VLMEA_LENS), H=HEADS, dtype="bf16",
         out_max_err=max_err(vl_out.reshape(ref.shape), ref),
         out_excess=over, seconds_whole_path=seconds, launches=counts)
    del norms, norm_res, packs, pack_res, vl, vl_out, ref
    torch.cuda.empty_cache()
    return counts


def check_rms_norm(dtype, device, rows):
    """The RMSNorm forward and dx kernels against their plain twins on the
    fused input (x + residual) at the 7B and 70B widths; kernel, plain,
    library (torch.nn.functional.rms_norm forward, forward + backward and
    its backward alone) and bound times."""
    from paddle_tpu_torch.kernels import rms_norm as rn
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    for case, n, hid in RMS_SHAPES:
        x = _rand(gen, (n, hid), dtype, device) + _rand(gen, (n, hid), dtype,
                                                        device)
        w = (1.0 + 0.1 * torch.randn(hid, generator=gen, device=device)
             ).to(dtype)
        g = _rand(gen, (n, hid), dtype, device)
        y, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        y_r, r_r = rn.rms_norm_fwd_ref(x, w, RMS_EPS)
        dx = rn.rms_norm_bwd_dx(x, w, g, r)
        dx_r = rn.rms_norm_bwd_dx_ref(x, w, g, r)
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        over = excess(y, y_r, rtol)
        r_rel = float(((r - r_r).abs() / r_r).max())
        dx_rel = rel_err(dx, dx_r)
        tag = f"rms_norm {case} {DTYPE_NAME[dtype]}"
        require(over <= atol, f"{tag}: y {over} over {rtol} |ref|")
        require(r_rel <= 1e-5, f"{tag}: r off by {r_rel} relative")
        require(dx_rel <= GRAD_TOL[dtype], f"{tag}: dx off by {dx_rel}")
        t = dict(
            fwd=time_ms(lambda: rn.rms_norm_fwd(x, w, RMS_EPS)),
            dx=time_ms(lambda: rn.rms_norm_bwd_dx(x, w, g, r)),
            fwd_plain=time_ms(lambda: rn.rms_norm_fwd_ref(x, w, RMS_EPS)),
            dx_plain=time_ms(lambda: rn.rms_norm_bwd_dx_ref(x, w, g, r)),
            lib_fwd=time_ms(lambda: torch.nn.functional.rms_norm(
                x, (hid,), w, RMS_EPS)))
        lx, lw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

        def lib_fwd_bwd():
            o = torch.nn.functional.rms_norm(lx, (hid,), lw, RMS_EPS)
            torch.autograd.grad(o, (lx, lw), g)

        t["lib_fwd_bwd"] = time_ms(lib_fwd_bwd)
        o = torch.nn.functional.rms_norm(lx, (hid,), lw, RMS_EPS)
        t["lib_bwd"] = time_ms(lambda: torch.autograd.grad(
            o, (lx, lw), g, retain_graph=True))
        elem = x.element_size()
        bounds = dict(
            fwd=bound_ms(elem * (2 * x.numel() + hid) + 4 * n,
                         4.0 * x.numel(), dtype),
            dx=bound_ms(elem * (3 * x.numel() + hid) + 4 * n,
                        6.0 * x.numel(), dtype))
        emit("train_varlen", kernel="rms_norm", case=case, rows=n,
             hidden=hid, dtype=DTYPE_NAME[dtype], y_max_err=max_err(y, y_r),
             y_excess=over, atol=atol, rtol=rtol, r_rel_err=r_rel,
             dx_rel_err=dx_rel, grad_tol=GRAD_TOL[dtype],
             kernel_ms=dict(fwd=t["fwd"], dx=t["dx"]),
             plain_ms=dict(fwd=t["fwd_plain"], dx=t["dx_plain"]),
             library_ms=dict(rms_norm_fwd=t["lib_fwd"],
                             rms_norm_fwd_bwd=t["lib_fwd_bwd"],
                             rms_norm_bwd=t["lib_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()})
        for name, key, err, lib in (
                ("rms_norm_fwd", "fwd", max_err(y, y_r), t["lib_fwd"]),
                ("rms_norm_bwd_dx", "dx", max_err(dx, dx_r), t["lib_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                max_err=err, kernel_ms=t[key], plain_ms=t[key + "_plain"],
                library_ms=lib, bound_ms=bounds[key][0],
                bound_by=bounds[key][1]))
        del x, g, y, y_r, dx, dx_r, lx, lw, o
        torch.cuda.empty_cache()


def check_varlen_attention(dtype, device, rows):
    """The segment-id variant of the forward, dq and dk/dv kernels on each
    pack (B = 1, the (H, T, D) layout flash_attn_unpadded hands them)
    against their plain twins, run in groups of kv heads; kernel, plain,
    library (SDPA, causal, per document, summed: forward, forward +
    backward, backward alone) and bound times, the bound counting the
    pairs that share a document."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    for case, lens, h, hkv in VARLEN_PACKS:
        t = sum(lens)
        q, do = (_rand(gen, (h, t, HEAD_DIM), dtype, device)
                 for _ in range(2))
        k, v = (_rand(gen, (hkv, t, HEAD_DIM), dtype, device)
                for _ in range(2))
        ids = pack_ids(lens, device)
        seg_q = ids.repeat(h, 1)
        seg_kv = ids.repeat(hkv, 1)
        kw = dict(causal=True, n_heads=h, n_kv_heads=hkv, seg_q=seg_q,
                  seg_kv=seg_kv)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (out.float() * do.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

        def plain_fwd():
            return in_kv_groups(lambda qr, kr, n: fa.flash_attention_fwd_ref(
                q[qr], k[kr], v[kr], True, None, n * h // hkv, n, seg_q[qr],
                seg_kv[kr]), h, hkv)

        def plain_dq():
            return in_kv_groups(
                lambda qr, kr, n: fa.flash_attention_bwd_dq_ref(
                    q[qr], k[kr], v[kr], do[qr], lse[qr], delta[qr], True,
                    None, n * h // hkv, n, seg_q[qr], seg_kv[kr]), h, hkv)

        def plain_dkv():
            return in_kv_groups(
                lambda qr, kr, n: fa.flash_attention_bwd_dkv_ref(
                    q[qr], k[kr], v[kr], do[qr], lse[qr], delta[qr], True,
                    None, n * h // hkv, n, seg_q[qr], seg_kv[kr]), h, hkv)

        out_r, lse_r = plain_fwd()
        dq_r, (dk_r, dv_r) = plain_dq(), plain_dkv()
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        tag = f"{case} {DTYPE_NAME[dtype]}"
        out_excess, lse_err = excess(out, out_r, rtol), max_err(lse, lse_r)
        dq_rel = rel_err(dq, dq_r)
        dkv_rel = max(rel_err(dk, dk_r), rel_err(dv, dv_r))
        require(out_excess <= atol, f"flash fwd seg {tag}: {out_excess} "
                f"over {rtol} |ref|")
        require(lse_err <= LSE_TOL[dtype], f"flash fwd seg {tag}: lse "
                f"{lse_err}")
        require(dq_rel <= GRAD_TOL[dtype], f"flash dq seg {tag}: {dq_rel}")
        require(dkv_rel <= GRAD_TOL[dtype], f"flash dk/dv seg {tag}: "
                f"{dkv_rel}")
        errs = dict(fwd=max(max_err(out, out_r), lse_err),
                    dq=max_err(dq, dq_r),
                    dkv=max(max_err(dk, dk_r), max_err(dv, dv_r)))
        del out_r, lse_r, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()

        bwd = (q, k, v, do, lse, delta)
        tm = dict(
            fwd=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                        iters=10, warmup=2),
            dq=time_ms(lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                       iters=10, warmup=2),
            dkv=time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                        iters=10, warmup=2),
            fwd_plain=time_ms(plain_fwd, iters=3, warmup=1),
            dq_plain=time_ms(plain_dq, iters=3, warmup=1),
            dkv_plain=time_ms(plain_dkv, iters=3, warmup=1))
        starts = np.cumsum((0,) + lens)
        docs = [tuple(x[:, s0:s0 + n][None] for x in (q, k, v, do))
                for s0, n in zip(starts, lens)]
        tm["sdpa_fwd"] = time_ms(lambda: [sdpa(a, b_, c, is_causal=True)
                                          for a, b_, c, _ in docs],
                                 iters=10, warmup=2)
        leaves = [[x.clone().requires_grad_(True) for x in d[:3]]
                  for d in docs]

        def sdpa_fwd_bwd():
            for ls, d in zip(leaves, docs):
                torch.autograd.grad(sdpa(*ls, is_causal=True), ls, d[3])

        tm["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters=10, warmup=2)
        outs = [sdpa(*ls, is_causal=True) for ls in leaves]
        tm["sdpa_bwd"] = time_ms(lambda: [torch.autograd.grad(
            o, ls, d[3], retain_graph=True) for o, ls, d in zip(
                outs, leaves, docs)], iters=10, warmup=2)
        del docs, leaves, outs

        elem = q.element_size()
        pairs = h * sum(n * (n + 1) // 2 for n in lens)   # same document
        fwd_ops = 4.0 * pairs * HEAD_DIM
        stats = 4 * 2 * h * t                             # lse, delta f32
        ids_bytes = 4 * (h + hkv) * t
        bounds = dict(
            fwd=bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                         + 4 * h * t + ids_bytes, fwd_ops, dtype),
            dq=bound_ms(elem * (3 * q.numel() + k.numel() + v.numel())
                        + stats + ids_bytes, 1.5 * fwd_ops, dtype),
            dkv=bound_ms(elem * (2 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats + ids_bytes,
                         2.0 * fwd_ops, dtype))
        emit("train_varlen", kernel="flash_attention_seg", case=case,
             doc_lens=list(lens), H=h, Hkv=hkv, D=HEAD_DIM,
             dtype=DTYPE_NAME[dtype], out_excess=out_excess, out_atol=atol,
             out_rtol=rtol, lse_max_err=lse_err, dq_rel_err=dq_rel,
             dkv_rel_err=dkv_rel, grad_tol=GRAD_TOL[dtype],
             causal_pairs_of_the_pack=h * t * (t + 1) // 2,
             pairs_in_documents=pairs,
             kernel_ms=dict(fwd=tm["fwd"], dq=tm["dq"], dkv=tm["dkv"]),
             plain_ms=dict(fwd=tm["fwd_plain"], dq=tm["dq_plain"],
                           dkv=tm["dkv_plain"]),
             library_ms=dict(sdpa_fwd=tm["sdpa_fwd"],
                             sdpa_fwd_bwd=tm["sdpa_fwd_bwd"],
                             sdpa_bwd=tm["sdpa_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()},
             bound_frac={key: bounds[key][0] / tm[key]
                         for key in BOUND_FRAC_KEYS})
        for name, key, lib in (
                ("flash_attention_fwd_seg", "fwd", tm["sdpa_fwd"]),
                ("flash_attention_bwd_dq_seg", "dq", tm["sdpa_bwd"]),
                ("flash_attention_bwd_dkv_seg", "dkv", tm["sdpa_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                max_err=errs[key], kernel_ms=tm[key],
                plain_ms=tm[key + "_plain"], library_ms=lib,
                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                **frac(bounds, tm, key)))
        del q, k, v, do, out, lse, delta, dq, dk, dv
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
        for check in (check_flash_prefill, check_paged_attention,
                      check_paged_chunk_attention, check_fused_block_decode,
                      check_fused_multi_block_decode):
            done = len(results)
            check(dtype, device, results)
            for r in results[done:]:
                emit("kernels", **r)

    counts = run_serve(device)
    run_parity(device)

    train_rows = []
    lse_counts: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_attention(dtype, device, train_rows)
        for n, c in check_flash_with_lse(dtype, device).items():
            lse_counts[n] = lse_counts.get(n, 0) + c
    train_counts, train = run_train(device)
    remat_counts = run_train_remat(device, train)
    fit_counts = run_fit(device, train)
    run_train_parity(device)

    varlen_counts = run_train_varlen(device)
    varlen_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        check_rms_norm(dtype, device, varlen_rows)
        check_varlen_attention(dtype, device, varlen_rows)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    summary = []
    for name, (source, replaces) in SOURCES.items():
        if name in TRAIN_KERNELS:
            rows = [r for r in train_rows if r["kernel"] == name
                    and r["dtype"] == "bf16"]
            main_row = rows[0]       # Llama-2-7B heads, S = 4096, bf16
            launches = fit_counts[name]          # this slice's main path
            by_path = dict(train=train_counts[name],
                           train_remat=remat_counts[name],
                           fit=launches, with_lse=lse_counts[name])
        elif name in VARLEN_KERNELS:
            rows = [r for r in varlen_rows if r["kernel"] == name
                    and r["dtype"] == "bf16"]
            main_row = rows[0]       # 7B width / the 8192-token pack, bf16
            launches = varlen_counts[name]
        else:
            rows = [r for r in results if r["kernel"] == name
                    and r["dtype"] == "bf16" and "kernel_ms" in r]
            main_row = rows[-1]      # the largest serving shape in bf16
            launches = counts[name]  # serve and serve_long, every run
        require(launches > 0, f"{name}: no launch on the main paths")
        if name not in TRAIN_KERNELS:
            by_path = None
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_err"] for r in rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            **({"bound_frac": main_row["bound_frac"]}
               if "bound_frac" in main_row else {}),
            **({"launches_by_path": by_path} if by_path else {})))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
