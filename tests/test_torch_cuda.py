"""The port's CUDA kernels on the card, at shapes the smoke run
(``chip_smoke.py``, Llama-2-7B: MHA, head_dim 128, batch 4) leaves out:
GQA, head_dim 64, small pages, batches that span several GEMV batch
tiles, ragged and page-aligned lengths, idle null-page rows; for the flash
attention kernels of the training path S = 1, S = 129 (one row past a
tile), non-causal, head_dim 64 and 96, and Sq != Skv; for the chunk
attention mid-page and page-aligned starts, two sequences, rows past the
block table and rep 32, and for its bf16 tensor-core route (shared with the
prefill attention) head dims 33 to 128, pages of 8 to 64, an empty prefix
and a peaked softmax on native and int8 pools, held to 1e-3 + one bf16 ulp; for the N-layer decode groups of 1 to 4 layers,
also held bit for bit to the one-layer kernel's chain; for the quantized
variants (int8 pools in the decode, chunk and fused kernels, int4 tiles in
the N-layer kernel) GQA, idle rows, int4 tiles that straddle q|k|v or 8
columns, and the int8 N-layer kernel bit for bit against the one-layer
kernel's chain; for the fused RMSNorm widths 64 to 40000 (above the TPU
kernel's VMEM cap) and 1001 (one element a load), 1, 7 and 8192 rows; for
the flash kernels' segment-id variant document boundaries inside a
64-row tile, a padding id no key carries, GQA, head_dim 64 and 128,
lengths that are not a multiple of 64, and the public varlen entry points
against their CPU run; for the bf16 forward and backward on the tensor
cores head dims 33 to 128, S = 1 to 1000, Sq != Skv, rep 1 to 8, a peaked
softmax and segment ids in no order; for the split-KV decode attention
native and int8 pools, B = 1 to 8 with idle rows, lengths 0 to 4096 around
page and part boundaries, pages of 8 to 64, rep 1 to 16 and head dims 33
to 128, and its output bits as they were before the routine took the
fused decode's length offset; for the fused decode kernels' attention
phase (the append, then the split-KV routine over seq_lens + 1) a
4096-token table in 16 parts, lengths whose + 1 ends or starts a part or a
page or fills the table, Llama-2-70B heads, head dim 64 with two head
groups, native and int8 pools, native and int4 weights, fp32 and bf16,
each call repeated bit for bit, and two idle rows on the null page that
each keep their own token. Each kernel is held to its plain PyTorch version
on the same card tensors (fp32 1e-4, bf16 2e-2 abs: the kernels sum in
f32 in another order, and bf16 rounds once more at the output; the
RMSNorm outputs within 1e-3 + one bf16 ulp); the wrappers' input checks
and launch counters are checked too, a tiny GQA engine on the card is held to the same
engine on the CPU, and so is the bf16 ``fused_linear_cross_entropy``
(whose card path makes its f32 logits with one GEMM). The serving
engine's CUDA graphs: each decode rung and the chunk program captured once
per engine, a replay equal to the eager step bit for bit, exact launch
counts, pools at other addresses refused; a page spilled to pinned host
memory and restored bit for bit and in place, and decode and chunk graphs
that keep replaying across spills and restores with the streams of a pool
that never spills. Replay recovery: faults in prefill, chunks and decode
keep every capture and the pools' addresses, with fp32 streams equal to a
fault-free run's; ``serving_decode_steps`` counts graph replays; no
telemetry write and no fault check runs inside a capture; a kernel error
is not replayed; the allocator watermarks under the JAX package's stat
names.

Every test needs the card and skips without one. On the GPU machine, which
has no JAX (so the repository's conftest, which imports it, is skipped):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import hashlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_block_decode as fb
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def _err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


def _tables(rng, seq_lens, extra, page, maxp, dev):
    """Shuffled block tables over a pool whose page 0 is the null page; an
    idle row (length 0) keeps an all-zero table."""
    num_pages = 1 + len(seq_lens) * maxp
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((len(seq_lens), maxp), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        k = -(-(n + extra) // page) if n else 0
        bt[i, :k] = perm[used:used + k]
        used += k
    return torch.from_numpy(bt).to(dev), num_pages


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,hkv,d,cur_len", [
    (2, 50, 301, 8, 2, 64, 290),     # GQA, cur_len > S, ragged tail
    (1, 2, 2, 4, 4, 128, 2),         # the shortest prompt
    (1, 129, 129, 2, 1, 128, 129),   # one row past a query tile
    (3, 64, 64, 4, 2, 96, 64),       # head_dim not a power of two
])
def test_flash_prefill_matches_plain(dev, dtype, b, s, t, h, hkv, d,
                                     cur_len):
    rng = np.random.default_rng(s * 7 + t)
    q = _rand(rng, (b, s, h, d), dtype, dev)
    k = _rand(rng, (b, t, hkv, d), dtype, dev)
    v = _rand(rng, (b, t, hkv, d), dtype, dev)
    got = da.flash_prefill(q, k, v, cur_len)
    want = da.flash_prefill_ref(q, k, v, cur_len)
    assert got.shape == want.shape and got.dtype == dtype
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,hkv,d,page,seq_lens", [
    (8, 2, 64, 16, (32, 0, 1, 47, 16)),   # page-aligned, idle, ragged
    (4, 4, 128, 64, (200, 64, 0)),
    (16, 1, 64, 8, (5, 63)),              # rep 16, many small pages
])
def test_paged_attention_matches_plain(dev, dtype, h, hkv, d, page,
                                       seq_lens):
    rng = np.random.default_rng(len(seq_lens) + h)
    maxp = -(-max(seq_lens) // page) + 1
    bt, num_pages = _tables(rng, seq_lens, 0, page, maxp, dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    kp = _rand(rng, (hkv, num_pages, page, d), dtype, dev)
    vp = _rand(rng, (hkv, num_pages, page, d), dtype, dev)
    q = _rand(rng, (len(seq_lens), h, d), dtype, dev)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    want = pa.paged_attention_ref(q, kp, vp, bt, sl)
    assert _err(got, want) <= TOL[dtype]
    idle = sl == 0
    assert not got[idle].any()


def _block(rng, b, hidden, nh, nkv, inter, page, maxp, seq_lens, dtype,
           dev):
    d = hidden // nh

    def mat(k, n):
        return _rand(rng, (k, n), dtype, dev, 0.5 / np.sqrt(k))

    def norm():
        return (1.0 + 0.1 * torch.from_numpy(
            rng.standard_normal(hidden).astype(np.float32))).to(dev, dtype)

    w = fb.BlockDecodeWeights(
        ln1=norm(), wq=mat(hidden, nh * d), wk=mat(hidden, nkv * d),
        wv=mat(hidden, nkv * d), wo=mat(nh * d, hidden), ln2=norm(),
        wg=mat(hidden, inter), wu=mat(hidden, inter), wd=mat(inter, hidden))
    bt, num_pages = _tables(rng, seq_lens, 1, page, maxp, dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    kp = _rand(rng, (nkv, num_pages, page, d), dtype, dev)
    vp = _rand(rng, (nkv, num_pages, page, d), dtype, dev)
    x = _rand(rng, (b, hidden), dtype, dev, 0.3)
    return x, w, kp, vp, bt, sl


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,nh,nkv", [(1, 4, 2), (3, 4, 4), (9, 8, 2),
                                      (17, 4, 1)])
def test_fused_block_decode_matches_plain(dev, dtype, b, nh, nkv):
    """Batches of 1, 3, 9 and 17 rows run every GEMV batch tile (1, 4 and
    8 rows, and more than one tile); lengths hit a page's last slot, a new
    page, and one idle null-page row (several idle rows would all write
    the null page's slot 0, in no defined order)."""
    rng = np.random.default_rng(b * 31 + nh)
    base = (15, 16, 31, 1, 40, 7, 2)
    seq_lens = [0] + [base[i % len(base)] for i in range(b - 1)]
    x, w, kp, vp, bt, sl = _block(rng, b, 256, nh, nkv, 512, 16, 4,
                                  seq_lens, dtype, dev)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    got, gk, gv = fb.fused_block_decode(x, w, kp.clone(), vp.clone(), bt,
                                        sl, **kw)
    want, wk, wv = fb.fused_block_decode_ref(x, w, kp.clone(), vp.clone(),
                                             bt, sl, **kw)
    assert _err(got, want) <= TOL[dtype]
    assert _err(gk, wk) <= TOL[dtype]
    assert _err(gv, wv) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,h,hkv,d,page,maxp,starts", [
    (256, 8, 8, 128, 64, 8, (0,)),       # first chunk, MHA
    (100, 8, 2, 128, 64, 8, (300,)),     # ragged chunk, mid-page, GQA
    (64, 16, 2, 64, 16, 6, (64, 37)),    # two sequences, small pages
    (40, 4, 4, 128, 16, 4, (40,)),       # 16 rows past the table's end
    (33, 32, 1, 96, 8, 12, (65,)),       # rep 32, head_dim 96
])
def test_paged_chunk_attention_matches_plain(dev, dtype, s, h, hkv, d, page,
                                             maxp, starts):
    """The chunk written first (write-then-attend), then the kernel against
    the plain version; the diagonal mid-page, page-aligned and past the
    block table (the pad rows attend to the whole table)."""
    rng = np.random.default_rng(s + h + page)
    b = len(starts)
    bt, num_pages = _tables(rng, [maxp * page - 1] * b, 0, page, maxp, dev)
    kp = _rand(rng, (hkv, num_pages, page, d), dtype, dev)
    vp = _rand(rng, (hkv, num_pages, page, d), dtype, dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    k_new = _rand(rng, (b, s, hkv, d), dtype, dev)
    v_new = _rand(rng, (b, s, hkv, d), dtype, dev)
    pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
    q = _rand(rng, (b, s, h, d), dtype, dev)
    got = pa.paged_chunk_attention(q, kp, vp, bt, st)
    want = pa.paged_chunk_attention_ref(q, kp, vp, bt, st)
    assert got.shape == want.shape and got.dtype == dtype
    assert _err(got, want) <= TOL[dtype]


# bf16 chunk and prefill attention run on the tensor cores
# (csrc/prefill_mma.cuh); these cases are held to chip_smoke.py's OUT_TOL in
# bf16: |got - want| within 1e-3 + one bf16 ulp of |want| elementwise (both
# round an f32 value that differs only in summation order)
MMA_TOL = (1e-3, 2.0 ** -7)


def _excess(got, want, rtol):
    torch.cuda.synchronize()
    want = want.float()
    return float(((got.float() - want).abs() - rtol * want.abs()).max())


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("s,h,hkv,d,page,maxp,starts,qscale", [
    (256, 8, 8, 128, 64, 64, (3328,), 8.0),   # peaked q, start 3328
    (256, 8, 8, 128, 64, 8, (0,), 1.0),       # empty prefix
    (100, 8, 2, 64, 16, 40, (301,), 1.0),     # rep 4, mid-page, 3 key tiles
    (77, 4, 4, 96, 8, 50, (123,), 8.0),       # rep 1, pages of 8, peaked
    (33, 32, 1, 128, 16, 12, (150,), 1.0),    # rep 32
    (64, 8, 2, 128, 16, 8, (64, 37), 1.0),    # B = 2, different starts
    (40, 4, 4, 128, 16, 4, (40,), 1.0),       # 16 rows past the table
    (50, 4, 2, 72, 16, 8, (29,), 8.0),        # head dim 72 (padded to 96)
    (20, 4, 2, 36, 8, 8, (13,), 1.0),         # 8-byte (int8: 4) copies
    (17, 4, 4, 33, 8, 6, (5,), 8.0),          # odd head dim: plain copies
])
def test_paged_chunk_attention_bf16_tensor_core_cases(dev, pool, s, h, hkv,
                                                      d, page, maxp, starts,
                                                      qscale):
    """What the tensor-core route can get wrong: head dims 33 to 128,
    pages of 8, 16 and 64, the diagonal mid-page and across key tiles, rows
    past the table, rep 1 to 32, two sequences, an empty prefix, a peaked
    softmax; native and int8 pools."""
    rng = np.random.default_rng(s * 3 + d + page)
    b = len(starts)
    bt, num_pages = _tables(rng, [maxp * page - 1] * b, 0, page, maxp, dev)
    kp, vp = (_rand(rng, (hkv, num_pages, page, d), torch.bfloat16, dev)
              for _ in range(2))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    k_new, v_new = (_rand(rng, (b, s, hkv, d), torch.bfloat16, dev)
                    for _ in range(2))
    pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
    if pool == "int8":
        kp, vp = (pa.QuantizedPages(*pa.quantize_kv_rows(x)) for x in (kp, vp))
    q = _rand(rng, (b, s, h, d), torch.bfloat16, dev, qscale)
    kernels.reset_launches()
    got = pa.paged_chunk_attention(q, kp, vp, bt, st)
    name = "paged_chunk_attention" + ("_int8" if pool == "int8" else "")
    assert kernels.launch_counts()[name] == 1
    want = pa.paged_chunk_attention_ref(q, kp, vp, bt, st)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    atol, rtol = MMA_TOL
    assert _excess(got, want, rtol) <= atol


@pytest.mark.parametrize("b,s,t,h,hkv,d,cur_len,qscale", [
    (1, 2, 400, 8, 2, 128, 350, 1.0),
    (1, 63, 400, 8, 8, 128, 300, 1.0),
    (2, 64, 200, 4, 1, 64, 130, 1.0),
    (1, 65, 130, 8, 2, 96, 129, 1.0),
    (1, 300, 512, 8, 8, 128, 450, 1.0),
    (1, 256, 256, 32, 32, 128, 256, 8.0),     # chip_smoke's shape, peaked
    (1, 40, 100, 4, 2, 33, 90, 8.0),          # odd head dim, peaked
])
def test_flash_prefill_bf16_tensor_core_cases(dev, b, s, t, h, hkv, d,
                                              cur_len, qscale):
    """S = 2, 63, 64, 65 and 300 against a longer cache (cur_len > S), a
    peaked softmax, an odd head dim; held to MMA_TOL."""
    rng = np.random.default_rng(s * 5 + t + d)
    q = _rand(rng, (b, s, h, d), torch.bfloat16, dev, qscale)
    k = _rand(rng, (b, t, hkv, d), torch.bfloat16, dev)
    v = _rand(rng, (b, t, hkv, d), torch.bfloat16, dev)
    got = da.flash_prefill(q, k, v, cur_len)
    want = da.flash_prefill_ref(q, k, v, cur_len)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    atol, rtol = MMA_TOL
    assert _excess(got, want, rtol) <= atol


def test_write_paged_prompt_at_drops_past_the_table_on_the_card(dev):
    """A padded chunk past the table changes no slot but its own: the last
    page keeps what was there before the chunk's overflow."""
    rng = np.random.default_rng(4)
    bt, num_pages = _tables(rng, (31,), 0, 8, 4, dev)
    kp = _rand(rng, (2, num_pages, 8, 16), torch.float32, dev)
    before = kp.clone()
    k_new = _rand(rng, (1, 24, 2, 16), torch.float32, dev)
    st = torch.tensor([20], dtype=torch.int32, device=dev)
    pa.write_paged_prompt_at(kp, kp.clone(), k_new, k_new, bt, st)
    pages = bt[0].long()
    got = kp[:, pages].reshape(2, 32, 16)
    assert torch.equal(got[:, :20], before[:, pages].reshape(2, 32, 16)
                       [:, :20])
    assert torch.equal(got[:, 20:], k_new[0, :12].transpose(0, 1))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,b,nh,nkv", [(1, 3, 4, 2), (2, 9, 8, 2),
                                        (4, 4, 4, 4), (3, 1, 4, 1)])
def test_fused_multi_block_decode_matches_plain_and_the_chain(dev, dtype, n,
                                                              b, nh, nkv):
    """N stacked layers in one launch against the plain version, and bit
    for bit against N launches of the one-layer kernel (the merged GEMVs
    reduce every column as the separate ones do)."""
    rng = np.random.default_rng(n * 13 + b)
    base = (15, 16, 31, 1, 40, 7, 2)
    seq_lens = [0] + [base[i % len(base)] for i in range(b - 1)]
    layers, pools = [], []
    for _ in range(n):
        x, w, kp, vp, bt, sl = _block(rng, b, 256, nh, nkv, 512, 16, 4,
                                      seq_lens, dtype, dev)
        layers.append(w)
        pools.append((kp, vp))
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    mw = fb.stack_block_weights(layers)

    def fresh():
        return [k.clone() for k, _ in pools], [v.clone() for _, v in pools]

    kernels.reset_launches()
    got, gk, gv = fb.fused_multi_block_decode(x, mw, *fresh(), bt, sl, **kw)
    assert kernels.launch_counts()["fused_multi_block_decode"] == 1
    want, wk, wv = fb.fused_multi_block_decode_ref(x, mw, *fresh(), bt, sl,
                                                   **kw)
    assert got.dtype == dtype
    assert _err(got, want) <= TOL[dtype]
    for i in range(n):
        assert _err(gk[i], wk[i]) <= TOL[dtype]
        assert _err(gv[i], wv[i]) <= TOL[dtype]
    out, ck, cv = x, *fresh()
    for i, w in enumerate(layers):
        out, ck[i], cv[i] = fb.fused_block_decode(out, w, ck[i], cv[i], bt,
                                                  sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    for i in range(n):
        assert torch.equal(gk[i], ck[i]) and torch.equal(gv[i], cv[i])


def test_each_launch_counts_once(dev):
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    q = _rand(rng, (1, 4, 2, 64), torch.float32, dev)
    da.flash_prefill(q, q, q, 4)
    da.flash_prefill_ref(q, q, q, 4)
    bt, num_pages = _tables(rng, (9,), 0, 8, 2, dev)
    kp = _rand(rng, (2, num_pages, 8, 64), torch.float32, dev)
    sl = torch.tensor([9], dtype=torch.int32, device=dev)
    pa.paged_attention(q[:, 0], kp, kp, bt, sl)
    pa.paged_attention(q[:, 0], kp, kp, bt, sl)
    counts = kernels.launch_counts()
    assert counts.pop("flash_prefill") == 1
    assert counts.pop("paged_attention") == 2
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("case", ["fp16", "noncontiguous", "int64-tables",
                                  "cpu-pool"])
def test_wrappers_refuse_what_the_kernel_does_not_take(dev, case):
    rng = np.random.default_rng(1)
    q = _rand(rng, (2, 4, 64), torch.float32, dev)
    bt, num_pages = _tables(rng, (9, 3), 0, 8, 2, dev)
    kp = _rand(rng, (4, num_pages, 8, 64), torch.float32, dev)
    sl = torch.tensor([9, 3], dtype=torch.int32, device=dev)
    if case == "fp16":
        q, kp = q.half(), kp.half()
    elif case == "noncontiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "int64-tables":
        bt = bt.long()
    else:
        kp = kp.cpu()
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        pa.paged_attention(q, kp, kp, bt, sl)
    assert kernels.launch_counts()["paged_attention"] == 0


def _card_vs_cpu_streams(dev, flag_values, prefill_chunk=None):
    """A tiny GQA Llama in fp32 served on the card and on the CPU under
    ``flag_values``: each request's tokens and the logits rows they were
    taken from, CPU first."""
    from paddle_tpu_torch import flags
    cfg = LlamaConfig.tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", generator=seed(3))
    card = LlamaForCausalLM(cfg, device=dev, generator=seed(3, dev))
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 13, 7, 16)]
    streams = []
    flags.set_flags(flag_values)
    try:
        for model in (cpu, card):
            eng = ServingEngine(model, max_batch=2, page_size=8,
                                max_seq_len=32, prefill_chunk=prefill_chunk,
                                record_logits=True)
            rids = [eng.submit(p, 6) for p in prompts]
            out = eng.run()
            streams.append([(out[r], eng.logits[r]) for r in rids])
    finally:
        flags.reset_flags()
    return streams


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_engine_on_the_card_matches_the_cpu(dev, fused):
    """A tiny GQA Llama in fp32 served on the card and on the CPU: the
    logits each token was taken from agree to 1e-4, and the greedy tokens
    agree wherever the CPU's top-2 gap is wider than that."""
    streams = _card_vs_cpu_streams(dev, {"fused_block_decode": fused})
    _assert_streams_agree(streams)


def _assert_streams_agree(streams):
    for (toks_c, rows_c), (toks_g, rows_g) in zip(*streams):
        for j, (tc, tg) in enumerate(zip(toks_c, toks_g)):
            assert np.max(np.abs(rows_c[j] - rows_g[j])) <= 1e-4
            if tc != tg:
                top2 = np.sort(rows_c[j])[-2:]
                assert top2[1] - top2[0] <= 1e-4
                break


@pytest.mark.parametrize("layers", [1, 2])
def test_chunked_engine_on_the_card_matches_the_cpu(dev, layers):
    """The same with 8-token prefill chunks (the 9, 13 and 16-token prompts
    go through the chunk kernel) and the fused decode 1 or 2 layers a
    launch (the N-layer kernel)."""
    kernels.reset_launches()
    streams = _card_vs_cpu_streams(dev, {"fused_block_layers": layers},
                                   prefill_chunk=8)
    counts = kernels.launch_counts()
    assert counts["paged_chunk_attention"] == 2 * (2 + 2 + 2)
    assert (counts["fused_multi_block_decode"] > 0) == (layers > 1)
    _assert_streams_agree(streams)


def _rel(a, b):
    """max |a - b| over max(max |b|, 1): relative for gradients of order 1
    and more, absolute for the near-zero ones (S = 1: p = 1 and
    dp - delta = 0, so dq and dk are rounding noise)."""
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1.0))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal", [
    (1, 1, 1, 2, 2, 128, True),        # S = 1
    (2, 129, 129, 4, 2, 128, True),    # one row past a 64-row tile, GQA
    (1, 200, 200, 4, 4, 128, False),   # non-causal, ragged
    (2, 130, 130, 8, 2, 64, True),     # head_dim 64, rep 4
    (1, 96, 96, 2, 1, 96, True),       # head_dim padded to 128
    (1, 70, 150, 2, 2, 64, True),      # Sq < Skv, top-left causal
    (1, 150, 70, 2, 2, 64, False),     # Sq > Skv
])
def test_flash_attention_kernels_match_plain(dev, dtype, b, sq, skv, h,
                                             hkv, d, causal):
    """Forward (out, lse), dq and dk/dv against their plain versions on the
    same card tensors, and the autograd Function against autograd of the
    dense reference."""
    rng = np.random.default_rng(sq * 3 + skv + d)
    q = _rand(rng, (b * h, sq, d), dtype, dev)
    k = _rand(rng, (b * hkv, skv, d), dtype, dev)
    v = _rand(rng, (b * hkv, skv, d), dtype, dev)
    do = _rand(rng, (b * h, sq, d), dtype, dev)
    kw = dict(causal=causal, n_heads=h, n_kv_heads=hkv)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _err(out, out_r) <= TOL[dtype]
    assert _err(lse, lse_r) <= TOL[dtype]
    delta = (out_r.float() * do.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
    dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse_r, delta, **kw)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse_r, delta,
                                                **kw)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == dtype
        assert _rel(got, want) <= TOL[dtype]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(
        fa.flash_attention_ref(*ref_leaves, **kw), ref_leaves, do)
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) <= TOL[dtype]


def test_flash_attention_backward_repeats_bit_for_bit(dev):
    """dk/dv own their tiles (no atomics): two runs agree exactly."""
    rng = np.random.default_rng(5)
    q = _rand(rng, (8, 300, 128), torch.bfloat16, dev)
    k = _rand(rng, (2, 300, 128), torch.bfloat16, dev)
    do = _rand(rng, (8, 300, 128), torch.bfloat16, dev)
    kw = dict(causal=True, n_heads=4, n_kv_heads=1)
    out, lse = fa.flash_attention_fwd(q, k, k, **kw)
    delta = (out.float() * do.float()).sum(-1)
    first = fa.flash_attention_bwd_dkv(q, k, k, do, lse, delta, **kw)
    second = fa.flash_attention_bwd_dkv(q, k, k, do, lse, delta, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["fp16", "noncontiguous", "cpu-k",
                                  "head-dim-256"])
def test_flash_wrappers_refuse_what_the_kernel_does_not_take(dev, case):
    rng = np.random.default_rng(2)
    d = 256 if case == "head-dim-256" else 64
    q = _rand(rng, (4, 32, d), torch.float32, dev)
    k = _rand(rng, (4, 32, d), torch.float32, dev)
    if case == "fp16":
        q, k = q.half(), k.half()
    elif case == "noncontiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "cpu-k":
        k = k.cpu()
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_fwd(q, k, k, n_heads=1)
    assert kernels.launch_counts()["flash_attention_fwd"] == 0


@pytest.mark.parametrize("transpose_y", [False, True], ids=["untied", "tied"])
def test_fused_linear_cross_entropy_bf16_card_matches_cpu(dev, transpose_y):
    """bf16 loss on the card (one GEMM with f32 logits out) against the
    same loss on the CPU (inputs widened to f32): both keep f32 logits,
    so the losses agree within 1e-4; the bf16 grads within 1e-2 of their
    largest element."""
    from paddle_tpu_torch.incubate.nn import functional as FF
    rng = np.random.default_rng(8)
    hidden = _rand(rng, (2, 300, 128), torch.bfloat16, "cpu")
    weight = _rand(rng, (1000, 128) if transpose_y else (128, 1000),
                   torch.bfloat16, "cpu", scale=0.3)
    labels = torch.from_numpy(rng.integers(0, 1000, (2, 300)))
    labels[0, :7] = -100
    results = []
    for d in ("cpu", dev):
        h, w = (t.to(d, copy=True).requires_grad_(True)
                for t in (hidden, weight))
        loss = FF.fused_linear_cross_entropy(h, w, labels.to(d),
                                             transpose_y=transpose_y,
                                             chunk_tokens=256)
        loss.backward()
        results.append((loss.detach().cpu(), h.grad.cpu(), w.grad.cpu()))
    (l_cpu, *g_cpu), (l_card, *g_card) = results
    assert l_card.dtype == torch.float32
    assert abs(float(l_card) - float(l_cpu)) <= 1e-4
    for got, want in zip(g_card, g_cpu):
        err = (got.float() - want.float()).abs().max()
        assert float(err) <= 1e-2 * float(want.float().abs().max())


# ------------------------------------------------ int8 pools, int4 tiles
# the appended int8 rows: the kernel's and the plain version's f32 k/v may
# differ in the last bits (another summation order), so a payload may
# differ by 1 and a scale by relative 1e-6 (fp32) or one bf16 step of the
# row's amax (bf16, where the k/v round to bf16 first)
SCALE_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}


def _q(pool):
    return pa.QuantizedPages(*pa.quantize_kv_rows(pool))


def _assert_rows_agree(got, want, dtype):
    torch.cuda.synchronize()
    assert int((got.q.int() - want.q.int()).abs().max()) <= 1
    rel = ((got.scale - want.scale).abs()
           / want.scale.abs().clamp_min(1e-30))
    assert float(rel.max()) <= SCALE_RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,hkv,d,page,seq_lens", [
    (8, 2, 64, 16, (32, 0, 1, 47, 16)),   # page-aligned, idle, ragged
    (16, 1, 64, 8, (5, 63)),              # rep 16, many small pages
])
def test_paged_attention_int8_matches_plain(dev, dtype, h, hkv, d, page,
                                            seq_lens):
    rng = np.random.default_rng(len(seq_lens) + h + 1)
    maxp = -(-max(seq_lens) // page) + 1
    bt, num_pages = _tables(rng, seq_lens, 0, page, maxp, dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    kp = _q(_rand(rng, (hkv, num_pages, page, d), dtype, dev))
    vp = _q(_rand(rng, (hkv, num_pages, page, d), dtype, dev))
    q = _rand(rng, (len(seq_lens), h, d), dtype, dev)
    kernels.reset_launches()
    got = pa.paged_attention(q, kp, vp, bt, sl)
    counts = kernels.launch_counts()
    assert counts["paged_attention_int8"] == 1
    assert counts["paged_attention"] == 0
    want = pa.paged_attention_ref(q, kp, vp, bt, sl)
    assert got.dtype == dtype
    assert _err(got, want) <= TOL[dtype]
    assert not got[sl == 0].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,h,hkv,d,page,maxp,starts", [
    (100, 8, 2, 128, 64, 8, (300,)),     # ragged chunk, mid-page, GQA
    (40, 4, 4, 128, 16, 4, (40,)),       # 16 rows past the table's end
])
def test_paged_chunk_attention_int8_matches_plain(dev, dtype, s, h, hkv, d,
                                                  page, maxp, starts):
    rng = np.random.default_rng(s + h + page + 1)
    b = len(starts)
    bt, num_pages = _tables(rng, [maxp * page - 1] * b, 0, page, maxp, dev)
    kp = _q(_rand(rng, (hkv, num_pages, page, d), dtype, dev))
    vp = _q(_rand(rng, (hkv, num_pages, page, d), dtype, dev))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    k_new = _rand(rng, (b, s, hkv, d), dtype, dev)
    v_new = _rand(rng, (b, s, hkv, d), dtype, dev)
    pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
    q = _rand(rng, (b, s, h, d), dtype, dev)
    kernels.reset_launches()
    got = pa.paged_chunk_attention(q, kp, vp, bt, st)
    assert kernels.launch_counts()["paged_chunk_attention_int8"] == 1
    want = pa.paged_chunk_attention_ref(q, kp, vp, bt, st)
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,nh,nkv", [(3, 4, 2), (9, 8, 2)])
def test_fused_block_decode_int8_matches_plain(dev, dtype, b, nh, nkv):
    rng = np.random.default_rng(b * 31 + nh + 1)
    base = (15, 16, 31, 1, 40, 7, 2)
    seq_lens = [0] + [base[i % len(base)] for i in range(b - 1)]
    x, w, kp, vp, bt, sl = _block(rng, b, 256, nh, nkv, 512, 16, 4,
                                  seq_lens, dtype, dev)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    kernels.reset_launches()
    got, gk, gv = fb.fused_block_decode(x, w, _q(kp), _q(vp), bt, sl, **kw)
    assert kernels.launch_counts()["fused_block_decode_int8"] == 1
    want, wk, wv = fb.fused_block_decode_ref(x, w, _q(kp), _q(vp), bt, sl,
                                             **kw)
    assert _err(got, want) <= TOL[dtype]
    _assert_rows_agree(gk, wk, dtype)
    _assert_rows_agree(gv, wv, dtype)


def _int4_group(layers, tiles=None):
    """Stacked int4 weights, on the JAX plan or on ``tiles`` (name ->
    (tr, tc)) for tiles the plan would not pick."""
    if tiles is None:
        return fb.stack_block_weights(layers, weight_dtype="int4")
    mw = fb.stack_block_weights(layers)
    return mw._replace(**{name: fb.pack_int4_tiles(getattr(mw, name), *t)
                          for name, t in tiles.items()})


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kv8,tiles", [
    (False, None), (True, None),
    # tiles of 4, 12 and 20 columns: a lane's 8 columns span two or three
    # tiles, q|k|v and gate|up boundaries fall inside tiles
    (True, dict(wqkv=(8, 20), wo=(2, 4), wgu=(16, 12), wd=(32, 4))),
], ids=["int4", "int8-int4", "int8-int4-odd-tiles"])
def test_fused_multi_block_decode_int4_matches_plain(dev, dtype, kv8,
                                                     tiles):
    rng = np.random.default_rng(7 + kv8)
    b, n, nh, nkv = 5, 2, 6, 2
    seq_lens = [0, 15, 16, 31, 2]
    layers, pools = [], []
    for _ in range(n):
        x, w, kp, vp, bt, sl = _block(rng, b, 192, nh, nkv, 384, 16, 4,
                                      seq_lens, dtype, dev)
        layers.append(w)
        pools.append((_q(kp), _q(vp)) if kv8 else (kp, vp))
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    mw = _int4_group(layers, tiles)

    def fresh():
        if kv8:
            return ([pa.QuantizedPages(k.q.clone(), k.scale.clone())
                     for k, _ in pools],
                    [pa.QuantizedPages(v.q.clone(), v.scale.clone())
                     for _, v in pools])
        return [k.clone() for k, _ in pools], [v.clone() for _, v in pools]

    kernels.reset_launches()
    got, gk, gv = fb.fused_multi_block_decode(x, mw, *fresh(), bt, sl, **kw)
    name = "fused_multi_block_decode_" + ("int8_int4" if kv8 else "int4")
    assert kernels.launch_counts()[name] == 1
    want, wk, wv = fb.fused_multi_block_decode_ref(x, mw, *fresh(), bt, sl,
                                                   **kw)
    assert _err(got, want) <= TOL[dtype]
    # past the first layer the two sides' inputs differ by the earlier
    # layers' rounding: the pools are held to the output's tolerance, an
    # int8 row's values beyond one quantization step of the row
    for i in range(n):
        for a, c in ((gk[i], wk[i]), (gv[i], wv[i])):
            if not kv8:
                assert _err(a, c) <= TOL[dtype]
                continue
            torch.cuda.synchronize()
            diff = (a.q.float() * a.scale - c.q.float() * c.scale).abs()
            step = torch.maximum(a.scale, c.scale)
            assert float((diff - step).max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_multi_block_decode_int8_is_the_chain(dev, dtype):
    """The int8 N-layer kernel equals N launches of the int8 one-layer
    kernel bit for bit: output, payloads and scales."""
    rng = np.random.default_rng(12)
    b, n, nh, nkv = 4, 3, 4, 2
    seq_lens = [0, 15, 16, 31]
    layers, pools = [], []
    for _ in range(n):
        x, w, kp, vp, bt, sl = _block(rng, b, 256, nh, nkv, 512, 16, 4,
                                      seq_lens, dtype, dev)
        layers.append(w)
        pools.append((_q(kp), _q(vp)))

    def fresh():
        return ([pa.QuantizedPages(k.q.clone(), k.scale.clone())
                 for k, _ in pools],
                [pa.QuantizedPages(v.q.clone(), v.scale.clone())
                 for _, v in pools])

    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    got, gk, gv = fb.fused_multi_block_decode(
        x, fb.stack_block_weights(layers), *fresh(), bt, sl, **kw)
    out, ck, cv = x, *fresh()
    for i, w in enumerate(layers):
        out, ck[i], cv[i] = fb.fused_block_decode(out, w, ck[i], cv[i], bt,
                                                  sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    for i in range(n):
        for a, c in ((gk[i], ck[i]), (gv[i], cv[i])):
            assert torch.equal(a.q, c.q) and torch.equal(a.scale, c.scale)


@pytest.mark.parametrize("flag_values", [
    {"serving_kv_dtype": "int8"},
    {"serving_kv_dtype": "int8", "fused_block_decode": False},
    {"serving_kv_dtype": "int8", "fused_weight_dtype": "int4",
     "fused_block_layers": 2},
], ids=["int8-fused", "int8-generic", "int8-int4-nlayer2"])
def test_quantized_engine_on_the_card_matches_the_cpu(dev, flag_values):
    """The tiny engine on an int8 pool (and int4 weights at N = 2), chunked,
    on the card and on the CPU: logits within 1e-4, tokens as the CPU's
    wherever its top-2 gap is wider."""
    kernels.reset_launches()
    streams = _card_vs_cpu_streams(dev, flag_values, prefill_chunk=8)
    counts = kernels.launch_counts()
    assert counts["paged_chunk_attention_int8"] == 2 * (2 + 2 + 2)
    assert counts["paged_chunk_attention"] == 0
    _assert_streams_agree(streams)


# ------------------------------------------------------------ fused RMSNorm
# y within atol + rtol |plain| (rtol one bf16 ulp: both round the same f32
# value once), r within 1e-5 relative, dx and dw against max |plain|
RN_OUT_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 8192])
@pytest.mark.parametrize("h", [64, 1000, 1001, 4096, 8192, 40000])
def test_rms_norm_kernels_match_plain(dev, dtype, n, h):
    """Forward (y, r) and dx against the plain twins on the same card
    tensors, and the autograd Function (dx, dw) against autograd of the
    dense reference."""
    rng = np.random.default_rng(n + h)
    x = _rand(rng, (n, h), dtype, dev)
    w = (1.0 + 0.1 * _rand(rng, (h,), torch.float32, dev)).to(dtype)
    g = _rand(rng, (n, h), dtype, dev)
    kernels.reset_launches()
    y, r = rn.rms_norm_fwd(x, w, 1e-6)
    y_r, r_r = rn.rms_norm_fwd_ref(x, w, 1e-6)
    assert y.dtype == dtype and r.dtype == torch.float32 and r.shape == (n, 1)
    atol, rtol = RN_OUT_TOL[dtype]
    torch.cuda.synchronize()
    over = ((y.float() - y_r.float()).abs() - rtol * y_r.float().abs()).max()
    assert float(over) <= atol
    assert float(((r - r_r).abs() / r_r).max()) <= 1e-5
    dx = rn.rms_norm_bwd_dx(x, w, g, r_r)
    assert dx.dtype == dtype
    assert _rel(dx, rn.rms_norm_bwd_dx_ref(x, w, g, r_r)) <= TOL[dtype]
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    grads = torch.autograd.grad(rn.rms_norm(*leaves, 1e-6), leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    ref_grads = torch.autograd.grad(rn.rms_norm_ref(*ref_leaves, 1e-6),
                                    ref_leaves, g)
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) <= TOL[dtype]
    counts = kernels.launch_counts()
    assert counts["rms_norm_fwd"] == 2 and counts["rms_norm_bwd_dx"] == 2


def test_rms_norm_repeats_bit_for_bit(dev):
    """The row sums run in a fixed order: two runs agree exactly."""
    rng = np.random.default_rng(3)
    x = _rand(rng, (300, 4096), torch.bfloat16, dev)
    w = _rand(rng, (4096,), torch.bfloat16, dev)
    g = _rand(rng, (300, 4096), torch.bfloat16, dev)
    (y1, r1), (y2, r2) = (rn.rms_norm_fwd(x, w, 1e-6) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(r1, r2)
    assert torch.equal(rn.rms_norm_bwd_dx(x, w, g, r1),
                       rn.rms_norm_bwd_dx(x, w, g, r1))


@pytest.mark.parametrize("case", ["fp16", "noncontiguous", "weight-dtype",
                                  "weight-size", "cpu-weight"])
def test_rms_norm_wrappers_refuse_what_the_kernel_does_not_take(dev, case):
    rng = np.random.default_rng(4)
    x = _rand(rng, (16, 64), torch.float32, dev)
    w = _rand(rng, (64,), torch.float32, dev)
    if case == "fp16":
        x, w = x.half(), w.half()
    elif case == "noncontiguous":
        x = _rand(rng, (64, 16), torch.float32, dev).t()
    elif case == "weight-dtype":
        w = w.bfloat16()
    elif case == "weight-size":
        w = w[:63]
    else:
        w = w.cpu()
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        rn.rms_norm_fwd(x, w, 1e-6)
    assert kernels.launch_counts()["rms_norm_fwd"] == 0


def test_fused_rms_norm_on_the_card_matches_the_cpu(dev):
    """fused_rms_norm with bias, residual and norm_bias in fp32: (out, h)
    and the gradients on the card against the same call on the CPU."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    rng = np.random.default_rng(6)
    arrays = [(rng.standard_normal(s)).astype(np.float32)
              for s in ((3, 40, 512), (3, 40, 512), (512,), (512,), (512,),
                        (3, 40, 512))]
    results = []
    for device in ("cpu", dev):
        x, res, w, bias, nbias, g = (torch.from_numpy(a).to(device)
                                     for a in arrays)
        leaves = [t.requires_grad_(True) for t in (x, res, w)]
        out, h = IF.fused_rms_norm(leaves[0], leaves[2], nbias, 1e-5,
                                   bias=bias, residual=leaves[1])
        grads = torch.autograd.grad(out, leaves, g)
        results.append([t.detach().cpu() for t in (out, h, *grads)])
    for a, b in zip(*results):
        assert float((a - b).abs().max() / b.abs().max().clamp_min(1.0)
                     ) <= 1e-4


# ------------------------------------------- flash attention, segment ids
def _segments(rng, b, s, docs, pad):
    """(B, S) q and kv ids: documents of the given lengths (the last
    filling the row), then ``pad`` padding positions whose q id no key
    carries (their kv id differs)."""
    seg_q = np.zeros((b, s), np.int32)
    for row in range(b):
        pos, doc = 0, 1
        for n in docs + (s,):
            seg_q[row, pos:pos + n] = doc + 10 * row
            pos, doc = pos + n, doc + 1
            if pos >= s:
                break
    seg_kv = seg_q.copy()
    if pad:
        seg_q[:, s - pad:] = 1000
        seg_kv[:, s - pad:] = 1001
    return seg_q, seg_kv


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,hkv,d,causal,docs,pad", [
    (1, 200, 4, 4, 128, True, (30, 70), 0),     # boundaries inside tiles
    (2, 130, 4, 2, 64, True, (64, 1, 20), 9),   # GQA, a padding id
    (1, 129, 8, 2, 128, False, (100,), 5),      # non-causal, GQA
    (2, 256, 2, 1, 64, True, (3, 5, 200), 0),   # tiny documents, rep 2
    (1, 70, 2, 2, 128, True, (17,), 70),        # every row padding
])
def test_flash_attention_segment_kernels_match_plain(dev, dtype, b, s, h,
                                                     hkv, d, causal, docs,
                                                     pad):
    """The segment-id variant of the forward (out, lse), dq and dk/dv
    against the plain versions with the same ids, the autograd Function
    against autograd of the dense reference; rows whose id no key carries
    emit zeros with lse 0 and get zero dq."""
    rng = np.random.default_rng(s + d + pad)
    q = _rand(rng, (b * h, s, d), dtype, dev)
    k = _rand(rng, (b * hkv, s, d), dtype, dev)
    v = _rand(rng, (b * hkv, s, d), dtype, dev)
    do = _rand(rng, (b * h, s, d), dtype, dev)
    ids_q, ids_kv = _segments(rng, b, s, docs, pad)
    seg_q = torch.from_numpy(np.repeat(ids_q, h, axis=0)).to(dev)
    seg_kv = torch.from_numpy(np.repeat(ids_kv, hkv, axis=0)).to(dev)
    kw = dict(causal=causal, n_heads=h, n_kv_heads=hkv, seg_q=seg_q,
              seg_kv=seg_kv)
    kernels.reset_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, **kw)
    assert _err(out, out_r) <= TOL[dtype]
    assert _err(lse, lse_r) <= TOL[dtype]
    delta = (out_r.float() * do.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
    dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse_r, delta, **kw)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse_r, delta,
                                                **kw)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert _rel(got, want) <= TOL[dtype]
    if pad:
        rows = slice(s - pad, s)
        assert not out[:, rows].any() and not dq[:, rows].any()
        assert not lse[:, rows].any()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    args = dict(causal=causal, n_heads=h, n_kv_heads=hkv)
    grads = torch.autograd.grad(
        fa.flash_attention(*leaves, seg_q, seg_kv, **args), leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(
        fa.flash_attention_ref(*ref_leaves, seg_q, seg_kv, **args),
        ref_leaves, do)
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) <= TOL[dtype]
    counts = kernels.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name + "_seg"] == 2 and counts[name] == 0


def test_flash_attention_one_segment_equals_no_segments(dev):
    """One segment over the whole row: the segment variant gives the
    native kernels' values bit for bit (the same tiles, the same sums)."""
    rng = np.random.default_rng(8)
    q = _rand(rng, (4, 300, 128), torch.bfloat16, dev)
    k = _rand(rng, (2, 300, 128), torch.bfloat16, dev)
    do = _rand(rng, (4, 300, 128), torch.bfloat16, dev)
    ones = torch.ones((4, 300), dtype=torch.int32, device=dev)
    kw = dict(causal=True, n_heads=2, n_kv_heads=1)
    seg = dict(seg_q=ones, seg_kv=ones[:2].contiguous())
    out, lse = fa.flash_attention_fwd(q, k, k, **kw)
    out_s, lse_s = fa.flash_attention_fwd(q, k, k, **kw, **seg)
    assert torch.equal(out, out_s) and torch.equal(lse, lse_s)
    delta = (out.float() * do.float()).sum(-1)
    bwd = (q, k, k, do, lse, delta)
    assert torch.equal(fa.flash_attention_bwd_dq(*bwd, **kw),
                       fa.flash_attention_bwd_dq(*bwd, **kw, **seg))
    for a, c in zip(fa.flash_attention_bwd_dkv(*bwd, **kw),
                    fa.flash_attention_bwd_dkv(*bwd, **kw, **seg)):
        assert torch.equal(a, c)


def _shuffled_ids(rng, b, s, alphabet):
    """(B, S) ids in no order (the public entry accepts any): each
    position a random id of ``alphabet``, the same for q and kv."""
    ids = rng.integers(0, alphabet, (b, s)).astype(np.int32)
    return ids, ids.copy()


# the bf16 backward on the tensor cores (mma.sync; P and dS rounded once to
# bf16 as operands, f32 sums): what it can get wrong
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,qscale,seg", [
    (1, 1, 1, 2, 2, 128, True, 1.0, None),      # S = 1
    (1, 15, 15, 4, 1, 64, True, 1.0, None),     # S = 15, rep 4
    (1, 64, 64, 8, 1, 128, True, 8.0, None),    # one tile, rep 8, peaked
    (2, 65, 65, 4, 4, 96, True, 1.0, None),     # one row past a tile, B = 2
    (1, 129, 129, 8, 2, 33, True, 8.0, None),   # odd head dim, peaked
    (1, 1000, 1000, 8, 1, 128, True, 8.0, None),  # ragged, rep 8, peaked
    (2, 300, 300, 4, 4, 128, False, 1.0, None),   # non-causal, B = 2
    (1, 200, 77, 4, 2, 64, True, 1.0, None),    # Sq > Skv
    (1, 77, 300, 4, 2, 128, True, 1.0, None),   # Sq < Skv
    (1, 150, 333, 2, 2, 96, False, 8.0, None),  # Sq < Skv, full, peaked
    (1, 400, 400, 4, 1, 128, True, 1.0, "docs"),    # boundaries in tiles
    (2, 300, 300, 8, 2, 64, True, 8.0, "pad"),      # a padding id
    (1, 500, 500, 4, 4, 128, True, 1.0, "shuffled"),  # non-monotone ids
    (1, 260, 260, 8, 8, 33, False, 1.0, "shuffled"),  # full, odd head dim
    (2, 1000, 1000, 8, 1, 128, True, 8.0, "docs"),  # rep 8, peaked
])
def test_flash_backward_bf16_tensor_core_cases(dev, b, sq, skv, h, hkv, d,
                                               causal, qscale, seg):
    """dq and dk/dv in bf16 against their plain versions on the same card
    tensors (_rel within TOL[bf16]): head dims 33 to 128, S = 1 to 1000,
    Sq != Skv both ways, rep 1 to 8, B = 2, non-causal, a peaked softmax,
    and segment packs with boundaries inside tiles, a padding id (zero dq
    there) and ids in no order; each kernel twice, bit for bit."""
    rng = np.random.default_rng(sq * 7 + skv + d + h)
    q = _rand(rng, (b * h, sq, d), torch.bfloat16, dev, qscale)
    k = _rand(rng, (b * hkv, skv, d), torch.bfloat16, dev)
    v = _rand(rng, (b * hkv, skv, d), torch.bfloat16, dev)
    do = _rand(rng, (b * h, sq, d), torch.bfloat16, dev)
    kw = dict(causal=causal, n_heads=h, n_kv_heads=hkv)
    if seg is not None:
        if seg == "shuffled":
            ids_q, ids_kv = _shuffled_ids(rng, b, sq, 3)
        else:
            ids_q, ids_kv = _segments(rng, b, sq, (30, 100, 171, 1),
                                      13 if seg == "pad" else 0)
        kw.update(seg_q=torch.from_numpy(np.repeat(ids_q, h, 0)).to(dev),
                  seg_kv=torch.from_numpy(np.repeat(ids_kv, hkv, 0)).to(dev))
    out, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    delta = (out.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    kernels.reset_launches()
    dq = fa.flash_attention_bwd_dq(*bwd, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(*bwd, **kw)
    variant = "" if seg is None else "_seg"
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq" + variant] == 1
    assert counts["flash_attention_bwd_dkv" + variant] == 1
    dq_r = fa.flash_attention_bwd_dq_ref(*bwd, **kw)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(*bwd, **kw)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel(got, want) <= TOL[torch.bfloat16]
    if seg == "pad":
        assert not dq[:, sq - 13:].any()
    assert torch.equal(dq, fa.flash_attention_bwd_dq(*bwd, **kw))
    for a, c in zip((dk, dv), fa.flash_attention_bwd_dkv(*bwd, **kw)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", ["int64", "one-side", "shape", "cpu"])
def test_flash_segment_ids_refused_when_the_kernel_does_not_take_them(
        dev, case):
    rng = np.random.default_rng(9)
    q = _rand(rng, (4, 32, 64), torch.float32, dev)
    seg = torch.ones((4, 32), dtype=torch.int32, device=dev)
    seg_kv = seg
    if case == "int64":
        seg = seg_kv = seg.long()
    elif case == "one-side":
        seg_kv = None
    elif case == "shape":
        seg = seg_kv = seg[:, :31].contiguous()
    else:
        seg = seg_kv = seg.cpu()
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_fwd(q, q, q, n_heads=1, seg_q=seg, seg_kv=seg_kv)
    assert kernels.launch_counts()["flash_attention_fwd_seg"] == 0


@pytest.mark.parametrize("route", ["self-causal", "cross-full",
                                   "cross-causal"])
def test_flash_attn_unpadded_on_the_card_matches_the_cpu(dev, route):
    """The varlen entry on the card (kernels; the causal cross-pack's dense
    route) against the same call on the CPU, fp32, with gradients."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(10)
    lens_q = (70, 1, 130, 55)
    lens_k = lens_q if route == "self-causal" else (40, 9, 200, 64)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((cu_q[-1], 8, 64), (cu_k[-1], 2, 64),
                         (cu_k[-1], 2, 64), (cu_q[-1], 8, 64))]
    causal = route != "cross-full"
    results = []
    kernels.reset_launches()
    for device in ("cpu", dev):
        q, k, v, do = (torch.from_numpy(a).to(device) for a in arrays)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out, _ = F.flash_attn_unpadded(
            *leaves, torch.from_numpy(cu_q).to(device),
            torch.from_numpy(cu_k).to(device), max(lens_q), max(lens_k),
            causal=causal)
        grads = torch.autograd.grad(out, leaves, do)
        results.append([t.detach().cpu() for t in (out, *grads)])
    for a, c in zip(*results):
        assert float((a - c).abs().max()) <= 1e-4
    launched = kernels.launch_counts()["flash_attention_fwd_seg"]
    assert launched == (0 if route == "cross-causal" else 1)


def test_variable_length_attention_on_the_card_matches_the_cpu(dev):
    from paddle_tpu_torch.incubate.nn import functional as IF
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((4, 4, 200, 64)).astype(np.float32)
              for _ in range(3)]
    lens = np.array([200, 150, 70, 3], np.int32)
    outs = []
    for device in ("cpu", dev):
        q, k, v = (torch.from_numpy(a).to(device) for a in arrays)
        outs.append(IF.variable_length_memory_efficient_attention(
            q, k, v, torch.from_numpy(lens).to(device), causal=True).cpu())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4


# the bf16 forward on the tensor cores (fb_fwd_kernel: mma.sync, P·V with P
# as bf16 hi + lo, the scale in f32 in the exponent), held to chip_smoke's
# OUT_TOL (MMA_TOL here) and LSE_TOL in bf16
LSE_TOL_BF16 = 1e-3


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,qscale,seg", [
    (1, 1, 1, 2, 2, 128, True, 1.0, None),      # S = 1
    (1, 15, 15, 4, 1, 64, True, 1.0, None),     # S = 15, rep 4
    (1, 64, 64, 8, 1, 128, True, 8.0, None),    # one tile, rep 8, peaked
    (2, 65, 65, 4, 4, 96, True, 1.0, None),     # one row past a tile, B = 2
    (1, 129, 129, 8, 2, 33, True, 8.0, None),   # odd head dim, peaked
    (1, 1000, 1000, 8, 1, 128, True, 8.0, None),  # ragged, rep 8, peaked
    (2, 300, 300, 4, 4, 128, False, 1.0, None),   # non-causal, B = 2
    (1, 200, 77, 4, 2, 64, True, 1.0, None),    # Sq > Skv
    (1, 77, 300, 4, 2, 128, True, 1.0, None),   # Sq < Skv
    (1, 150, 333, 2, 2, 96, False, 8.0, None),  # Sq < Skv, full, peaked
    (1, 1000, 1000, 4, 1, 128, True, 1.0, "docs"),  # boundaries in tiles
    (2, 300, 300, 8, 2, 64, True, 8.0, "pad"),      # a padding id, peaked
    (1, 500, 500, 4, 4, 128, True, 1.0, "shuffled"),  # non-monotone ids
    (1, 260, 260, 8, 8, 33, False, 1.0, "shuffled"),  # full, odd head dim
    (1, 129, 129, 2, 2, 128, False, 1.0, "pad"),    # full, padding rows
])
def test_flash_forward_bf16_tensor_core_cases(dev, b, sq, skv, h, hkv, d,
                                              causal, qscale, seg):
    """The bf16 forward (out, lse) against its plain version on the same
    card tensors within OUT_TOL / LSE_TOL: head dims 33 to 128, S = 1 to
    1000, Sq != Skv both ways, rep 1 to 8, causal and full, a peaked
    softmax, segment packs with boundaries inside tiles, a padding id (zeros
    and lse 0 there) and ids in no order; one launch, repeated bit for
    bit."""
    rng = np.random.default_rng(sq * 5 + skv + d + h)
    q = _rand(rng, (b * h, sq, d), torch.bfloat16, dev, qscale)
    k = _rand(rng, (b * hkv, skv, d), torch.bfloat16, dev)
    v = _rand(rng, (b * hkv, skv, d), torch.bfloat16, dev)
    kw = dict(causal=causal, n_heads=h, n_kv_heads=hkv)
    if seg is not None:
        if seg == "shuffled":
            ids_q, ids_kv = _shuffled_ids(rng, b, sq, 3)
        else:
            ids_q, ids_kv = _segments(rng, b, sq, (30, 100, 171, 1),
                                      13 if seg == "pad" else 0)
        kw.update(seg_q=torch.from_numpy(np.repeat(ids_q, h, 0)).to(dev),
                  seg_kv=torch.from_numpy(np.repeat(ids_kv, hkv, 0)).to(dev))
    kernels.reset_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    variant = "" if seg is None else "_seg"
    assert kernels.launch_counts()["flash_attention_fwd" + variant] == 1
    out_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == out_r.shape
    assert lse.dtype == torch.float32 and lse.shape == lse_r.shape
    atol, rtol = MMA_TOL
    assert _excess(out, out_r, rtol) <= atol
    assert _err(lse, lse_r) <= LSE_TOL_BF16
    if seg == "pad":
        assert not out[:, sq - 13:].any() and not lse[:, sq - 13:].any()
    again = fa.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# the split-KV decode attention (csrc/decode_split.cuh): parts of the walk
# over blocks, their merge in the same call; native within TOL, int8 within
# chip_smoke's QUANT_OUT_TOL (fp32 1e-5; bf16 1e-3 + one bf16 ulp)
QUANT_OUT_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}


SPLIT_CASES = [
    (32, 32, 128, 64, (4096, 0, 1, 64, 65)),   # 7B heads: 1, page, page + 1
    (8, 2, 128, 16, (1, 16, 17, 0, 300, 4096, 5, 33)),  # B = 8, rep 4
    (64, 8, 128, 8, (8, 9, 1000)),             # rep 8, pages of 8
    (4, 4, 64, 64, (129,)),                    # B = 1, head dim 64
    (16, 1, 64, 8, (5, 0, 63, 2000)),          # rep 16: two head groups
    (6, 2, 96, 16, (47, 0, 700)),              # rep 3, head dim 96
    (4, 2, 33, 8, (64, 65, 3)),                # odd head dim
]


def _split_inputs(dev, pool, dtype, h, hkv, d, page, seq_lens):
    """One SPLIT_CASES call's inputs: (q, k pool, v pool, tables, lengths),
    tables one page wider than the longest row (null entries)."""
    rng = np.random.default_rng(sum(seq_lens) + h + d + page)
    maxp = -(-max(seq_lens) // page) + 1
    bt, num_pages = _tables(rng, seq_lens, 0, page, maxp, dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    kp, vp = (_rand(rng, (hkv, num_pages, page, d), dtype, dev)
              for _ in range(2))
    if pool == "int8":
        kp, vp = _q(kp), _q(vp)
    q = _rand(rng, (len(seq_lens), h, d), dtype, dev)
    return q, kp, vp, bt, sl


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,hkv,d,page,seq_lens", SPLIT_CASES)
def test_paged_attention_split_cases(dev, pool, dtype, h, hkv, d, page,
                                     seq_lens):
    """The split-KV decode attention against paged_attention_ref on the
    same pool bits: native and int8 pools, B = 1 to 8 with idle rows,
    lengths 0, 1, a page, a page + 1 and 4096, pages of 8, 16 and 64, rep
    1 to 16, tables one page wider than the longest row (null entries);
    one launch, repeated bit for bit."""
    q, kp, vp, bt, sl = _split_inputs(dev, pool, dtype, h, hkv, d, page,
                                      seq_lens)
    kernels.reset_launches()
    got = pa.paged_attention(q, kp, vp, bt, sl)
    name = "paged_attention" + ("_int8" if pool == "int8" else "")
    assert kernels.launch_counts()[name] == 1
    want = pa.paged_attention_ref(q, kp, vp, bt, sl)
    assert got.dtype == dtype and got.shape == want.shape
    if pool == "int8":
        atol, rtol = QUANT_OUT_TOL[dtype]
        assert _excess(got, want, rtol) <= atol
    else:
        assert _err(got, want) <= TOL[dtype]
    assert not got[sl == 0].any()
    assert torch.equal(got, pa.paged_attention(q, kp, vp, bt, sl))


def _digest(t):
    torch.cuda.synchronize()
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]


def _split_digests(dev):
    """paged_attention's output bits at every SPLIT_CASES input, by
    "pool-dtype-case"."""
    return {f"{pool}-{name}-{i}": _digest(pa.paged_attention(
        *_split_inputs(dev, pool, dtype, *case)))
        for pool in ("native", "int8")
        for dtype, name in zip(DTYPES, ("fp32", "bf16"))
        for i, case in enumerate(SPLIT_CASES)}


# paged_attention's output bits at SPLIT_CASES' inputs as the kernel gave
# them before the routine took the fused decode's length offset and own
# rows (NVIDIA H100 80GB HBM3, the same nvcc): with the offset at 0 the
# routine must do the same arithmetic in the same order
SPLIT_BITS = {
    "int8-bf16-0": "3051765a92b4ba67",
    "int8-bf16-1": "b965e1bf5387e2e3",
    "int8-bf16-2": "44fb8298276c058b",
    "int8-bf16-3": "58a7dcda39698b6d",
    "int8-bf16-4": "0a7032798e7765ee",
    "int8-bf16-5": "79a2c294b19f16e8",
    "int8-bf16-6": "197b8dcdcca0fcdf",
    "int8-fp32-0": "06383ee59cb5dcde",
    "int8-fp32-1": "dcdb9f71799869c2",
    "int8-fp32-2": "bfd178bce7144048",
    "int8-fp32-3": "cc1902db759aa3f5",
    "int8-fp32-4": "2887ad1373d6ea11",
    "int8-fp32-5": "0f5ace26ec7b25b4",
    "int8-fp32-6": "6679618764814977",
    "native-bf16-0": "3894d859a7211733",
    "native-bf16-1": "303edf9a6b4bc55e",
    "native-bf16-2": "4c050c32a666afd1",
    "native-bf16-3": "d6ae4440f0c0b25b",
    "native-bf16-4": "3c4d63abf8162282",
    "native-bf16-5": "f4658265bd4846ea",
    "native-bf16-6": "2ae8042ee790d45c",
    "native-fp32-0": "8dc6f2ef7206dfce",
    "native-fp32-1": "92d020c6bd28aeaa",
    "native-fp32-2": "8ef26cb8217acb79",
    "native-fp32-3": "6451c4024fa30680",
    "native-fp32-4": "e9914860ad394eba",
    "native-fp32-5": "93beb62e5de9e29f",
    "native-fp32-6": "e73e901727541adc",
}


def test_paged_attention_bits_unchanged_by_the_offset(dev):
    assert _split_digests(dev) == SPLIT_BITS


# the fused decode kernels' attention phase (#3, #5): the append kernel,
# then decode_split.cuh's split-KV routine over seq_lens + 1 with the
# step's own key read from the append's scratch row. (nh, nkv, d, page,
# maxp, seq_lens): the first two at Llama-2-7B heads in a 4096-token table
# (16 parts of 256 keys at B = 4): serve_long's decode contexts, and
# lengths whose + 1 ends a part, starts one, ends a page, starts one and
# fills the table; then pages of 16 with an idle row (8 parts of 64 keys),
# Llama-2-70B heads (64 / 8: one group of 8 heads a block) with 64-key
# parts of one page, and head dim 64 with rep 16 (two head groups).
FUSED_SPLIT_CASES = [
    (32, 32, 128, 64, 64, (3500, 2900, 1800, 700)),
    (32, 32, 128, 64, 64, (255, 256, 63, 4095)),
    (8, 2, 64, 16, 32, (63, 64, 0, 300)),
    (64, 8, 128, 64, 16, (63, 0, 1000)),
    (16, 1, 64, 8, 32, (15, 64, 0, 255, 200)),
]
FUSED_HIDDEN, FUSED_INTER = 256, 512


def _fused_layer(rng, nh, nkv, d, dtype, dev):
    """One layer's weights at a narrow hidden width and the given heads
    (hidden != nh * d: the kernels take them apart)."""
    h, inter = FUSED_HIDDEN, FUSED_INTER

    def mat(k, n):
        return _rand(rng, (k, n), dtype, dev, 0.5 / np.sqrt(k))

    def norm():
        return (1.0 + 0.1 * torch.from_numpy(
            rng.standard_normal(h).astype(np.float32))).to(dev, dtype)

    return fb.BlockDecodeWeights(
        ln1=norm(), wq=mat(h, nh * d), wk=mat(h, nkv * d),
        wv=mat(h, nkv * d), wo=mat(nh * d, h), ln2=norm(), wg=mat(h, inter),
        wu=mat(h, inter), wd=mat(inter, h))


def _fused_case(seed_, kind, pool, dtype, nh, nkv, d, page, maxp, seq_lens,
                dev):
    """Inputs of one fused decode call: x, the layers' weights (one layer
    for kind "one", else a stacked group of 2, int4 for "group-int4"),
    each layer's pools (quantized for pool "int8"), tables and lengths."""
    rng = np.random.default_rng(seed_)
    n = 1 if kind == "one" else 2
    layers = [_fused_layer(rng, nh, nkv, d, dtype, dev) for _ in range(n)]
    bt, num_pages = _tables(rng, seq_lens, 1, page, maxp, dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    pools = []
    for _ in range(n):
        kp, vp = (_rand(rng, (nkv, num_pages, page, d), dtype, dev)
                  for _ in range(2))
        pools.append((_q(kp), _q(vp)) if pool == "int8" else (kp, vp))
    x = _rand(rng, (len(seq_lens), FUSED_HIDDEN), dtype, dev, 0.3)
    if kind == "one":
        w = layers[0]
    else:
        w = fb.stack_block_weights(
            layers, weight_dtype="int4" if kind == "group-int4" else "native")
    return x, layers, w, pools, bt, sl


def _clone(p):
    return (pa.QuantizedPages(p.q.clone(), p.scale.clone())
            if isinstance(p, pa.QuantizedPages) else p.clone())


def _fused_call(kind, x, w, pools, bt, sl, kw, plain=False):
    """One call of the kernel (or its plain version) on fresh pool copies:
    (out, k pools, v pools), the pools as lists."""
    ks, vs = [_clone(k) for k, _ in pools], [_clone(v) for _, v in pools]
    if kind == "one":
        fn = fb.fused_block_decode_ref if plain else fb.fused_block_decode
        out, k, v = fn(x, w, ks[0], vs[0], bt, sl, **kw)
        return out, [k], [v]
    fn = (fb.fused_multi_block_decode_ref if plain
          else fb.fused_multi_block_decode)
    return fn(x, w, ks, vs, bt, sl, **kw)


def _pools_equal(a, b):
    if isinstance(a, pa.QuantizedPages):
        return torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    return torch.equal(a, b)


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["one", "group", "group-int4"])
@pytest.mark.parametrize("nh,nkv,d,page,maxp,seq_lens", FUSED_SPLIT_CASES)
def test_fused_decode_split_attention_cases(dev, pool, dtype, kind, nh, nkv,
                                            d, page, maxp, seq_lens):
    """#3 (one layer) and #5 (2 layers, native or int4 weights) against the
    plain version: the output within TOL, the first layer's appended rows
    as the plain version's (native within TOL; int8 within one payload step
    and SCALE_RTOL), a later layer's pools within TOL of their values (its
    input already differs by the first layer's rounding); one launch; a
    second call repeats the first bit for bit; a group with native weights
    equals the chain of one-layer launches bit for bit."""
    x, layers, w, pools, bt, sl = _fused_case(
        sum(seq_lens) + nh + d + page, kind, pool, dtype, nh, nkv, d, page,
        maxp, seq_lens, dev)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    kernels.reset_launches()
    got, gk, gv = _fused_call(kind, x, w, pools, bt, sl, kw)
    name = ("fused_block_decode" if kind == "one"
            else "fused_multi_block_decode")
    tags = [t for t, on in (("int8", pool == "int8"),
                            ("int4", kind == "group-int4")) if on]
    name = "_".join([name] + tags)
    assert kernels.launch_counts()[name] == 1
    want, wk, wv = _fused_call(kind, x, w, pools, bt, sl, kw, plain=True)
    assert got.dtype == dtype and got.shape == x.shape
    assert _err(got, want) <= TOL[dtype]
    for i, (a, c) in enumerate(zip(gk + gv, wk + wv)):
        if pool == "native":
            assert _err(a, c) <= TOL[dtype]
        elif i % len(gk) == 0:
            _assert_rows_agree(a, c, dtype)
        else:
            torch.cuda.synchronize()
            diff = (a.q.float() * a.scale - c.q.float() * c.scale).abs()
            step = torch.maximum(a.scale, c.scale)
            assert float((diff - step).max()) <= TOL[dtype]
    again, ak, av = _fused_call(kind, x, w, pools, bt, sl, kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert all(_pools_equal(a, c) for a, c in zip(gk + gv, ak + av))
    if kind == "group":
        out, ck, cv = x, [_clone(k) for k, _ in pools], \
            [_clone(v) for _, v in pools]
        for i, lw in enumerate(layers):
            out, ck[i], cv[i] = fb.fused_block_decode(out, lw, ck[i], cv[i],
                                                      bt, sl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, out)
        assert all(_pools_equal(a, c) for a, c in zip(gk + gv, ck + cv))


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["one", "group"])
def test_fused_decode_idle_rows_keep_their_own_token(dev, pool, dtype, kind):
    """Two idle rows (length 0, all-zero tables) both append to slot 0 of
    the null page; each still attends to its own token only: the kernel
    repeats bit for bit, every row matches the plain version of that row
    alone within TOL, and the group equals the one-layer chain bit for
    bit."""
    nh, nkv, d, page, maxp = 8, 2, 128, 16, 8
    seq_lens = (0, 37, 0, 16)
    x, layers, w, pools, bt, sl = _fused_case(
        91, kind, pool, dtype, nh, nkv, d, page, maxp, seq_lens, dev)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    got, _, _ = _fused_call(kind, x, w, pools, bt, sl, kw)
    again, _, _ = _fused_call(kind, x, w, pools, bt, sl, kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for r in range(len(seq_lens)):
        one = slice(r, r + 1)
        want, _, _ = _fused_call(kind, x[one], w, pools, bt[one], sl[one],
                                 kw, plain=True)
        assert _err(got[one], want) <= TOL[dtype]
    if kind == "group":
        out, ck, cv = x, [_clone(k) for k, _ in pools], \
            [_clone(v) for _, v in pools]
        for i, lw in enumerate(layers):
            out, ck[i], cv[i] = fb.fused_block_decode(out, lw, ck[i], cv[i],
                                                      bt, sl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, out)


# ------------------------------------------- with_lse, prefetch, remat
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,h,hkv,causal", [
    (1, 4, 4, True), (129, 8, 2, True), (1000, 4, 1, False),
    (333, 8, 8, False)])
def test_flash_with_lse_matches_plain(dev, dtype, s, h, hkv, causal):
    """Out, lse and the gradients under a random (dO, dlse) against the
    same autograd Function's CPU run (the plain versions), at ragged
    lengths; the three kernels launch once each."""
    rng = np.random.default_rng(s + h)
    q = _rand(rng, (2 * h, s, 64), dtype, dev)
    k = _rand(rng, (2 * hkv, s, 64), dtype, dev)
    v = _rand(rng, (2 * hkv, s, 64), dtype, dev)
    do = _rand(rng, (2 * h, s, 64), dtype, dev)
    dlse = _rand(rng, (2 * h, s), torch.float32, dev)
    outs = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.to(d).float().to(dtype).requires_grad_(True)
                  for t in (q, k, v)]
        kernels.reset_launches()
        out, lse = fa.flash_attention_with_lse(*leaves, causal=causal,
                                               n_heads=h, n_kv_heads=hkv)
        grads = torch.autograd.grad((out, lse), leaves,
                                    (do.to(d), dlse.to(d)))
        counts = kernels.launch_counts()
        outs.append([t.detach().float().cpu() for t in (out, lse, *grads)])
        if d == dev:
            assert all(counts[n] == 1 for n in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *outs):
        assert torch.isfinite(a).all(), name
        tol = TOL[dtype] * (1.0 if name in ("out", "lse")
                            else max(1.0, float(b.abs().max())))
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_dlse_on_fully_masked_rows_gives_zero_grads(dev, dtype):
    """Rows whose segment id no key carries: lse 0, and with the dlse
    folded into delta their gradients are zero, never NaN."""
    rng = np.random.default_rng(5)
    h, s = 4, 200
    q, k, v, do = (_rand(rng, (h, s, 64), dtype, dev) for _ in range(4))
    seg_q = torch.ones(h, s, dtype=torch.int32, device=dev)
    seg_q[:, 130:] = 9
    seg_kv = torch.ones(h, s, dtype=torch.int32, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, h, h, seg_q,
                                      seg_kv)
    dlse = _rand(rng, (h, s), torch.float32, dev)
    delta = (out.float() * do.float()).sum(-1) - dlse
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, None, h,
                                   h, seg_q, seg_kv)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                        None, h, h, seg_q, seg_kv)
    torch.cuda.synchronize()
    assert torch.all(lse[:, 130:] == 0)
    for g in (dq, dk, dv):
        assert torch.isfinite(g.float()).all()
    assert torch.all(dq[:, 130:] == 0)


def test_device_prefetcher_orders_its_streams(dev):
    """Batches staged on the side stream reach the consumer intact: the
    host tensors are overwritten right after staging, the consumer's
    stream is kept busy, and every staged value is read on it."""
    from paddle_tpu_torch.io import DevicePrefetcher
    host = [torch.full((1 << 20,), float(i)) for i in range(6)]

    def batches():
        for i, t in enumerate(host):
            yield (t,)
            t.fill_(-1.0)          # overwritten once staged

    sums = []
    spin = torch.randn(2048, 2048, device=dev)
    for (b,) in DevicePrefetcher(batches(), device=dev, depth=3):
        for _ in range(20):
            spin = spin @ spin / 2048.0    # the consumer stream stays busy
        sums.append(b.sum())
        del b                              # freed while the stream runs
    got = [float(x) for x in sums]
    assert got == [float(i) * (1 << 20) for i in range(6)]


def test_remat_matches_no_remat_on_the_card(dev):
    """Bit for bit: remat recomputes each layer's forward with the same
    deterministic kernels; the forward kernel runs twice a layer and
    micro-batch."""
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=512, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=seed(7, dev))
    ids = torch.randint(0, 512, (2, 200), generator=torch.Generator(
        ).manual_seed(3)).to(dev)
    grads = []
    for remat in (False, True):
        step = TrainStep(model, AdamW(1e-3, parameters=model.
                                      named_parameters()),
                         grad_accum_steps=2, remat=remat)
        kernels.reset_launches()
        loss, g = step.compute_loss_grads(ids, ids)
        counts = kernels.launch_counts()
        assert counts["flash_attention_fwd"] == 2 * 2 * (2 if remat else 1)
        assert counts["flash_attention_bwd_dq"] == 4
        grads.append((float(loss), {n: t.clone() for n, t in g.items()}))
    assert grads[0][0] == grads[1][0]
    for n, t in grads[0][1].items():
        assert torch.equal(t, grads[1][1][n]), n


# ------------------------------------------------- decode programs as graphs
GRAPH_ROUTES = {"fused": ({}, {}), "generic": ({"fused_block_decode": False},
                                               {}),
                "nlayer-int8-int4": ({"fused_block_layers": 2},
                                     dict(kv_dtype="int8",
                                          weight_dtype="int4"))}


def _graph_engine(dev, route, model=None, **kw):
    """A tiny GQA Llama engine in bf16 on the card (ladder (2, 4), patience
    2) under ``route``'s flags and options."""
    from paddle_tpu_torch import flags
    flag_values, opts = GRAPH_ROUTES[route]
    if model is None:
        model = LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                                 dtype=torch.bfloat16,
                                 generator=seed(3, dev))
    flags.set_flags(dict(flag_values, serving_bucket_patience=2))
    try:
        return ServingEngine(model, **{
            **dict(max_batch=4, page_size=8, max_seq_len=48,
                   prefill_chunk=0, bucket_ladder=(2, 4)), **opts, **kw})
    finally:
        flags.reset_flags()


def _graph_prompts(vocab, lens=(5, 9, 13, 7, 6, 11)):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _ladder_run(eng):
    ps = _graph_prompts(eng.model.config.vocab_size)
    rids = [eng.submit(p, 6) for p in ps[:2]]
    eng.step()
    eng.step()
    rids += [eng.submit(p, 6) for p in ps[2:]]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_decode_graph_one_capture_per_rung(dev, route):
    """Each rung is captured once per engine, whatever the steps and
    migrations; a second engine over the same model captures each rung
    once more (the graph binds its pools), and serves the same streams."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    clear_decode_program_cache()
    cache = decode_program_cache()
    eng = _graph_engine(dev, route)
    first = _ladder_run(eng)
    keys = set(eng._decode_keys.values())
    assert {k.batch_bucket for k in keys} == {2, 4}
    assert eng.bucket_migrations >= 2
    assert all(cache.trace_count(k) == 1 for k in keys)
    assert all(fn.graph is not None for fn in eng._decode_fns.values())
    again = _graph_engine(dev, route, model=eng.model)
    assert _ladder_run(again) == first
    assert set(again._decode_keys.values()) == keys
    assert all(cache.trace_count(k) == 2 for k in keys)


def _clone_pools(pools):
    return [(_clone(k), _clone(v)) for k, v in pools]


def _copy_pools(dst, src):
    for pair_d, pair_s in zip(dst, src):
        for d, s in zip(pair_d, pair_s):
            if isinstance(d, pa.QuantizedPages):
                d.q.copy_(s.q)
                d.scale.copy_(s.scale)
            else:
                d.copy_(s)


@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_decode_graph_equals_eager_bit_for_bit(dev, route):
    """On the same inputs and pools, a replay gives the eager step's logits
    and pool writes, bit for bit (rung 4, one idle row)."""
    eng = _graph_engine(dev, route, bucket_ladder=(4,))
    ps = _graph_prompts(eng.model.config.vocab_size)
    for p in ps[:4]:
        eng.submit(p, 3)
    eng.run()
    graph = eng._decode_fns[4]
    assert graph.graph is not None
    for s, n in enumerate((5, 17, 30)):
        eng.pool.allocate(s, n + 1)
        eng.pool.seq_lens[s] = n
    rng = np.random.default_rng(9)
    toks = rng.integers(0, eng.model.config.vocab_size, (4, 1))
    bt = eng.pool.block_tables[:4].copy()
    sl = eng.pool.seq_lens[:4].copy()
    pools = eng.pool.take_pools()
    saved = _clone_pools(pools)
    next_g, logits_g, _ = graph(toks, bt, sl, pools)
    logits_g = logits_g.clone()
    after_g = _clone_pools(pools)
    _copy_pools(pools, saved)
    logits_e, _ = graph.program(
        graph.weights, torch.from_numpy(toks).to(dev), pools,
        torch.from_numpy(bt).to(dev), torch.from_numpy(sl).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(logits_g, logits_e)
    assert np.array_equal(next_g, logits_e.argmax(-1).cpu().numpy())
    for (kg, vg), (ke, ve) in zip(after_g, pools):
        assert _pools_equal(kg, ke) and _pools_equal(vg, ve)
    eng.pool.install_pools(pools)


@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_decode_graph_replays_count_launches(dev, route):
    """Launch counts stay exact with replays: layers (or groups) a decode
    step, prefills a layer each, nothing for the capture."""
    eng = _graph_engine(dev, route)
    kernels.reset_launches()
    _ladder_run(eng)
    counts = kernels.launch_counts()
    layers = eng.model.config.num_hidden_layers
    steps = len(eng.decode_step_seconds)
    name, n = {"fused": ("fused_block_decode", layers),
               "generic": ("paged_attention", layers),
               "nlayer-int8-int4": ("fused_multi_block_decode_int8_int4",
                                    1)}[route]
    assert counts[name] == n * steps
    assert counts["flash_prefill"] == layers * 6
    assert sum(counts.values()) == n * steps + layers * 6


def test_decode_graph_refuses_moved_pools(dev):
    """A pool replaced after the capture (another address) is refused: the
    graph would write the old one."""
    eng = _graph_engine(dev, "fused", bucket_ladder=(4,))
    p = _graph_prompts(eng.model.config.vocab_size)[0]
    eng.submit(p, 3)
    eng.run()
    eng.pool.k_pages[0] = eng.pool.k_pages[0].clone()
    eng.submit(p, 3)
    with pytest.raises(RuntimeError, match="addresses"):
        eng.run()


# ------------------------------------- the chunk program and the prefix cache
def _chunk_prompts(vocab, lens=(20, 30, 13)):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("route", ["fused", "nlayer-int8-int4"])
def test_chunk_graph_one_capture_per_engine(dev, route):
    """Chunked prompts (chunk 8): the chunk program is captured once per
    engine, whatever the prompts; a second engine captures it again and
    serves the same streams; launches stay exact (a chunk layer each)."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    clear_decode_program_cache()
    cache = decode_program_cache()
    streams = []
    for again in (False, True):
        eng = _graph_engine(dev, route, bucket_ladder=(4,), prefill_chunk=8)
        kernels.reset_launches()
        rids = [eng.submit(p, 5) for p in
                _chunk_prompts(eng.model.config.vocab_size)]
        out = eng.run()
        streams.append([out[r] for r in rids])
        assert eng._chunk_fn.graph is not None
        assert cache.trace_count(eng.chunk_key) == 1 + again
        chunks = 3 + 4 + 2
        assert eng.chunk_dispatches == chunks
        name = "paged_chunk_attention" + (
            "_int8" if route == "nlayer-int8-int4" else "")
        layers = eng.model.config.num_hidden_layers
        assert kernels.launch_counts()[name] == layers * chunks
    assert streams[0] == streams[1]


def test_chunk_graph_equals_eager_bit_for_bit(dev):
    """A replay of the chunk graph, from a nonzero cursor with a padded
    tail, gives the eager program's logits row and pool writes bit for
    bit."""
    eng = _graph_engine(dev, "fused", bucket_ladder=(4,), prefill_chunk=8)
    vocab = eng.model.config.vocab_size
    eng.submit(_chunk_prompts(vocab)[0], 3)
    eng.run()
    graph = eng._chunk_fn
    assert graph.graph is not None
    eng.pool.allocate(1, 40)
    rng = np.random.default_rng(12)
    ids = rng.integers(0, vocab, (1, 8))
    bt = eng.pool.block_tables[1:2].copy()
    sl = np.array([13], np.int32)
    last = np.array([5], np.int64)
    pools = eng.pool.take_pools()
    saved = _clone_pools(pools)
    row_g, tok_g, _ = graph(ids, bt, sl, last, pools)
    row_g = row_g.clone()
    tok_g = int(tok_g)
    after_g = _clone_pools(pools)
    _copy_pools(pools, saved)
    row_e, _ = graph.run((ids, bt, sl, last), pools)
    torch.cuda.synchronize()
    assert torch.equal(row_g, row_e)
    assert tok_g == int(torch.argmax(row_e))
    for (kg, vg), (ke, ve) in zip(after_g, pools):
        assert _pools_equal(kg, ke) and _pools_equal(vg, ve)
    eng.pool.install_pools(pools)


def test_chunk_graph_refuses_moved_pools(dev):
    eng = _graph_engine(dev, "fused", bucket_ladder=(4,), prefill_chunk=8)
    p = _chunk_prompts(eng.model.config.vocab_size)[0]
    eng.submit(p, 3)
    eng.run()
    eng.pool.v_pages[1] = eng.pool.v_pages[1].clone()
    eng.submit(p, 3)
    with pytest.raises(RuntimeError, match="chunk graph: the pools"):
        eng.run()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_spill_restore_on_the_card_is_bit_exact_in_place(dev, kv_dtype):
    pool = pa.PagedKVCache(num_layers=3, num_pages=6, page_size=8,
                           num_kv_heads=2, head_dim=64, max_batch=2,
                           max_seq_len=32, dtype=torch.bfloat16,
                           reserve_null_page=True, kv_dtype=kv_dtype,
                           device=dev)
    gen = seed(5, dev)
    for half in (pool.k_pages, pool.v_pages):
        for layer in half:
            for t in pa._parts(layer):
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, device=dev,
                                          generator=gen))
                else:
                    t.copy_(torch.randn(t.shape, device=dev, generator=gen))
    ptrs = [t.data_ptr() for h in (pool.k_pages, pool.v_pages)
            for layer in h for t in pa._parts(layer)]
    pid = pool.take_free_page()
    want = [t[:, pid].clone() for h in (pool.k_pages, pool.v_pages)
            for layer in h for t in pa._parts(layer)]
    host = pool.spill_page(pid)
    assert all(t.is_pinned() for t in host.k + host.v)
    pool.unref_page(pid)
    assert pool.take_free_page() == pid
    for h in (pool.k_pages, pool.v_pages):
        for layer in h:
            for t in pa._parts(layer):
                t[:, pid] = 3
    new = pool.take_free_page()
    pool.restore_page(host, new)
    got = [t[:, new] for h in (pool.k_pages, pool.v_pages)
           for layer in h for t in pa._parts(layer)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ptrs == [t.data_ptr() for h in (pool.k_pages, pool.v_pages)
                    for layer in h for t in pa._parts(layer)]


def _tier_run(dev, model, num_pages, tier, prompts):
    from paddle_tpu_torch import flags
    flags.set_flags({"serving_bucket_patience": 2})
    try:
        eng = ServingEngine(model, max_batch=1, page_size=8, max_seq_len=64,
                            prefill_chunk=8, prefix_cache=True,
                            num_pages=num_pages, host_tier_pages=tier)
    finally:
        flags.reset_flags()
    out, restores = [], [0]
    restore = eng.pool.restore_page

    def counted(*a):
        restores[0] += 1
        return restore(*a)
    eng.pool.restore_page = counted
    for p in prompts:
        rid = eng.submit(p, 4)
        out.append(eng.run()[rid])
    return eng, out, restores[0]


def test_decode_graphs_replay_after_spill_and_restore(dev):
    """Two orgs' 24-token prefixes through a 9-page pool with a host tier:
    the second org's prompt spills the first's prefix, a repeat restores
    it. The decode and chunk graphs, captured before, keep replaying (one
    capture each), and the streams equal a roomy engine's."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    clear_decode_program_cache()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                             dtype=torch.bfloat16, generator=seed(3, dev))
    rng = np.random.default_rng(21)
    orgs = [rng.integers(0, 256, (24,)).astype(np.int32) for _ in range(2)]
    prompts = [np.concatenate([orgs[i], rng.integers(0, 256, (5,))])
               .astype(np.int32) for i in (0, 1, 0)]
    eng, tiered, restores = _tier_run(dev, model, 7, 16, prompts)
    assert restores == 3 and eng._prefix.spilled_page_count() >= 1
    cache = decode_program_cache()
    graphs = [eng._decode_fns[1], eng._chunk_fn]
    assert all(g.graph is not None for g in graphs)
    assert cache.trace_count(eng._decode_keys[1]) == 1
    assert cache.trace_count(eng.chunk_key) == 1
    assert [g.ptrs for g in graphs] == [
        tserving._pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages))] * 2
    _, roomy, _ = _tier_run(dev, model, 40, 0, prompts)
    assert tiered == roomy


# ------------------------------------------ replay recovery and telemetry
# each site fires a few times (every fault replays every request in
# flight: without times= the chunked prompts could spend their budget)
RECOVERY_SPEC = ("prefill:every=3:times=1;chunk_prefill:every=3:times=2;"
                 "decode_dispatch:every=7:times=2")


def _recovery_run(dev, model, spec, route="fused", **kw):
    """Chunked and whole prompts, half submitted after 2 steps, through an
    fp32 engine on the card (ladder (2, 4)) armed with ``spec``. Returns
    (engine, streams, pool addresses before the run)."""
    from paddle_tpu_torch.testing import faults
    with faults.armed(spec, serving_retry_backoff=0.001):
        eng = _graph_engine(dev, route, model=model, prefill_chunk=16,
                            prefix_cache=True, **kw)
    ptrs = tserving._pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages))
    ps = _graph_prompts(eng.model.config.vocab_size,
                        lens=(20, 5, 30, 9, 13, 6))
    rids = [eng.submit(p, 6) for p in ps[:3]]
    eng.step()
    eng.step()
    rids += [eng.submit(p, 6) for p in ps[3:]]
    out = eng.run()
    assert all(eng.status(r) == "OK" for r in rids), eng.statuses()
    return eng, [out[r] for r in rids], ptrs


@pytest.mark.parametrize("route", ["fused", "generic"])
def test_recovery_keeps_the_graphs_and_the_pools(dev, route):
    """Faults in prefill, chunks and decode: recovery resets the pools in
    place, so the graphs captured before keep replaying (one capture per
    rung and one for the chunk, as in a fault-free engine), the pools keep
    their addresses, and the replayed fp32 streams equal the fault-free
    run's."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                             dtype=torch.float32, generator=seed(5, dev))
    clear_decode_program_cache()
    cache = decode_program_cache()
    clean, want, _ = _recovery_run(dev, model, "", route)
    before = dict(cache.stats()["traces"])
    eng, got, ptrs = _recovery_run(dev, model, RECOVERY_SPEC, route)
    assert got == want
    fired = eng._f_prefill.fires + eng._f_chunk.fires + eng._f_decode.fires
    assert fired == 5 and eng._consec_failures == 0
    keys = set(eng._decode_keys.values()) | {eng.chunk_key}
    assert keys == set(clean._decode_keys.values()) | {clean.chunk_key}
    assert {k: cache.stats()["traces"][k] - before[k] for k in keys} == \
        dict.fromkeys(keys, 1)
    graphs = list(eng._decode_fns.values()) + [eng._chunk_fn]
    assert all(g.graph is not None and g.ptrs == ptrs for g in graphs)
    assert tserving._pool_ptrs(
        zip(eng.pool.k_pages, eng.pool.v_pages)) == ptrs
    led = eng.pool.ledger()
    assert led["pages_in_use"] == len(eng._prefix._nodes)
    assert led["pages_shared"] == 0 == eng._prefix.pinned_page_count()


def _replica_value(name, replica):
    from paddle_tpu_torch import observability as obs
    for s in obs.snapshot()["metrics"][name]["series"]:
        if s["labels"].get("replica") == replica:
            return s["count"] if "count" in s else s["value"]
    raise KeyError(name)


def test_decode_steps_count_graph_replays(dev):
    """serving_decode_steps counts every dispatched step, replays of the
    captured graph included, and the launch counters agree."""
    eng = _graph_engine(dev, "fused", replica="card-steps")
    kernels.reset_launches()
    _ladder_run(eng)
    steps = len(eng.decode_step_seconds)
    assert all(fn.graph is not None for fn in eng._decode_fns.values())
    assert _replica_value("serving_decode_steps", "card-steps") == steps
    layers = eng.model.config.num_hidden_layers
    assert kernels.launch_counts()["fused_block_decode"] == layers * steps


def test_no_telemetry_write_or_fault_check_inside_a_capture(dev):
    """Armed sites that never fire count one check a dispatch, and the
    per-step telemetry one write a dispatch: none of them runs inside the
    captured steps (which would count once at capture, never on
    replay)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.testing import faults
    obs.tracer().clear()
    with faults.armed("decode_dispatch:every=100000;"
                      "chunk_prefill:every=100000"):
        eng = _graph_engine(dev, "fused", replica="card-capture",
                            prefill_chunk=8)
    rids = [eng.submit(p, 6) for p in _chunk_prompts(
        eng.model.config.vocab_size)]
    out = eng.run()
    steps = len(eng.decode_step_seconds)
    assert eng._decode_fns[eng.bucket].graph is not None
    assert eng._chunk_fn.graph is not None
    assert eng._f_decode.calls == steps
    assert eng._f_chunk.calls == eng.chunk_dispatches == 3 + 4 + 2
    assert _replica_value("serving_decode_steps", "card-capture") == steps
    assert _replica_value("serving_prefill_chunk_seconds",
                          "card-capture") == eng.chunk_dispatches
    decoded = sum(len(out[r]) - 1 for r in rids)
    assert _replica_value("serving_inter_token_seconds",
                          "card-capture") == decoded
    events = [e["name"] for e in obs.tracer().events()]
    assert events.count("engine.decode_step") == steps


def test_kernel_error_in_a_step_is_not_replayed(dev):
    """A graph given pools at other addresses raises KernelError: recovery
    does not replay it."""
    eng = _graph_engine(dev, "fused", bucket_ladder=(4,))
    p = _graph_prompts(eng.model.config.vocab_size)[0]
    eng.submit(p, 3)
    eng.run()
    eng.pool.k_pages[0] = eng.pool.k_pages[0].clone()
    eng.submit(p, 3)
    with pytest.raises(tserving.KernelError, match="addresses"):
        eng.run()
    assert eng._consec_failures == 0


def test_device_memory_watermarks_on_the_card(dev):
    """sample_device_memory reports the card's allocator watermarks under
    the JAX package's stat names and publishes them as gauges."""
    from paddle_tpu_torch import observability as obs
    x = torch.ones((1 << 20,), device=dev)
    out = obs.memory.sample_device_memory()
    stats = out["devices"][str(dev.index or 0)]
    assert set(stats) == set(obs.memory.DEVICE_STATS)
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.nbytes
    assert stats["bytes_reserved"] >= stats["bytes_in_use"]
    series = {(s["labels"]["device"], s["labels"]["stat"]): s["value"]
              for s in obs.snapshot()["metrics"]["device_memory_bytes"]
              ["series"]}
    assert series[(str(dev.index or 0), "bytes_in_use")] == \
        stats["bytes_in_use"]
