"""The port's CUDA kernels on the card, at shapes the serving smoke run
(``chip_smoke.py``, Llama-2-7B: MHA, head_dim 128, batch 4) leaves out:
GQA, head_dim 64, small pages, batches that span several GEMV batch
tiles, ragged and page-aligned lengths, idle null-page rows. Each kernel is
held to its plain PyTorch version on the same card tensors (fp32 1e-4,
bf16 2e-2 abs: the kernels sum in f32 in another order, and bf16 rounds
once more at the output); the wrappers' input checks and launch counters
are checked too, and a tiny GQA engine on the card is held to the same
engine on the CPU.

Every test needs the card and skips without one. On the GPU machine, which
has no JAX (so the repository's conftest, which imports it, is skipped):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels import fused_block_decode as fb
from paddle_tpu_torch.kernels import paged_attention as pa
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
    assert kernels.launch_counts() == {"flash_prefill": 1,
                                       "paged_attention": 2,
                                       "fused_block_decode": 0}


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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_engine_on_the_card_matches_the_cpu(dev, fused):
    """A tiny GQA Llama in fp32 served on the card and on the CPU: the
    logits each token was taken from agree to 1e-4, and the greedy tokens
    agree wherever the CPU's top-2 gap is wider than that."""
    from paddle_tpu_torch import flags
    cfg = LlamaConfig.tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", generator=seed(3))
    card = LlamaForCausalLM(cfg, device=dev, generator=seed(3, dev))
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 13, 7, 16)]
    streams = []
    flags.set_flags({"fused_block_decode": fused})
    try:
        for model in (cpu, card):
            eng = ServingEngine(model, max_batch=2, page_size=8,
                                max_seq_len=32, record_logits=True)
            rids = [eng.submit(p, 6) for p in prompts]
            out = eng.run()
            streams.append([(out[r], eng.logits[r]) for r in rids])
    finally:
        flags.reset_flags()
    for (toks_c, rows_c), (toks_g, rows_g) in zip(*streams):
        for j, (tc, tg) in enumerate(zip(toks_c, toks_g)):
            assert np.max(np.abs(rows_c[j] - rows_g[j])) <= 1e-4
            if tc != tg:
                top2 = np.sort(rows_c[j])[-2:]
                assert top2[1] - top2[0] <= 1e-4
                break
