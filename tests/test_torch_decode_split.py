"""The split-KV decode attention (``paged_attention`` on the card,
``csrc/decode_split.cuh``) as far as the CPU can hold it: the part count,
a function of the shapes only, and the kernel's partition and fixed-order
merge emulated in plain PyTorch (``torch_numerics.
paged_attention_split_emulated``) against the JAX package's Pallas
``paged_attention`` (interpret mode off the TPU), on native and int8 pools,
in float32 within 2e-5 (JAX's KTOL for readers over one pool): idle rows,
a length of exactly one part, parts past a row's end, pages of 8, 16 and
64, GQA.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_numerics import paged_attention_split_emulated

TOL = 2e-5
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("blocks,maxp,page,want", [
    (128, 16, 64, (2, 8)),      # chip_smoke: B=4 x 32 kv heads, 1024 keys
    (128, 64, 64, (4, 16)),     # serve_long's 4096-token table
    (4, 64, 64, (1, 64)),       # few blocks: parts cut to one page
    (6, 40, 8, (8, 5)),         # pages of 8: 64-key parts at the least
    (2048, 130, 16, (16, 9)),   # a full card: 256-key parts, ragged
    (1, 1, 64, (1, 1)),         # one page
])
def test_decode_splits_from_the_shapes(blocks, maxp, page, want):
    """(part_pages, nsplit): parts of about 256 keys, cut down (to 64 keys,
    at least a page) while the whole table gives the card fewer than four
    blocks an SM; the parts always cover the table."""
    got = tpa.decode_splits(blocks, maxp, page, H100_SMS)
    assert got == want
    part, nsplit = got
    assert part * nsplit >= maxp > part * (nsplit - 1)
    assert got == tpa.decode_splits(blocks, maxp, page, H100_SMS)


def test_decode_splits_read_no_tensor():
    """Plain ints in, plain ints out: nothing to read back from a card."""
    got = tpa.decode_splits(128, 16, 64, 132)
    assert all(type(x) is int for x in got)


def _case(seed, h, hkv, d, page, seq_lens, maxp):
    """Pools with page 0 the null page, shuffled tables, an idle row's
    table all zeros."""
    rng = np.random.default_rng(seed)
    b = len(seq_lens)
    num_pages = 1 + b * maxp
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    bt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(num_pages - 1) + 1
    used = 0
    for i, n in enumerate(seq_lens):
        pages = -(-n // page)
        bt[i, :pages] = perm[used:used + pages]
        used += pages
    return q, kp, vp, bt, np.asarray(seq_lens, np.int32)


# (h, hkv, d, page, seq_lens, maxp, part_pages): the part is 64 keys
# except where noted
CASES = [
    (4, 2, 32, 8, (0, 64, 65, 300), 40, 8),     # idle, one part, one past
    (8, 2, 16, 16, (128, 5, 0, 191), 12, 4),    # rep 4, parts past the end
    (2, 2, 32, 64, (64, 200, 1), 4, 1),         # page 64: a page a part
    (16, 2, 16, 16, (256, 17), 16, 16),         # rep 8, one part (no split)
    (4, 1, 32, 8, (63, 64, 129), 17, 3),        # 24-key parts, ragged table
]


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("h,hkv,d,page,seq_lens,maxp,part_pages", CASES)
def test_split_partition_matches_jax_pallas(pool, h, hkv, d, page, seq_lens,
                                            maxp, part_pages):
    """The emulated split (parts, half-warps, fixed-order merge) against
    JAX's Pallas paged_attention on the same pool bits; idle rows read
    zeros; the same emulation with no split agrees with it too."""
    q, kp, vp, bt, sl = _case(len(seq_lens) + page + h, h, hkv, d, page,
                              seq_lens, maxp)
    if pool == "int8":
        jk, jv = (jpa.QuantizedPages(*jpa.quantize_kv_rows(jnp.asarray(x)))
                  for x in (kp, vp))
        tk_, tv = (tpa.QuantizedPages(*tpa.quantize_kv_rows(_t(x)))
                   for x in (kp, vp))
    else:
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk_, tv = _t(kp), _t(vp)
    want = np.asarray(jpa.paged_attention(jnp.asarray(q), jk, jv,
                                          jnp.asarray(bt), jnp.asarray(sl)))
    scale = 1.0 / np.sqrt(d)
    nsplit = -(-maxp // part_pages)
    got = paged_attention_split_emulated(_t(q), tk_, tv, _t(bt), _t(sl),
                                         scale, part_pages, nsplit)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert not got[_t(sl) == 0].any()
    whole = paged_attention_split_emulated(_t(q), tk_, tv, _t(bt), _t(sl),
                                           scale, maxp, 1)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=TOL)
    plain = tpa.paged_attention(_t(q), tk_, tv, _t(bt), _t(sl))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("page", [8, 16, 64])
def test_wrapper_rule_splits_the_test_tables(page):
    """At the rule's own part count (an H100's 132 SMs) the emulation holds
    JAX's Pallas result, with lengths that end on, before and after part
    boundaries."""
    part_pages, nsplit = tpa.decode_splits(3 * 2, 8 * 64 // page, page,
                                           H100_SMS)
    part_keys = part_pages * page
    assert nsplit > 1
    lens = (part_keys, part_keys + 1, 2 * part_keys - 1)
    q, kp, vp, bt, sl = _case(page, 4, 2, 32, page, lens, 8 * 64 // page)
    want = np.asarray(jpa.paged_attention(*(jnp.asarray(a) for a in (
        q, kp, vp, bt, sl))))
    got = paged_attention_split_emulated(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(sl), 1.0 / np.sqrt(32),
                                         part_pages, nsplit)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
