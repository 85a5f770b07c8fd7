"""The PyTorch port's kernel modules against the JAX package.

Each port kernel's plain PyTorch version (what its wrapper runs for a CPU
tensor) is held to the JAX Pallas entry (interpret mode off the TPU) and to
the JAX reference, on the same seeded numpy inputs, in float32:
  - flash prefill, max abs error <= 2e-5 (GQA, cur_len > S, a cache length
    the Pallas kernel takes, and a ragged one against the JAX reference);
  - paged decode attention, <= 2e-5 (shuffled block tables, the null page,
    ragged lengths);
  - fused block decode, <= 1e-4 (output and both pools);
  - the pool writes, exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels import fused_block_decode as jfb
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_block_decode as tfb
from paddle_tpu_torch.kernels import paged_attention as tpa

ATTN_TOL = 2e-5
BLOCK_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ------------------------------------------------------------ flash prefill
def _prefill_case(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,cur_len", [(20, 100), (37, 37), (128, 128)])
def test_flash_prefill_matches_jax_pallas(s, cur_len):
    q, k, v = _prefill_case(0, 2, s, 128, 4, 2, 16)
    want = np.asarray(jda.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), cur_len))
    ref = np.asarray(jda.flash_prefill_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), cur_len))
    got = tda.flash_prefill(_t(q), _t(k), _t(v), cur_len).numpy()
    assert _max_err(got, want) <= ATTN_TOL
    assert _max_err(got, ref) <= ATTN_TOL


@pytest.mark.parametrize("t,cur_len,s", [(77, 77, 77), (77, 60, 9),
                                         (33, 17, 17)])
def test_flash_prefill_ragged_cache_matches_jax_ref(t, cur_len, s):
    q, k, v = _prefill_case(1, 2, s, t, 4, 2, 16)
    ref = np.asarray(jda.flash_prefill_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), cur_len))
    got = tda.flash_prefill(_t(q), _t(k), _t(v), cur_len).numpy()
    assert _max_err(got, ref) <= ATTN_TOL
    # cached_attention routes S > 1 through flash_prefill: same numbers
    via = tda.cached_attention(_t(q), _t(k), _t(v), cur_len).numpy()
    np.testing.assert_array_equal(via, got)


def test_cached_attention_decode_row_matches_jax_dense():
    q, k, v = _prefill_case(2, 2, 1, 40, 4, 2, 16)
    ref = np.asarray(jda.cached_attention_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 31))
    got = tda.cached_attention(_t(q), _t(k), _t(v), 31).numpy()
    assert _max_err(got, ref) <= ATTN_TOL


# ---------------------------------------------------------- paged attention
def _paged_case(seed, b=3, h=4, hkv=2, d=16, page=8, num_pages=16, maxp=4,
                seq_lens=(13, 0, 29)):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, d)) * 0.5).astype(np.float32)
    kp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    bt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(num_pages - 1) + 1      # page 0 is the null page
    used = 0
    for i, n in enumerate(seq_lens):
        pages = -(-n // page)
        bt[i, :pages] = perm[used:used + pages]
        used += pages
    return q, kp, vp, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("h,hkv,seq_lens", [(4, 2, (13, 0, 29)),
                                            (2, 2, (8, 16, 1)),
                                            (8, 2, (32, 5, 0))])
def test_paged_attention_matches_jax(h, hkv, seq_lens):
    q, kp, vp, bt, sl = _paged_case(3, h=h, hkv=hkv, seq_lens=seq_lens)
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, sl)]
    want = np.asarray(jpa.paged_attention(*args))
    ref = np.asarray(jpa.paged_attention_xla(*args))
    got = tpa.paged_attention(*(_t(a) for a in (q, kp, vp, bt, sl))).numpy()
    assert _max_err(got, want) <= ATTN_TOL
    # the gather reference averages an empty row's masked scores; the
    # kernels emit zeros there, which the Pallas arm above already holds
    live = np.asarray(seq_lens) > 0
    assert _max_err(got[live], ref[live]) <= ATTN_TOL
    # a sequence with no tokens (idle slot on the null page) reads zeros
    assert not np.any(got[~live])


# ------------------------------------------------------------- pool writes
def test_write_paged_kv_exact():
    rng = np.random.default_rng(4)
    kp = np.zeros((2, 6, 8, 16), np.float32)
    vp = np.zeros_like(kp)
    bt = np.array([[2, 4], [5, 0], [0, 0]], np.int32)
    pos = np.array([9, 3, 0], np.int32)
    k_new = rng.standard_normal((3, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, 16)).astype(np.float32)
    jk, jv = jpa.write_paged_kv(jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(k_new), jnp.asarray(v_new), bt,
                                pos)
    tk_, tv_ = tpa.write_paged_kv(_t(kp), _t(vp), _t(k_new), _t(v_new),
                                  _t(bt), _t(pos))
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv))


@pytest.mark.parametrize("s", [13, 16, 20])
def test_write_paged_prompt_exact(s):
    """Spans pages; positions past the table's width (s=20 > 2 pages of 8)
    are dropped, as in the JAX package."""
    rng = np.random.default_rng(5)
    kp = np.zeros((2, 6, 8, 16), np.float32)
    vp = np.zeros_like(kp)
    bt = np.array([[1, 3], [4, 2]], np.int32)
    k_new = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    jk, jv = jpa.write_paged_prompt(jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(k_new), jnp.asarray(v_new),
                                    bt)
    tk_, tv_ = tpa.write_paged_prompt(_t(kp), _t(vp), _t(k_new), _t(v_new),
                                      _t(bt))
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv))


# ------------------------------------------------------- fused block decode
def _block_case(seed, b=3, hidden=64, nh=4, nkv=2, inter=128, page=8,
                num_pages=16, mp=4, seq_lens=(5, 8, 11)):
    rng = np.random.default_rng(seed)
    d = hidden // nh

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)

    w = dict(ln1=norm(), wq=mk(hidden, nh * d), wk=mk(hidden, nkv * d),
             wv=mk(hidden, nkv * d), wo=mk(nh * d, hidden), ln2=norm(),
             wg=mk(hidden, inter), wu=mk(hidden, inter), wd=mk(inter, hidden))
    x = mk(b, hidden)
    kp = mk(nkv, num_pages, page, d)
    vp = mk(nkv, num_pages, page, d)
    perm = rng.permutation(num_pages - 1)[:b * mp].reshape(b, mp) + 1
    bt = perm.astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    return x, w, kp, vp, bt, sl, kw


@pytest.mark.parametrize("nkv,seq_lens", [(2, (5, 8, 11)), (4, (0, 31, 8)),
                                          (1, (16, 1, 24))])
def test_fused_block_decode_matches_jax(nkv, seq_lens):
    x, w, kp, vp, bt, sl, kw = _block_case(6, nkv=nkv, seq_lens=seq_lens)
    jw = jfb.BlockDecodeWeights(**{n: jnp.asarray(a) for n, a in w.items()})
    jargs = [jnp.asarray(a) for a in (x,)]
    want = jfb.fused_block_decode_pallas(
        jargs[0], jw, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), interpret=True, **kw)
    ref = jfb.fused_block_decode_ref(
        jargs[0], jw, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), **kw)
    tw = tfb.BlockDecodeWeights(**{n: _t(a) for n, a in w.items()})
    got = tfb.fused_block_decode(_t(x), tw, _t(kp), _t(vp), _t(bt), _t(sl),
                                 **kw)
    assert len(got) == 3
    for g, wa, r in zip(got, want, ref):
        assert _max_err(g.numpy(), np.asarray(wa)) <= BLOCK_TOL
        assert _max_err(g.numpy(), np.asarray(r)) <= BLOCK_TOL


def test_rope_tables_and_rms_match_jax():
    rng = np.random.default_rng(7)
    sl = np.array([0, 7, 511], np.int32)
    js, jc = jfb._rope_tables(jnp.asarray(sl), 16, 10000.0)
    ts, tc = tfb._rope_tables(_t(sl), 16, 10000.0)
    assert _max_err(ts.numpy(), js) <= 1e-5
    assert _max_err(tc.numpy(), jc) <= 1e-5
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jfb._rms(jnp.asarray(x), jnp.asarray(w), 1e-5))
    assert _max_err(tfb._rms(_t(x), _t(w), 1e-5).numpy(), want) <= 1e-6


def test_cpu_tensors_never_count_as_launches():
    tk.reset_launches()
    q, k, v = _prefill_case(8, 1, 5, 5, 2, 2, 8)
    tda.flash_prefill(_t(q), _t(k), _t(v), 5)
    q, kp, vp, bt, sl = _paged_case(9)
    tpa.paged_attention(*(_t(a) for a in (q, kp, vp, bt, sl)))
    x, w, kp, vp, bt, sl, kw = _block_case(10)
    tw = tfb.BlockDecodeWeights(**{n: _t(a) for n, a in w.items()})
    tfb.fused_block_decode(_t(x), tw, _t(kp), _t(vp), _t(bt), _t(sl), **kw)
    qf = torch.zeros(4, 6, 8, requires_grad=True)
    tfa.flash_attention(qf, qf[:2], qf[:2], n_heads=2,
                        n_kv_heads=1).sum().backward()
    assert tk.launch_counts() == {
        "flash_prefill": 0, "paged_attention": 0, "paged_attention_int8": 0,
        "paged_chunk_attention": 0, "paged_chunk_attention_int8": 0,
        "fused_block_decode": 0, "fused_block_decode_int8": 0,
        "fused_multi_block_decode": 0, "fused_multi_block_decode_int8": 0,
        "fused_multi_block_decode_int4": 0,
        "fused_multi_block_decode_int8_int4": 0, "flash_attention_fwd": 0,
        "flash_attention_fwd_seg": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dq_seg": 0, "flash_attention_bwd_dkv": 0,
        "flash_attention_bwd_dkv_seg": 0, "rms_norm_fwd": 0,
        "rms_norm_bwd_dx": 0}
