"""The int8 KV pool and the int4 weight tiles in the PyTorch port against
the JAX package (the port's side of ``tests/test_kv_quant.py``).

On the same seeded numpy inputs:
  - ``quantize_kv_rows`` gives JAX's payload and scale bit for bit, all-zero
    rows included (scale 0), from float32 and bfloat16 rows;
  - the int8 pool writes (``write_paged_kv``, ``write_paged_prompt_at``
    with a padded final chunk past the table, ``write_paged_prompt``)
    leave pool bits identical to JAX's, and a prompt written as one chunk
    or token by token leaves identical bits;
  - the plain readers (``paged_attention_ref``,
    ``paged_chunk_attention_ref``, what the kernel wrappers run for CPU
    tensors) on one int8 pool agree with JAX's Pallas kernels (interpret
    mode) and their XLA twins within JAX's KTOL (2e-5), and with the
    native-pool result within JAX's QTOL (3e-2);
  - ``fused_block_decode_ref`` on an int8 pool agrees with JAX's
    ``fused_block_decode_pallas`` (interpret) within 2e-5; it appends the
    quantized rows of its own native-pool step bit for bit, and JAX's
    rows up to the last bit of the f32 k/v (payload within 1, scale
    within relative 1e-6);
  - ``pack_int4_tiles``, ``_int4_plan`` and ``stack_block_weights(int4)``
    give JAX's bits; the round trip is exact on the quantization grid and
    bounded off it; odd tiling is refused; the port's copy of ``tile()``
    is JAX's over n in 1..12288 for both targets;
  - ``fused_multi_block_decode_ref`` at N = 2 for (int8, native),
    (native, int4) and (int8, int4) agrees with JAX's
    ``fused_multi_block_decode_pallas`` (interpret) within 2e-5, its int8
    pool bits as the one-layer step's, and is the chain of the one-layer
    plain version bit for bit;
  - ``PagedKVCache(kv_dtype="int8").bytes_per_page`` is JAX's;
  - the engine on a tiny Llama in fp32 serves the JAX engine's greedy
    streams under the same settings: int8 with fused (N = 1) and generic
    decode, whole and chunked prompts, and N = 2 with int8 and int4; its
    first tokens equal the native run's; int4 at N = 1 changes nothing.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.analysis.tile_geometry import tile as jtile
from paddle_tpu.generation.serving import ServingEngine as JServingEngine
from paddle_tpu.kernels import fused_block_decode as jfb
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import fused_block_decode as tfb
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

# JAX's tolerances (tests/test_kv_quant.py): readers over one int8 pool
# differ only by kernel arithmetic; int8 vs the native pool by the
# quantization step
KTOL = 2e-5
QTOL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _jq(pool):
    """A dense numpy pool as JAX QuantizedPages (per-row quantized)."""
    return jpa.QuantizedPages(*jpa.quantize_kv_rows(jnp.asarray(pool)))


def _tq(pool):
    return tpa.QuantizedPages(*tpa.quantize_kv_rows(_t(pool)))


def _same_bits(port, jax_pool):
    np.testing.assert_array_equal(port.q.numpy(), np.asarray(jax_pool.q))
    np.testing.assert_array_equal(port.scale.numpy(),
                                  np.asarray(jax_pool.scale))


def _rows_agree(port, jax_pool):
    """Pool bits that may differ only where the two frameworks' f32 k/v
    rows differ in the last bit: payload by at most 1, the scale by
    relative 1e-6."""
    dq = port.q.numpy().astype(np.int32) - np.asarray(jax_pool.q)
    assert np.abs(dq).max() <= 1
    want = np.asarray(jax_pool.scale)
    np.testing.assert_allclose(port.scale.numpy(), want, rtol=1e-6, atol=0)


def _pool(rng, hkv=2, num_pages=16, page=8, d=32):
    return [(rng.standard_normal((hkv, num_pages, page, d)) * 0.5)
            .astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------- storage
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bits_equal_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 32)) * 2.0).astype(np.float32)
    x[0, 1] = 0.0                          # all-zero rows: scale 0
    x[2, 3, 1] = 0.0
    x[1, 2, 0, 7] = 1e-30                   # a denormal-scale row
    x[1, 2, 0, :7] = 0.0
    x[1, 2, 0, 8:] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = jpa.quantize_kv_rows(jx)
    tq, ts = tpa.quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not ts[0, 1].any() and not tq[0, 1].any()


def test_quantized_pages_geometry():
    kp, _ = _pool(np.random.default_rng(1))
    qp = _tq(kp)
    assert qp.shape == qp.q.shape and qp.dtype == torch.int8
    assert qp.device.type == "cpu" and qp.shape[2] == 8


def test_write_paged_kv_bits_equal_jax():
    rng = np.random.default_rng(2)
    kp, vp = _pool(rng)
    k_new = rng.standard_normal((3, 2, 32)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, 32)).astype(np.float32)
    v_new[1] = 0.0
    bt = np.array([[3, 4, 0], [5, 6, 7], [0, 0, 0]], np.int32)
    pos = np.array([9, 17, 0], np.int32)
    jk, jv = jpa.write_paged_kv(_jq(kp), _jq(vp), jnp.asarray(k_new),
                                jnp.asarray(v_new), jnp.asarray(bt),
                                jnp.asarray(pos))
    tk, tv = _tq(kp), _tq(vp)
    out = tpa.write_paged_kv(tk, tv, _t(k_new), _t(v_new), _t(bt), _t(pos))
    assert out[0] is tk and out[1] is tv      # in place
    _same_bits(tk, jk)
    _same_bits(tv, jv)


@pytest.mark.parametrize("start,s", [(5, 8), (11, 16), (0, 24)],
                         ids=["mid-page", "padded-past-table",
                              "whole-table-plus-pad"])
def test_write_paged_prompt_at_bits_equal_jax(start, s):
    """Two sequences; the later cases run past the 3-page table, whose
    positions are dropped in the payload and the scale alike."""
    rng = np.random.default_rng(3 + s)
    kp, vp = _pool(rng)
    ck = rng.standard_normal((2, s, 2, 32)).astype(np.float32)
    cv = rng.standard_normal((2, s, 2, 32)).astype(np.float32)
    bt = np.array([[3, 4, 5], [6, 7, 8]], np.int32)
    st = np.array([start, max(start - 3, 0)], np.int32)
    jk, jv = jpa.write_paged_prompt_at(_jq(kp), _jq(vp), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(bt),
                                       jnp.asarray(st))
    tk, tv = _tq(kp), _tq(vp)
    tpa.write_paged_prompt_at(tk, tv, _t(ck), _t(cv), _t(bt), _t(st))
    _same_bits(tk, jk)
    _same_bits(tv, jv)


def test_write_paged_prompt_bits_equal_jax():
    rng = np.random.default_rng(4)
    kp, vp = _pool(rng)
    ck = rng.standard_normal((2, 11, 2, 32)).astype(np.float32)
    cv = rng.standard_normal((2, 11, 2, 32)).astype(np.float32)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    jk, jv = jpa.write_paged_prompt(_jq(kp), _jq(vp), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(bt))
    tk, tv = _tq(kp), _tq(vp)
    tpa.write_paged_prompt(tk, tv, _t(ck), _t(cv), _t(bt))
    _same_bits(tk, jk)
    _same_bits(tv, jv)


def test_write_order_independent_bits():
    """One prompt written as a chunk and token by token: identical bits
    (the per-row scale makes a row's bits its own)."""
    rng = np.random.default_rng(5)
    b, s, hkv, d, page, num_pages = 2, 11, 2, 16, 8, 8
    ck = _t(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    cv = _t(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    bt = torch.tensor([[1, 2, 0], [3, 4, 0]], dtype=torch.int32)

    def zero():
        return tpa.QuantizedPages(
            torch.zeros((hkv, num_pages, page, d), dtype=torch.int8),
            torch.zeros((hkv, num_pages, page, 1)))

    k1, v1 = tpa.write_paged_prompt_at(zero(), zero(), ck, cv, bt,
                                       torch.zeros((b,), dtype=torch.int32))
    k2, v2 = zero(), zero()
    for t in range(s):
        tpa.write_paged_kv(k2, v2, ck[:, t], cv[:, t], bt,
                           torch.full((b,), t, dtype=torch.int32))
    for got, want in ((k2, k1), (v2, v1)):
        assert torch.equal(got.q, want.q)
        assert torch.equal(got.scale, want.scale)


@pytest.mark.parametrize("kv_dtype,dtype", [
    ("int8", torch.bfloat16), ("native", torch.bfloat16),
    ("native", torch.float32)])
def test_bytes_per_page_equals_jax(kv_dtype, dtype):
    geo = dict(num_layers=2, num_pages=8, page_size=8, num_kv_heads=2,
               head_dim=16, max_batch=2, max_seq_len=64)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jpa.PagedKVCache(dtype=jdt, kv_dtype=kv_dtype, **geo)
    got = tpa.PagedKVCache(dtype=dtype, kv_dtype=kv_dtype, device="cpu",
                           **geo)
    assert got.bytes_per_page == want.bytes_per_page
    if kv_dtype == "int8":
        assert got.bytes_per_page == 2 * 2 * 2 * 8 * (16 + 4)
        assert isinstance(got.k_pages[0], tpa.QuantizedPages)
        assert got.k_pages[0].scale.shape == (2, 8, 8, 1)
    with pytest.raises(ValueError, match="kv_dtype"):
        tpa.PagedKVCache(kv_dtype="fp8", device="cpu", **geo)


# ---------------------------------------------------------------- readers
def test_decode_reader_matches_jax():
    rng = np.random.default_rng(6)
    b, h, hkv, d, page, num_pages = 3, 8, 2, 32, 8, 16
    kp, vp = _pool(rng, hkv, num_pages, page, d)
    q = (rng.standard_normal((b, h, d)) * 0.5).astype(np.float32)
    bt = np.zeros((b, 4), np.int32)
    perm = rng.permutation(num_pages)
    bt[0, :2], bt[1, :4], bt[2, :1] = perm[:2], perm[2:6], perm[6:7]
    sl = np.array([13, 29, 5], np.int32)
    jargs = (jnp.asarray(q), _jq(kp), _jq(vp), jnp.asarray(bt),
             jnp.asarray(sl))
    got = tpa.paged_attention(_t(q), _tq(kp), _tq(vp), _t(bt), _t(sl))
    _close(got.numpy(), jpa.paged_attention(*jargs), KTOL)
    _close(got.numpy(), jpa.paged_attention_xla(*jargs), KTOL)
    native = tpa.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(sl))
    _close(got.numpy(), native.numpy(), QTOL)


@pytest.mark.parametrize("start", [(5, 11), (0, 8)], ids=["mid-page",
                                                          "aligned"])
def test_chunk_reader_matches_jax(start):
    """Chunk written through ``write_paged_prompt_at`` first
    (write-then-attend), GQA rep 2."""
    rng = np.random.default_rng(7)
    b, s, h, hkv, d, page, num_pages = 2, 8, 4, 2, 16, 8, 13
    kp, vp = _pool(rng, hkv, num_pages, page, d)
    q = (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    ck = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    bt = (rng.permutation(num_pages - 1)[:b * 6].reshape(b, 6) + 1
          ).astype(np.int32)
    st = np.asarray(start, np.int32)
    jk, jv = jpa.write_paged_prompt_at(_jq(kp), _jq(vp), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(bt),
                                       jnp.asarray(st))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(st))
    tk, tv = _tq(kp), _tq(vp)
    tpa.write_paged_prompt_at(tk, tv, _t(ck), _t(cv), _t(bt), _t(st))
    got = tpa.paged_chunk_attention(_t(q), tk, tv, _t(bt), _t(st))
    _close(got.numpy(), jpa.paged_chunk_attention(*jargs), KTOL)
    _close(got.numpy(), jpa.paged_chunk_attention_xla(*jargs), KTOL)
    nk, nv = _t(kp), _t(vp)
    tpa.write_paged_prompt_at(nk, nv, _t(ck), _t(cv), _t(bt), _t(st))
    native = tpa.paged_chunk_attention_ref(_t(q), nk, nv, _t(bt), _t(st))
    _close(got.numpy(), native.numpy(), QTOL)


# ----------------------------------------------------------- fused decode
def _layers(rng, n, b=3, hidden=64, nh=4, nkv=2, inter=128, page=8,
            num_pages=16, mp=4, seq_lens=(5, 8, 11)):
    """n layers' weights, x, n pool pairs, block tables and lengths as
    numpy float32: the JAX tests' shapes."""
    d = hidden // nh

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)

    layers = [dict(ln1=norm(), wq=mk(hidden, nh * d), wk=mk(hidden, nkv * d),
                   wv=mk(hidden, nkv * d), wo=mk(nh * d, hidden), ln2=norm(),
                   wg=mk(hidden, inter), wu=mk(hidden, inter),
                   wd=mk(inter, hidden)) for _ in range(n)]
    x = mk(b, hidden)
    kps = [mk(nkv, num_pages, page, d) for _ in range(n)]
    vps = [mk(nkv, num_pages, page, d) for _ in range(n)]
    perm = rng.permutation(num_pages - 1)[:b * mp].reshape(b, mp) + 1
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    return (layers, x, kps, vps, perm.astype(np.int32),
            np.asarray(seq_lens, np.int32), kw)


def _jw(w):
    return jfb.BlockDecodeWeights(**{k: jnp.asarray(v) for k, v in w.items()})


def _tw(w):
    return tfb.BlockDecodeWeights(**{k: _t(v) for k, v in w.items()})


def test_fused_block_decode_int8_matches_jax():
    """Output within KTOL of JAX's kernel. The appended rows are the
    quantized rows of the port's own native-pool step, bit for bit; against
    JAX's kernel they may differ where the f32 k/v rows do in the last bit
    (the two frameworks' f32 RMSNorm rounds differently: torch's rsqrt is
    1/sqrt, XLA's is correctly rounded, and the mean sums in another
    order; JAX's own kernel and ref part the same way here)."""
    layers, x, kps, vps, bt, sl, kw = _layers(np.random.default_rng(8), 1,
                                              seq_lens=(5, 8, 0))
    want, jk, jv = jfb.fused_block_decode_pallas(
        jnp.asarray(x), _jw(layers[0]), _jq(kps[0]), _jq(vps[0]),
        jnp.asarray(bt), jnp.asarray(sl), interpret=True, **kw)
    tk, tv = _tq(kps[0]), _tq(vps[0])
    got, gk, gv = tfb.fused_block_decode(_t(x), _tw(layers[0]), tk, tv,
                                         _t(bt), _t(sl), **kw)
    assert gk is tk and gv is tv
    _close(got.numpy(), want, KTOL)
    _rows_agree(gk, jk)
    _rows_agree(gv, jv)
    nk, nv = _t(kps[0]), _t(vps[0])
    native, nk, nv = tfb.fused_block_decode_ref(
        _t(x), _tw(layers[0]), nk, nv, _t(bt), _t(sl), **kw)
    _close(got.numpy(), native.numpy(), QTOL)
    # the new rows, position seq_lens of each row's table, as stored
    rows = (bt[np.arange(3), sl // 8], sl % 8)
    for quant, pool in ((gk, nk), (gv, nv)):
        q, scale = tpa.quantize_kv_rows(pool[:, rows[0], rows[1]])
        assert torch.equal(quant.q[:, rows[0], rows[1]], q)
        assert torch.equal(quant.scale[:, rows[0], rows[1]], scale)


@pytest.mark.parametrize("kv8,wt4", [(True, False), (False, True),
                                     (True, True)],
                         ids=["int8-native", "native-int4", "int8-int4"])
def test_multi_block_quantized_matches_jax(kv8, wt4):
    layers, x, kps, vps, bt, sl, kw = _layers(
        np.random.default_rng(40 + 2 * kv8 + wt4), 2)
    wdt = "int4" if wt4 else "native"
    jw = jfb.stack_block_weights([_jw(w) for w in layers], weight_dtype=wdt)
    tw = tfb.stack_block_weights([_tw(w) for w in layers], weight_dtype=wdt)
    if kv8:
        jk, jv = [_jq(p) for p in kps], [_jq(p) for p in vps]
        tk, tv = [_tq(p) for p in kps], [_tq(p) for p in vps]
    else:
        jk, jv = [jnp.asarray(p) for p in kps], [jnp.asarray(p) for p in vps]
        tk, tv = [_t(p) for p in kps], [_t(p) for p in vps]
    want, wk, wv = jfb.fused_multi_block_decode_pallas(
        jnp.asarray(x), jw, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
        interpret=True, **kw)
    got, gk, gv = tfb.fused_multi_block_decode(_t(x), tw, tk, tv, _t(bt),
                                               _t(sl), **kw)
    _close(got.numpy(), want, KTOL)
    for i in range(2):
        if kv8:
            _rows_agree(gk[i], wk[i])
            _rows_agree(gv[i], wv[i])
        else:
            _close(gk[i].numpy(), wk[i], KTOL)
            _close(gv[i].numpy(), wv[i], KTOL)


def test_multi_block_int8_is_the_per_layer_chain_bitwise():
    """An int8 group's plain version is the chain of the one-layer plain
    version, bit for bit (the merged projections contract the same
    columns), as for native pools."""
    layers, x, kps, vps, bt, sl, kw = _layers(np.random.default_rng(9), 2,
                                              seq_lens=(0, 8, 11))
    ws = [_tw(w) for w in layers]
    chain = [(_tq(k), _tq(v)) for k, v in zip(kps, vps)]
    out = _t(x)
    for w, (k, v) in zip(ws, chain):
        out, _, _ = tfb.fused_block_decode_ref(out, w, k, v, _t(bt), _t(sl),
                                               **kw)
    got, gk, gv = tfb.fused_multi_block_decode_ref(
        _t(x), tfb.stack_block_weights(ws), [_tq(k) for k in kps],
        [_tq(v) for v in vps], _t(bt), _t(sl), **kw)
    assert torch.equal(got, out)
    for i, (k, v) in enumerate(chain):
        assert torch.equal(gk[i].q, k.q) and torch.equal(gk[i].scale, k.scale)
        assert torch.equal(gv[i].q, v.q) and torch.equal(gv[i].scale, v.scale)


# -------------------------------------------------------------- int4 tiles
@pytest.mark.parametrize("shape,tile", [((2, 32, 24), (8, 12)),
                                        ((1, 64, 128), (64, 128)),
                                        ((3, 16, 40), (2, 8))])
def test_pack_int4_tiles_bits_equal_jax(shape, tile):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[0, :tile[0], :tile[1]] = 0.0            # an all-zero tile: scale 0
    want = jfb.pack_int4_tiles(jnp.asarray(w), *tile)
    got = tfb.pack_int4_tiles(_t(w), *tile)
    assert got.q.dtype == torch.uint8 and got.tiles == tile
    assert got.shape == shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tfb.unpack_int4_tiles(got).numpy(),
                                  np.asarray(jfb.unpack_int4_tiles(want)))


def test_int4_roundtrip_exact_on_grid():
    rng = np.random.default_rng(4)
    n, rows, cols, tr, tc = 2, 32, 24, 8, 12
    levels = rng.integers(-7, 8, (n, rows, cols)).astype(np.float32)
    levels[:, ::tr, ::tc] = 7.0          # every tile's amax is 7 levels
    tile_scale = np.exp2(rng.integers(-1, 2, (n, rows // tr, cols // tc))
                         ).astype(np.float32)
    w = levels * np.repeat(np.repeat(tile_scale, tr, 1), tc, 2)
    t = tfb.pack_int4_tiles(_t(w), tr, tc)
    assert t.q.shape == (n, rows // 2, cols)
    np.testing.assert_array_equal(tfb.unpack_int4_tiles(t).numpy(), w)


def test_int4_error_bounded_off_grid():
    w = np.random.default_rng(5).standard_normal((1, 16, 16)).astype(
        np.float32)
    back = tfb.unpack_int4_tiles(tfb.pack_int4_tiles(_t(w), 8, 8)).numpy()
    for r in range(2):
        for c in range(2):
            tile = w[0, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
            err = np.abs(back[0, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
                         - tile)
            assert err.max() <= np.abs(tile).max() / 14 + 1e-6


def test_int4_odd_tiling_refused():
    with pytest.raises(ValueError):
        tfb.pack_int4_tiles(torch.zeros((1, 9, 8)), 3, 8)
    with pytest.raises(ValueError):
        tfb.pack_int4_tiles(torch.zeros((1, 16, 8)), 8, 3)
    with pytest.raises(ValueError, match="even"):
        tfb._int4_plan(hidden=63, qw=64, kvw=32, inter=128)


@pytest.mark.parametrize("target", [512, 256])
def test_tile_is_a_copy_of_jax(target):
    assert [tfb._tile(n, target) for n in range(1, 12289)] == \
        [jtile(n, target) for n in range(1, 12289)]


@pytest.mark.parametrize("dims", [(64, 64, 32, 128), (4096, 4096, 4096,
                                                       11008)],
                         ids=["tiny", "llama2-7b"])
def test_int4_plan_equals_jax(dims):
    assert tfb._int4_plan(*dims) == jfb._int4_plan(*dims)


def test_stack_block_weights_int4_bits_equal_jax():
    layers, *_ = _layers(np.random.default_rng(11), 3)
    want = jfb.stack_block_weights([_jw(w) for w in layers],
                                   weight_dtype="int4")
    got = tfb.stack_block_weights([_tw(w) for w in layers],
                                  weight_dtype="int4")
    assert got.n_layers == 3
    for name in ("wqkv", "wo", "wgu", "wd"):
        g, w = getattr(got, name), getattr(want, name)
        assert isinstance(g, tfb.Int4Tiles)
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), name)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale),
                                      name)
    for name in ("ln1", "ln2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# ------------------------------------------------------------------ engine
ENGINE = dict(max_batch=2, page_size=8, max_seq_len=48)
PROMPT_LENS = (5, 9, 13, 7, 16)
NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(91)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _drive(eng):
    """Staggered admission; the token streams in submit order."""
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 256, (n,)).astype(np.int32) for n in PROMPT_LENS]
    rids = [eng.submit(ps[0], NEW), eng.submit(ps[1], NEW)]
    eng.step()
    rids += [eng.submit(p, NEW) for p in ps[2:]]
    out = eng.run()
    return [out[r] for r in rids]


def _port(model, fused=True, layers=1, **kw):
    tflags.set_flags({"fused_block_decode": fused,
                      "fused_block_layers": layers})
    try:
        eng = ServingEngine(model, **ENGINE, **kw)
        assert (eng._spec is not None) == fused
        assert (eng._stacked is not None) == (fused and layers > 1)
        return eng, _drive(eng)
    finally:
        tflags.reset_flags()


def _jax(jmodel, fused=True, layers=1, **kw):
    old = {k: jflags.get_flag(k) for k in ("fused_block_decode",
                                           "fused_block_layers")}
    jflags.set_flags({"fused_block_decode": fused,
                      "fused_block_layers": layers})
    try:
        return _drive(JServingEngine(jmodel, **ENGINE, **kw))
    finally:
        jflags.set_flags(old)


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("fused,layers,weight_dtype", [
    (True, 1, "native"), (False, 1, "native"), (True, 2, "int4")],
    ids=["fused", "generic", "nlayer2-int4"])
def test_int8_streams_identical_to_jax(models, fused, layers, weight_dtype,
                                       chunk):
    jmodel, model = models
    kw = dict(kv_dtype="int8", weight_dtype=weight_dtype,
              prefill_chunk=chunk)
    want = _jax(jmodel, fused, layers, **kw)
    eng, got = _port(model, fused, layers, **kw)
    assert isinstance(eng.pool.k_pages[0], tpa.QuantizedPages)
    if layers > 1:
        assert isinstance(eng._stacked[0].wqkv, tfb.Int4Tiles)
    assert all(len(t) == NEW for t in got)
    assert got == want
    assert eng.pool.free_page_count() == eng.pool.num_pages - 1
    if not chunk:
        # the first token comes off the native-precision whole prefill
        _, native = _port(model, fused, layers)
        assert [t[0] for t in got] == [t[0] for t in native]


def test_int4_at_one_layer_changes_nothing(models):
    _, model = models
    eng, got = _port(model, weight_dtype="int4")
    assert eng.weight_dtype == "int4" and eng._stacked is None
    assert got == _port(model)[1]


def test_flags_reach_the_engine(models, monkeypatch):
    _, model = models
    monkeypatch.setenv("FLAGS_serving_kv_dtype", "int8")
    monkeypatch.setenv("FLAGS_fused_weight_dtype", "int4")
    monkeypatch.setenv("FLAGS_fused_block_layers", "2")
    eng = ServingEngine(model, **ENGINE)
    assert eng.kv_dtype == "int8" and eng.weight_dtype == "int4"
    assert isinstance(eng.pool.v_pages[1], tpa.QuantizedPages)
    assert isinstance(eng._stacked[0].wd, tfb.Int4Tiles)
