"""Paddle's fused serving entry points in the port
(``paddle_tpu_torch.incubate.nn.functional``) against the JAX package's, on
the same seeded numpy inputs, in fp32 (1e-5 abs; written caches and pools
bit for bit where both sides store the same values):

- ``block_multihead_attention``: the decode phase and the prefill phase
  (out and pools), a mixed and a partly inactive batch refused, an option
  the op does not fold refused and the reference's defaults taken, as
  ``tests/test_paged_attention.py`` holds the JAX wrapper;
- ``fused_multi_transformer`` in each option (pre- and post-LN, gelu and
  relu, ``trans_qkvw`` both ways, with and without biases, rotary tables):
  a prefill with caches then decode steps equal the no-cache forward of
  the whole sequence, and every call equals the JAX one;
- ``masked_multihead_attention`` and ``fused_block_decode`` against the
  JAX functions, and the options ``masked_multihead_attention`` does not
  fold refused.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JFF
import paddle_tpu_torch.incubate.nn.functional as TFF

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return paddle.to_tensor(np.array(x))


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _pool(rng, hkv=2, num_pages=8, page=8, d=16):
    return [(rng.standard_normal((hkv, num_pages, page, d)) * 0.5).astype(
        np.float32) for _ in range(2)]


# ------------------------------------------------ block_multihead_attention
def test_bmha_decode_phase_matches_jax():
    rng = np.random.default_rng(9)
    b, h, d = 3, 2, 16
    kp, vp = _pool(rng, h, d=d)
    bt = np.array([[1, 3], [5, 2], [4, 6]], np.int32)
    dec = np.array([9, 4, 15], np.int32)
    qkv = (rng.standard_normal((b, 1, 3, h, d)) * 0.5).astype(np.float32)
    lens = (np.zeros(b, np.int32), dec, np.ones(b, np.int32), bt)
    jo, jk, jv = JFF.block_multihead_attention(_j(qkv), _j(kp), _j(vp),
                                               *lens)
    tk, tv = _t(kp), _t(vp)
    to, tk2, tv2 = TFF.block_multihead_attention(_t(qkv), tk, tv, *lens)
    assert tk2 is tk and tv2 is tv
    assert to.shape == (b, 1, h * d)
    _close(to, jo)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))


def test_bmha_prefill_phase_matches_jax():
    rng = np.random.default_rng(10)
    b, s, h, d = 2, 13, 2, 16
    kp = np.zeros((h, 6, 8, d), np.float32)
    vp = np.zeros_like(kp)
    bt = np.array([[2, 4], [1, 5]], np.int32)
    qkv = (rng.standard_normal((b, s, 3, h, d)) * 0.5).astype(np.float32)
    lens = (np.full(b, s, np.int32), np.zeros(b, np.int32),
            np.full(b, s, np.int32), bt)
    jo, jk, jv = JFF.block_multihead_attention(_j(qkv), _j(kp), _j(vp),
                                               *lens)
    tk, tv = _t(kp), _t(vp)
    to, _, _ = TFF.block_multihead_attention(_t(qkv), tk, tv, *lens)
    assert to.shape == (b, s, h * d)
    _close(to, jo)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))


@pytest.mark.parametrize("enc,dec,this", [
    ([0, 0], [5, 0], [1, 0]),            # an inactive row
    ([4, 0], [0, 5], [1, 1]),            # a prefill row beside a decode row
])
def test_bmha_mixed_or_inactive_batches_refused(enc, dec, this):
    rng = np.random.default_rng(12)
    kp, vp = _pool(rng)
    qkv = _t(rng.standard_normal((2, 1, 3, 2, 16)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="uniform"):
        TFF.block_multihead_attention(
            qkv, _t(kp), _t(vp), np.array(enc, np.int32),
            np.array(dec, np.int32), np.array(this, np.int32),
            np.array([[1, 2], [3, 4]], np.int32))


def test_bmha_kwargs_refused_and_reference_defaults_taken():
    rng = np.random.default_rng(11)
    kp, vp = _pool(rng)
    qkv = _t(rng.standard_normal((1, 1, 3, 2, 16)).astype(np.float32))
    lens = (np.zeros(1, np.int32), np.array([5], np.int32),
            np.ones(1, np.int32), np.array([[1, 2]], np.int32))
    with pytest.raises(NotImplementedError, match="rope"):
        TFF.block_multihead_attention(qkv, _t(kp), _t(vp), *lens,
                                      rotary_embs=object())
    out, _, _ = TFF.block_multihead_attention(
        qkv, _t(kp), _t(vp), *lens, max_seq_len=-1, use_neox_style=False,
        quant_round_type=1, quant_max_bound=127.0, quant_min_bound=-127.0,
        compute_dtype="default")
    assert out.shape == (1, 1, 32)


# ------------------------------------------------- fused_multi_transformer
FMT_OPTIONS = {
    "pre-LN gelu": dict(),
    "post-LN relu": dict(pre_layer_norm=False, activation="relu"),
    "E-major qkv": dict(trans_qkvw=False),
    "no biases": dict(biases=False),
    "rotary": dict(rotary=True),
}


def _fmt_weights(rng, layers, h, nh, ffn, trans_qkvw, biases):
    d = h // nh

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def each(*shape):
        return [mk(*shape) for _ in range(layers)]

    qkv_shape = (3, nh, d, h) if trans_qkvw else (h, 3, nh, d)
    w = dict(ln_scales=[1.0 + mk(h) for _ in range(layers)],
             ln_biases=each(h), qkv_weights=each(*qkv_shape),
             qkv_biases=each(3, nh, d), linear_weights=each(h, h),
             linear_biases=each(h),
             ffn_ln_scales=[1.0 + mk(h) for _ in range(layers)],
             ffn_ln_biases=each(h), ffn1_weights=each(h, ffn),
             ffn1_biases=each(ffn), ffn2_weights=each(ffn, h),
             ffn2_biases=each(h))
    if not biases:
        for k in ("ln_biases", "qkv_biases", "linear_biases",
                  "ffn_ln_biases", "ffn1_biases", "ffn2_biases"):
            w[k] = []
    return w


def _rotary(b, s, d, start):
    pos = np.arange(start, start + s, dtype=np.float32)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    emb = np.concatenate([pos[:, None] * inv] * 2, axis=-1)
    tab = np.stack([np.cos(emb), np.sin(emb)])[:, None, None]    # (2,1,1,S,D)
    return np.ascontiguousarray(np.broadcast_to(tab, (2, b, 1, s, d)))


@pytest.mark.parametrize("option", list(FMT_OPTIONS))
def test_fmt_prefill_then_decode_matches_no_cache_and_jax(option):
    opt = dict(FMT_OPTIONS[option])
    rotary = opt.pop("rotary", False)
    biases = opt.pop("biases", True)
    rng = np.random.default_rng(5)
    layers, h, nh, ffn, b, s, steps, t = 2, 32, 4, 64, 2, 6, 3, 12
    d = h // nh
    w = _fmt_weights(rng, layers, h, nh, ffn, opt.get("trans_qkvw", True),
                     biases)
    tw = {k: [_t(x) for x in v] for k, v in w.items()}
    jw = {k: [_j(x) for x in v] for k, v in w.items()}
    x = (rng.standard_normal((b, s + steps, h)) * 0.1).astype(np.float32)

    def kw(start, n):
        if not rotary:
            return {}
        tab = _rotary(b, n, d, start)
        return dict(rotary_embs=tab, rotary_emb_dims=1)

    def port(xs, **extra):
        if "rotary_embs" in extra:
            extra["rotary_embs"] = _t(extra["rotary_embs"])
        return TFF.fused_multi_transformer(_t(xs), **tw, **opt, **extra)

    def jax(xs, **extra):
        if "rotary_embs" in extra:
            extra["rotary_embs"] = _j(extra["rotary_embs"])
        return JFF.fused_multi_transformer(_j(xs), **jw, **opt, **extra)

    full = port(x, **kw(0, s + steps))
    _close(full, jax(x, **kw(0, s + steps)))
    tc = [torch.zeros((2, b, nh, t, d)) for _ in range(layers)]
    jc = [_j(np.zeros((2, b, nh, t, d), np.float32)) for _ in range(layers)]
    out, tc2 = port(x[:, :s], cache_kvs=tc, time_step=0, **kw(0, s))
    assert all(a is c for a, c in zip(tc2, tc))       # updated in place
    jout, jc = jax(x[:, :s], cache_kvs=jc,
                   time_step=_j(np.array([0], np.int32)), **kw(0, s))
    _close(out, full[:, :s])
    _close(out, jout)
    for i in range(steps):
        pos = s + i
        out, _ = port(x[:, pos:pos + 1], cache_kvs=tc,
                      time_step=torch.tensor([pos], dtype=torch.int32),
                      **kw(pos, 1))
        jout, jc = jax(x[:, pos:pos + 1], cache_kvs=jc,
                       time_step=_j(np.array([pos], np.int32)),
                       **kw(pos, 1))
        _close(out, full[:, pos:pos + 1])
        _close(out, jout)
    for a, c in zip(tc, jc):
        _close(a, c)


# ------------------------------------------- masked_multihead_attention
def test_mmha_matches_jax():
    rng = np.random.default_rng(7)
    b, t, h, d, cur = 2, 10, 4, 16, 6
    cache = rng.standard_normal((2, b, t, h, d)).astype(np.float32)
    cache[:, :, cur + 1:] = 1e4                # junk past the written prefix
    x = rng.standard_normal((b, 3 * h * d)).astype(np.float32)
    jo, jc = JFF.masked_multihead_attention(_j(x), _j(cache),
                                            sequence_lengths=cur)
    tc = _t(cache)
    to, tc2 = TFF.masked_multihead_attention(_t(x), tc,
                                             sequence_lengths=cur)
    assert tc2 is tc and to.shape == (b, h * d)
    _close(to, jo)
    np.testing.assert_array_equal(tc.numpy(), _np(jc))


@pytest.mark.parametrize("option", ["bias", "src_mask", "rotary_tensor"])
def test_mmha_unfolded_options_refused(option):
    cache = torch.zeros((2, 1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="does not fold"):
        TFF.masked_multihead_attention(torch.zeros((1, 48)), cache,
                                       **{option: torch.zeros(1)})


# ------------------------------------------------------- fused_block_decode
@pytest.mark.parametrize("nh,nkv", [(4, 2), (4, 4)])
def test_fused_block_decode_matches_jax(nh, nkv):
    rng = np.random.default_rng(nh + nkv)
    b, hidden, d, inter, page = 3, 64, 16, 96, 8
    names = ("ln1_weight", "q_proj_weight", "k_proj_weight",
             "v_proj_weight", "out_proj_weight", "ln2_weight",
             "gate_proj_weight", "up_proj_weight", "down_proj_weight")
    shapes = ((hidden,), (hidden, nh * d), (hidden, nkv * d),
              (hidden, nkv * d), (nh * d, hidden), (hidden,),
              (hidden, inter), (hidden, inter), (inter, hidden))
    w = [(rng.standard_normal(sh) * 0.1 + (1.0 if len(sh) == 1 else 0.0)
          ).astype(np.float32) for sh in shapes]
    kp, vp = _pool(rng, nkv, num_pages=10, page=page, d=d)
    x = rng.standard_normal((b, hidden)).astype(np.float32)
    bt = np.array([[1, 4, 7], [2, 5, 0], [3, 6, 8]], np.int32)
    sl = np.array([17, 9, 0], np.int32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-6)
    jo, jk, jv = JFF.fused_block_decode(
        _j(x), *(_j(a) for a in w), _j(kp), _j(vp), _j(bt), _j(sl), **kw)
    tk, tv = _t(kp), _t(vp)
    to, tk2, tv2 = TFF.fused_block_decode(
        _t(x), *(_t(a) for a in w), tk, tv, bt, sl, **kw)
    assert tk2 is tk and tv2 is tv
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
