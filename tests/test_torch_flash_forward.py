"""The bf16 flash forward on the tensor cores (kernel #7, ``fb_fwd_kernel``
in ``csrc/flash_attention.cu``) as far as the CPU can hold it: its
arithmetic, emulated in plain PyTorch (``torch_numerics.flash_fwd_emulated``:
S from exact bf16 products summed in f32, the softmax scale in f32 in the
exponent, l over the unrounded p, the P·V operand P as bf16 hi + lo), on
bf16-valued inputs from one numpy generator, against the JAX package's
Pallas forward (``_fwd`` with compact stats, interpret mode off the TPU)
and a float64 attention: the output rounded to bf16 within
``chip_smoke.py``'s ``OUT_TOL[bf16]`` (1e-3 + one bf16 ulp, elementwise,
as both sides round an f32 value), the lse within ``LSE_TOL[bf16]``
(1e-3). Cases: causal and full, GQA, Sq != Skv both ways, segment ids
with a padding id no key carries (zeros, lse 0), a peaked q; and at the
UNet's D = 160 (the DP = 160 instantiation, 64-key tiles), not causal,
self-attention against the Pallas forward and cross-attention against 77
keys (a length the JAX kernel refuses) against the float64 attention.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_numerics import (attention_f64, flash_fwd_emulated, out_excess,
                            pinned)

B, D = 2, 32
OUT_ATOL, OUT_RTOL = 1e-3, 2.0 ** -7     # chip_smoke's OUT_TOL[bf16]
LSE_TOL = 1e-3                          # chip_smoke's LSE_TOL[bf16]
PAD = 13                                # padding rows at a row's end


def _bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float()


def _inputs(seed, sq, skv, h, hkv, qscale, seg):
    rng = np.random.default_rng(seed)

    def rnd(rows, s, scale=1.0):
        return _bf16((rng.standard_normal((rows, s, D)) * scale)
                     .astype(np.float32))

    q = rnd(B * h, sq, qscale)
    k, v = rnd(B * hkv, skv), rnd(B * hkv, skv)
    if seg is None:
        return q, k, v, None, None
    # documents of 40 and 100 keys, then one filling the row; the last
    # PAD query rows carry an id no key carries
    def ids(s):
        row = np.full(s, 3, np.int32)
        row[:40], row[40:140] = 1, 2
        return row

    seg_q = np.tile(ids(sq), (B * h, 1))
    seg_q[:, sq - PAD:] = 99
    seg_kv = np.tile(ids(skv), (B * hkv, 1))
    return q, k, v, torch.from_numpy(seg_q), torch.from_numpy(seg_kv)


@pytest.mark.parametrize("sq,skv,h,hkv,causal,qscale,seg", [
    (256, 256, 4, 4, True, 1.0, None),
    (256, 256, 4, 1, False, 1.0, None),     # GQA rep 4, full
    (128, 256, 4, 2, True, 8.0, None),      # Sq < Skv, peaked
    (256, 128, 4, 2, False, 1.0, None),     # Sq > Skv
    (256, 128, 2, 2, True, 1.0, None),      # Sq > Skv, causal
    (256, 256, 4, 2, True, 8.0, "pad"),     # segments, padding, peaked
    (256, 256, 2, 2, False, 1.0, "pad"),    # segments, full
], ids=["causal", "gqa-full", "sq<skv-peaked", "sq>skv", "sq>skv-causal",
        "seg-pad-peaked", "seg-full"])
def test_forward_emulation_matches_jax_pallas(sq, skv, h, hkv, causal,
                                              qscale, seg):
    q, k, v, seg_q, seg_kv = _inputs(sq + skv + h + int(qscale), sq, skv, h,
                                     hkv, qscale, seg)
    scale = 1.0 / np.sqrt(D)
    with pinned():
        want, want_lse = jfa._fwd(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)),
            None if seg is None else jnp.asarray(seg_q.numpy()),
            None if seg is None else jnp.asarray(seg_kv.numpy()),
            causal, scale, 128, 128, h, hkv, True)
        got, lse = flash_fwd_emulated(q, k, v, causal, h, hkv, scale, "hilo",
                                      seg_q, seg_kv)
    got = got.to(torch.bfloat16).float()
    assert got.shape == q.shape and lse.shape == q.shape[:2]
    assert out_excess(got, _bf16(want), OUT_RTOL) <= OUT_ATOL
    assert float((lse - torch.from_numpy(np.array(want_lse))).abs().max()
                 ) <= LSE_TOL
    ref = attention_f64(q.numpy(), k.numpy(), v.numpy(), causal, h, hkv,
                        None if seg is None else seg_q.numpy(),
                        None if seg is None else seg_kv.numpy())
    assert out_excess(got, _bf16(ref.astype(np.float32)), OUT_RTOL) \
        <= OUT_ATOL
    if seg is not None:
        assert not got[:, sq - PAD:].any()
        assert not lse[:, sq - PAD:].any()


@pytest.mark.parametrize("seg", [None, "pad"])
@pytest.mark.parametrize("hkv", [4, 1], ids=["mha", "gqa"])
def test_forward_emulation_in_f32_is_the_plain_forward(hkv, seg):
    """With P unrounded the emulation is the plain forward (the kernels'
    arithmetic modelled faithfully: scale in the exponent, guards), and
    hi + lo keeps P to about 16 bits: within 2e-5 of it."""
    q, k, v, seg_q, seg_kv = _inputs(5 + hkv, 200, 200, 4, hkv, 1.0, seg)
    kw = dict(causal=True, n_heads=4, n_kv_heads=hkv, seg_q=seg_q,
              seg_kv=seg_kv)
    want, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    scale = 1.0 / np.sqrt(D)
    for scheme, tol in (("f32", 1e-5), ("hilo", 2e-5)):
        got, lse = flash_fwd_emulated(q, k, v, True, 4, hkv, scale, scheme,
                                      seg_q, seg_kv)
        assert float((got - want).abs().max()) <= tol, scheme
        assert float((lse - want_lse).abs().max()) <= 1e-5, scheme


@pytest.mark.parametrize("sq,skv,qscale", [
    (256, 256, 1.0), (256, 256, 8.0), (256, 77, 1.0), (64, 77, 8.0),
], ids=["self", "self-peaked", "cross-77", "cross-77-peaked"])
def test_forward_emulation_at_head_dim_160(sq, skv, qscale):
    d, h = 160, 2
    rng = np.random.default_rng(sq + skv + int(qscale))

    def rnd(rows, s, scale=1.0):
        return _bf16((rng.standard_normal((rows, s, d)) * scale)
                     .astype(np.float32))

    q, k, v = rnd(B * h, sq, qscale), rnd(B * h, skv), rnd(B * h, skv)
    scale = 1.0 / np.sqrt(d)
    got, lse = flash_fwd_emulated(q, k, v, False, h, h, scale, "hilo")
    got = got.to(torch.bfloat16).float()
    ref = attention_f64(q.numpy(), k.numpy(), v.numpy(), False, h, h)
    assert out_excess(got, _bf16(ref.astype(np.float32)), OUT_RTOL) \
        <= OUT_ATOL
    if skv % 128 == 0:
        with pinned():
            want, want_lse = jfa._fwd(
                *(jnp.asarray(x.numpy()) for x in (q, k, v)), None, None,
                False, scale, 128, 128, h, h, True)
        assert out_excess(got, _bf16(want), OUT_RTOL) <= OUT_ATOL
        assert float((lse - torch.from_numpy(np.array(want_lse))).abs()
                     .max()) <= LSE_TOL
