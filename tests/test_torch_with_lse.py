"""The port's ``flash_attention_with_lse`` and SDPA's dense path against the
JAX package's, on the CPU.

``flash_attention_with_lse`` (the plain versions behind the kernel
wrappers) against JAX's, which runs its Pallas kernels in interpret mode,
under both stats layouts (``torch_numerics.pinned``, restored after):
out and lse within 2e-5, and dq/dk/dv under a random ``(dO, dlse)``
cotangent pair (``jax.vjp``) within 5e-5; MHA and GQA, causal and full.
Both sides sum in f32 in another order, hence the tolerances. The lse
cotangent's fold is checked where a row sees no key (the kernels' segment
variant, as the with_lse backward calls them): zero gradients, no NaN. Two
calls over the halves of the keys merge in log space to the whole call
(1e-5).

``scaled_dot_product_attention`` with a bool and with an additive mask
against JAX's dense path (1e-5, fp32), GQA included; its dropout against
its own keep-mask, drawn again from a generator of the same seed (exact);
the unmasked call still launches the flash kernels' route (its plain
versions here) and the masked one never does.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F
from torch_numerics import assert_close, pinned

B, H, D, S = 2, 4, 32, 128
OUT_TOL, GRAD_TOL = 2e-5, 5e-5
MERGE_TOL = 1e-5
SDPA_TOL = 1e-5


def _inputs(seed, s, hkv):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B * H, s, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B * H, s, D)).astype(np.float32)
    dlse = rng.standard_normal((B * H, s)).astype(np.float32)
    return q, k, v, do, dlse


@pytest.fixture(params=[True, False], ids=["compact", "replicated"])
def stats_layout(request):
    with pinned(flash_compact_stats=request.param):
        yield request.param


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_with_lse_matches_jax_pallas(stats_layout, hkv, causal):
    q, k, v, do, dlse = _inputs(S + hkv + causal, S, hkv)
    (want, want_lse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_with_lse(
            a, b, c, causal=causal, n_heads=H, n_kv_heads=hkv),
        *(jnp.asarray(x) for x in (q, k, v)))
    want_g = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launches()
    out, lse = fa.flash_attention_with_lse(*leaves, causal=causal,
                                           n_heads=H, n_kv_heads=hkv)
    got_g = torch.autograd.grad((out, lse), leaves,
                                (torch.from_numpy(do),
                                 torch.from_numpy(dlse)))
    assert set(kernels.launch_counts().values()) == {0}
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S)
    assert_close(out.detach().numpy(), np.asarray(want), OUT_TOL)
    assert_close(lse.detach().numpy(), np.asarray(want_lse), OUT_TOL, "lse")
    for name, g, w in zip("qkv", got_g, want_g):
        assert_close(g.numpy(), np.asarray(w), GRAD_TOL, f"d{name}")


def test_with_lse_without_dlse_is_flash_attention():
    """Only ``out`` used: the lse cotangent is zero and the gradients are
    ``flash_attention``'s exactly (the same plain versions, same
    delta)."""
    q, k, v, do, _ = _inputs(5, 64, 2)
    grads = []
    for fn in (lambda *t: fa.flash_attention_with_lse(
            *t, n_heads=H, n_kv_heads=2)[0],
               lambda *t: fa.flash_attention(*t, n_heads=H, n_kv_heads=2)):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves,
                                         torch.from_numpy(do)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_with_lse_shape_checks_match_jax(hkv):
    t = torch.zeros(B * H, 8, D)
    kv = torch.zeros(B * hkv, 8, D)
    with pytest.raises(ValueError):
        fa.flash_attention_with_lse(t, kv, kv, n_heads=3, n_kv_heads=2)
    with pytest.raises(ValueError):
        fa.flash_attention_with_lse(t, kv[:1], kv[:1], n_heads=H,
                                    n_kv_heads=hkv)


def test_dlse_fold_gives_zero_grads_on_fully_masked_rows():
    """A row whose segment id no key carries has lse 0 and p = 0: with
    ``delta - dlse`` folded in, its dq is zero and nothing is NaN."""
    q, k, v, do, dlse = (torch.from_numpy(x) for x in _inputs(9, 64, 4))
    seg_q = torch.ones(B * H, 64, dtype=torch.int32)
    seg_q[:, 40:] = 7                                # no key carries 7
    seg_kv = torch.ones(B * H, 64, dtype=torch.int32)
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, H, H, seg_q,
                                      seg_kv)
    assert torch.all(lse[:, 40:] == 0) and torch.all(out[:, 40:] == 0)
    delta = (out * do).sum(-1) - dlse
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, None, H, H,
                                   seg_q, seg_kv)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, None,
                                        H, H, seg_q, seg_kv)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert torch.all(dq[:, 40:] == 0)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_log_space_merge_of_key_halves(hkv):
    """Two non-causal calls over the halves of the keys merge to the whole
    call: lse = logaddexp(lse1, lse2), out = sum of exp(lse_i - lse) o_i
    (what ring attention relies on)."""
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(13, 96, hkv))
    kw = dict(causal=False, n_heads=H, n_kv_heads=hkv)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    o1, l1 = fa.flash_attention_with_lse(q, k[:, :48], v[:, :48], **kw)
    o2, l2 = fa.flash_attention_with_lse(q, k[:, 48:], v[:, 48:], **kw)
    merged_lse = torch.logaddexp(l1, l2)
    merged = (torch.exp(l1 - merged_lse)[..., None] * o1
              + torch.exp(l2 - merged_lse)[..., None] * o2)
    assert float((merged_lse - lse).abs().max()) <= MERGE_TOL
    assert float((merged - o).abs().max()) <= MERGE_TOL


# ------------------------------------------------------------ SDPA, dense
def _bshd(seed, s, hkv):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, s, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    return q, k, v


def _mask(kind, s):
    rng = np.random.default_rng(s)
    keep = np.tril(np.ones((s, s), bool))[None, None] & (
        rng.random((B, 1, 1, s)) < 0.8)
    keep[..., 0] = True                       # every row sees a key
    if kind == "bool":
        return keep
    return np.where(keep, rng.standard_normal((B, 1, s, s)) * 0.1,
                    -1e30).astype(np.float32)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_sdpa_mask_matches_jax_dense_path(kind, hkv):
    s = 48
    q, k, v = _bshd(21 + hkv, s, hkv)
    mask = _mask(kind, s)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=paddle.to_tensor(mask)).numpy()
    kernels.reset_launches()
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask))
    assert got.shape == (B, s, H, D)
    assert float(np.abs(got.numpy() - want).max()) <= SDPA_TOL
    assert kernels.launch_counts()["flash_attention_fwd"] == 0


def test_sdpa_dropout_replays_its_keep_mask():
    s, p = 32, 0.25
    q, k, v = (torch.from_numpy(x) for x in _bshd(3, s, H))
    got = F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, is_causal=True,
        generator=torch.Generator().manual_seed(11))
    keep = torch.rand((B, H, s, s), generator=torch.Generator().manual_seed(
        11)) < 1 - p
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sc = qt @ kt.transpose(-1, -2) / np.sqrt(D)
    sc = sc.masked_fill(~torch.tril(torch.ones(s, s, dtype=torch.bool)),
                        -1e30)
    probs = torch.where(keep, torch.softmax(sc, -1) / (1 - p), 0.0)
    want = (probs @ vt).transpose(1, 2)
    assert torch.equal(got, want)
    # outside training, and without a generator in training
    plain = F.scaled_dot_product_attention(q, k, v, dropout_p=p,
                                           is_causal=True, training=False)
    assert torch.allclose(plain, fa.flash_attention_bshd(q, k, v,
                                                         causal=True))
    with pytest.raises(ValueError, match="generator"):
        F.scaled_dot_product_attention(q, k, v, dropout_p=p)


def test_dropout_matches_its_keep_mask_and_paddle_modes():
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    keep = torch.rand((4, 1), generator=torch.Generator().manual_seed(2)) \
        < 0.5
    got = F.dropout(x, 0.5, axis=0, generator=torch.Generator().manual_seed(
        2))
    assert torch.equal(got, torch.where(keep, x / 0.5, 0.0))
    assert F.dropout(x, 0.5, training=False) is x
    assert torch.equal(F.dropout(x, 0.5, training=False,
                                 mode="downscale_in_infer"), x * 0.5)


def test_sdpa_unmasked_call_keeps_the_flash_route():
    q, k, v = (torch.from_numpy(x) for x in _bshd(4, 32, 2))
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    want = fa.flash_attention_bshd(q, k, v, causal=True)
    assert torch.equal(got, want)
