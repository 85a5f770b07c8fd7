"""The fused decode kernels' attention phase (``fused_block_decode`` and
``fused_multi_block_decode`` on the card: ``csrc/block_decode.cuh`` phase
2, the append of the step's k/v to the pool, then ``csrc/decode_split.cuh``
over ``seq_lens + 1`` with the step's own key read from the append's
scratch row) as far as the CPU can hold it:

  - the part count both wrappers pass, a function of the shapes only
    (``paged_attention.decode_split_plan``, #2's rule over the same
    blocks);
  - a whole layer (and a group of 2 layers, native or int4 weights) with
    the phase emulated in plain PyTorch (append with ``write_paged_kv``,
    then ``torch_numerics.fused_attention_split_emulated`` at the
    wrappers' part count) against the JAX package's Pallas kernels
    (interpret mode off the TPU) and its reference, on native and int8
    pools, in float32 within 2e-5 (JAX's KTOL): GQA with rep 2, 4, 8 and
    16 (two head groups), pages of 8 and 16, an idle row, lengths whose
    + 1 ends a page, starts one, ends a part or starts one;
  - two idle rows, which append to one slot of the null page: each still
    attends to its own token, as JAX's Pallas kernel (which folds it in
    from registers) computes it.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import fused_block_decode as jfb
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import fused_block_decode as tfb
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_numerics import fused_attention_split_emulated

TOL = 2e-5
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,nh,nkv,maxp,page,want", [
    (4, 32, 32, 16, 64, (2, 8)),     # chip_smoke's serve row: 1024 keys
    (4, 32, 32, 64, 64, (4, 16)),    # serve_long's 4096-token table
    (4, 64, 8, 64, 64, (2, 32)),     # Llama-2-70B heads: one 8-head group
    (4, 16, 1, 64, 64, (1, 64)),     # rep 16: two groups, parts of a page
    (32, 32, 32, 64, 64, (4, 16)),   # a full card: 256-key parts
    (3, 4, 2, 16, 8, (8, 2)),        # pages of 8: 64-key parts
])
def test_fused_split_plan_from_the_shapes(b, nh, nkv, maxp, page, want):
    """(part_pages, nsplit) of the fused kernels' attention: #2's rule
    (decode_splits) over b x kv heads x groups of up to 8 query heads,
    parts covering the table; plain ints, the same on every call."""
    got = tpa.decode_split_plan(b, nh, nkv, maxp, page, H100_SMS)
    assert got == want
    assert all(type(x) is int for x in got)
    groups = -(-(nh // nkv) // 8)
    assert got == tpa.decode_splits(b * nkv * groups, maxp, page, H100_SMS)
    part, nsplit = got
    assert part * nsplit >= maxp > part * (nsplit - 1)


def _layers(rng, n, hidden, nh, nkv, inter, page, maxp, seq_lens):
    """n layers' weights, x, n pool pairs (page 0 the null page), block
    tables (an idle row's all zeros) and lengths, numpy float32."""
    d = hidden // nh
    b = len(seq_lens)
    num_pages = 1 + b * maxp

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
    bt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(num_pages - 1) + 1
    used = 0
    for i, length in enumerate(seq_lens):
        pages = -(-(length + 1) // page) if length else 0
        bt[i, :pages] = perm[used:used + pages]
        used += pages
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    return layers, x, kps, vps, bt, np.asarray(seq_lens, np.int32), kw


@pytest.fixture
def split_phase(monkeypatch):
    """The plain versions with their attention phase as the kernels run
    it: the append through write_paged_kv (the rows remembered as the
    step's own), then the emulated split walk over seq_lens + 1 at the
    part count the wrappers pass (an H100's 132 SMs)."""
    own = {}
    write = tfb.write_paged_kv

    def append(k_pages, v_pages, k_new, v_new, block_tables, positions):
        own.update(k=k_new, v=v_new, lens=positions.clone())
        return write(k_pages, v_pages, k_new, v_new, block_tables,
                     positions)

    def attend(q, k_pages, v_pages, block_tables, lens, sm_scale=None):
        b, h, d = q.shape
        hkv, _, page, _ = k_pages.shape
        maxp = block_tables.shape[1]
        assert torch.equal(lens, own["lens"] + 1)
        plan = tpa.decode_split_plan(b, h, hkv, maxp, page, H100_SMS)
        return fused_attention_split_emulated(
            q, k_pages, v_pages, block_tables, own["lens"], own["k"],
            own["v"], sm_scale or 1.0 / math.sqrt(d), *plan).to(q.dtype)

    monkeypatch.setattr(tfb, "write_paged_kv", append)
    monkeypatch.setattr(tfb, "paged_attention_ref", attend)


def _jw(w):
    return jfb.BlockDecodeWeights(**{k: jnp.asarray(v) for k, v in w.items()})


def _tw(w):
    return tfb.BlockDecodeWeights(**{k: _t(v) for k, v in w.items()})


def _pools(kps, vps, pool):
    """The JAX and the port's pools, native or quantized per row."""
    if pool == "int8":
        return ([jpa.QuantizedPages(*jpa.quantize_kv_rows(jnp.asarray(p)))
                 for p in kps],
                [jpa.QuantizedPages(*jpa.quantize_kv_rows(jnp.asarray(p)))
                 for p in vps],
                [tpa.QuantizedPages(*tpa.quantize_kv_rows(_t(p)))
                 for p in kps],
                [tpa.QuantizedPages(*tpa.quantize_kv_rows(_t(p)))
                 for p in vps])
    return ([jnp.asarray(p) for p in kps], [jnp.asarray(p) for p in vps],
            [_t(p) for p in kps], [_t(p) for p in vps])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=TOL)


def _pools_agree(got, want, first=True):
    """A port pool against JAX's: native within TOL; a first layer's int8
    rows as the JAX package's up to the last bit of the f32 k/v (payload
    within 1, scale within 1e-6 relative); a later layer's, whose input
    already differs by the earlier layers' rounding, within one
    quantization step of the row and TOL in value."""
    if not isinstance(got, tpa.QuantizedPages):
        _close(got.numpy(), want)
        return
    gq, gs = got.q.numpy().astype(np.float64), got.scale.numpy()
    wq, ws = np.asarray(want.q).astype(np.float64), np.asarray(want.scale)
    if first:
        assert np.abs(gq - wq).max() <= 1
        rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30)
        assert float(rel.max()) <= 1e-6
    else:
        diff = np.abs(gq * gs - wq * ws) - np.maximum(gs, ws)
        assert float(diff.max()) <= TOL


# (nh, nkv, hidden, page, maxp, seq_lens): the part is 64 keys (8 or 4
# pages) at these batch sizes
BLOCK_CASES = [
    (4, 2, 64, 8, 16, (0, 37, 100)),          # rep 2, idle row, 2 parts
    (8, 2, 128, 16, 8, (63, 64, 15, 16)),     # + 1 ends/starts a part, page
    (16, 2, 256, 8, 16, (7, 0, 64)),          # rep 8 (70B's 64 / 8)
    (16, 1, 128, 16, 8, (31, 80)),            # rep 16: two head groups
]


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("nh,nkv,hidden,page,maxp,seq_lens", BLOCK_CASES)
def test_fused_block_phase_matches_jax(split_phase, pool, nh, nkv, hidden,
                                       page, maxp, seq_lens):
    """One layer with the split phase emulated, against JAX's Pallas
    fused_block_decode (interpret mode) and, on native pools, its
    reference: the output and the pools within 2e-5 (int8 rows as JAX's
    up to the f32 k/v's last bit)."""
    layers, x, kps, vps, bt, sl, kw = _layers(
        np.random.default_rng(nh + hidden + page + len(seq_lens)), 1,
        hidden, nh, nkv, 2 * hidden, page, maxp, seq_lens)
    jk, jv, tk, tv = _pools(kps, vps, pool)
    want, wk, wv = jfb.fused_block_decode_pallas(
        jnp.asarray(x), _jw(layers[0]), jk[0], jv[0], jnp.asarray(bt),
        jnp.asarray(sl), interpret=True, **kw)
    got, gk, gv = tfb.fused_block_decode(_t(x), _tw(layers[0]), tk[0], tv[0],
                                         _t(bt), _t(sl), **kw)
    _close(got.numpy(), want)
    _pools_agree(gk, wk)
    _pools_agree(gv, wv)
    if pool == "native":
        ref, rk, rv = jfb.fused_block_decode_ref(
            jnp.asarray(x), _jw(layers[0]), jnp.asarray(kps[0]),
            jnp.asarray(vps[0]), jnp.asarray(bt), jnp.asarray(sl), **kw)
        _close(got.numpy(), ref)
        _pools_agree(gk, rk)
        _pools_agree(gv, rv)


@pytest.mark.parametrize("pool,weights", [("native", "native"),
                                          ("int8", "native"),
                                          ("native", "int4"),
                                          ("int8", "int4")])
def test_fused_multi_block_phase_matches_jax(split_phase, pool, weights):
    """Two stacked layers with the split phase emulated in each, against
    JAX's Pallas fused_multi_block_decode (interpret mode): the output
    and every layer's pools within 2e-5."""
    layers, x, kps, vps, bt, sl, kw = _layers(
        np.random.default_rng(31), 2, 128, 8, 2, 256, 16, 8, (63, 0, 64))
    jk, jv, tk, tv = _pools(kps, vps, pool)
    jw = jfb.stack_block_weights([_jw(w) for w in layers],
                                 weight_dtype=weights)
    tw = tfb.stack_block_weights([_tw(w) for w in layers],
                                 weight_dtype=weights)
    want, wk, wv = jfb.fused_multi_block_decode_pallas(
        jnp.asarray(x), jw, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
        interpret=True, **kw)
    got, gk, gv = tfb.fused_multi_block_decode(_t(x), tw, tk, tv, _t(bt),
                                               _t(sl), **kw)
    _close(got.numpy(), want)
    for i in range(2):
        _pools_agree(gk[i], wk[i], first=i == 0)
        _pools_agree(gv[i], wv[i], first=i == 0)


@pytest.mark.parametrize("pool", ["native", "int8"])
def test_two_idle_rows_attend_to_their_own_token(split_phase, pool):
    """Two idle rows append to slot 0 of the null page, one over the
    other; with the own rows read from the append's scratch each still
    attends to its own token: the output is JAX's Pallas kernel's, which
    folds each row's token in from registers."""
    layers, x, kps, vps, bt, sl, kw = _layers(
        np.random.default_rng(77), 1, 64, 4, 2, 128, 8, 16, (0, 20, 0))
    jk, jv, tk, tv = _pools(kps, vps, pool)
    want, _, _ = jfb.fused_block_decode_pallas(
        jnp.asarray(x), _jw(layers[0]), jk[0], jv[0], jnp.asarray(bt),
        jnp.asarray(sl), interpret=True, **kw)
    got, _, _ = tfb.fused_block_decode(_t(x), _tw(layers[0]), tk[0], tv[0],
                                       _t(bt), _t(sl), **kw)
    _close(got.numpy(), want)


def test_serving_profile_files_the_split_kernels_as_attention(monkeypatch):
    """tools/torch_serving_profile.py sums a decode step's kernels by
    kind: the split-KV routine, its merge and the fused decode's append
    count as attention (the phase they replace was named for it), the
    GEMVs as GEMVs, the epilogues as the rest."""
    import importlib.util
    import pathlib
    tools = pathlib.Path(__file__).resolve().parents[1] / "tools"
    monkeypatch.syspath_prepend(str(tools))   # the tool's torch_trace
    path = tools / "torch_serving_profile.py"
    spec = importlib.util.spec_from_file_location("torch_serving_profile",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    group = tool.kernel_group
    for name in ("void ptt::decode_split_kernel<float, __nv_bfloat16, 128, "
                 "1>(float const*, ...)",
                 "void ptt::decode_split_merge_kernel<float>(float const*, "
                 "...)",
                 "void ptt::append_kv_kernel<__nv_bfloat16, signed char>("
                 "float const*, ...)",
                 "void ptt::paged_chunk_kernel<__nv_bfloat16, "
                 "__nv_bfloat16, 128>(...)"):
        assert group(name) == "attention", name
    assert group("void ptt::gemv_partial_kernel<__nv_bfloat16, 4>(...)") \
        == "gemv"
    assert group("void ptt::gemv_int4_partial_kernel<4>(...)") == "gemv"
    for name in ("void ptt::rms_kernel<float, __nv_bfloat16>(...)",
                 "void ptt::qkv_epilogue_kernel(...)"):
        assert group(name) == "other", name
