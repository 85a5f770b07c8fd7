"""Ring and Ulysses attention over ``sep`` across gloo ranks against the JAX
package's ``sep_scaled_dot_product_attention`` / ``ulysses_attention``.

The port runs in worlds of 2 and 4 processes on the CPU (spawned once for
the file; rank bodies in ``tests/torch_ctx_ranks.py``), each rank on its
contiguous sequence chunk of the same seeded global q / k / v, then a
backward of ``sum(out * do)``. The JAX package runs the global function
on its host devices in this process (``jax.vjp`` with the same ``do``).
Rank r's out, dq, dk and dv must equal slice r of JAX's within 1e-5
(fp32; the port's ring units run the flash kernels' plain versions on the
CPU, JAX's the dense inner path, or the interpret-mode Pallas flash
kernel on a sep-only mesh in the ``pallas`` cases).

Cases: ring in zigzag order (causal, S divisible by 2P) and contiguous
(causal with an odd chunk), not causal; MHA and GQA; Ulysses with kv
split by head, kv expanded, kv gathered whole, and the one-kv-group slice
under ``attn_fn_gqa``. Also ``zigzag_order``, the one-rank dense path, the
refusals, and the ring's transfers (one batched rotation a step).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_ctx_ranks as ranks
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.distributed.fleet.utils import ring_flash_attention as jring
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet.utils import ring_flash_attention \
    as tring

TOL = 1e-5


def _case(name, p, method="ring", causal=True, b=2, s=16, h=4, hkv=4,
          d=8, mesh="hcg", attn_fn=False):
    return dict(name=name, p=p, method=method, causal=causal, b=b, s=s, h=h,
                hkv=hkv, d=d, mesh=mesh, attn_fn=attn_fn)


CASES = [
    _case("ring_zigzag_mha", 2),
    _case("ring_contiguous_gqa", 2, s=10, hkv=2),
    _case("ring_full_gqa", 2, causal=False, hkv=2),
    _case("ring_pallas_zigzag_gqa", 2, s=32, hkv=2, mesh="sep"),
    _case("ulysses_mha", 2, method="ulysses"),
    _case("ring_zigzag_gqa", 4, s=32, h=8, hkv=2),
    _case("ring_contiguous_mha", 4, s=12),
    _case("ring_full_mha", 4, causal=False),
    _case("ring_pallas_full", 4, causal=False, s=32, mesh="sep"),
    _case("ulysses_split_gqa", 4, method="ulysses", h=8, hkv=4),
    _case("ulysses_gather_gqa", 4, method="ulysses", causal=False, h=8,
          hkv=2),
    _case("ulysses_one_group", 4, method="ulysses", h=8, hkv=2,
          mesh="sep", attn_fn=True),
]


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    b, s, h, hkv, d = (case[k] for k in ("b", "s", "h", "hkv", "d"))
    shapes = dict(q=(b, s, h, d), k=(b, s, hkv, d), v=(b, s, hkv, d),
                  do=(b, s, h, d))
    return {n: (rng.standard_normal(sh) * 0.5).astype(np.float32)
            for n, sh in shapes.items()}


def _jax_gqa_dense(causal, scale):
    def fn(q, k, v):
        rep = q.shape[2] // k.shape[2]
        return jring._dense_sdpa(q, jnp.repeat(k, rep, axis=2),
                                 jnp.repeat(v, rep, axis=2), causal, scale)
    return fn


def _jax(case, x):
    p = case["p"]
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))
    _reset_hcg()
    if case["mesh"] == "sep":
        mesh = Mesh(np.array(jax.devices()[:p]), ("sep",))
    else:
        mesh = create_hybrid_communicate_group(sep_degree=p).get_mesh()
    if case["attn_fn"]:
        scale = 1.0 / np.sqrt(case["d"])
        spec = P(None, "sep", None, None)
        fn = jax.shard_map(
            functools.partial(jring.ulysses_attention, axis_name="sep",
                              causal=case["causal"], sm_scale=scale,
                              attn_fn=_jax_gqa_dense(case["causal"], scale),
                              attn_fn_gqa=True),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)
    else:
        def fn(q, k, v):
            return jring.sep_scaled_dot_product_attention(
                q, k, v, mesh=mesh, method=case["method"],
                causal=case["causal"])

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(do)

    out, dq, dk, dv = run(q, k, v, do)
    _reset_hcg()
    return {n: np.asarray(t) for n, t in
            dict(out=out, dq=dq, dk=dk, dv=dv).items()}


@pytest.fixture(scope="module")
def runs():
    inputs = {c["name"]: _inputs(c, i) for i, c in enumerate(CASES)}
    ctxs = [spawn(ranks.attention_rank, args=(CASES, inputs), nprocs=n,
                  join=False) for n in (2, 4)]
    try:
        want = {c["name"]: _jax(c, inputs[c["name"]]) for c in CASES}
        for ctx in ctxs:
            ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        for ctx in ctxs:
            ctx.terminate()
    got = {}
    for ctx in ctxs:
        for name in ctx.results[0]:
            got[name] = [res[name] for res in ctx.results]
    return want, got


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_rank_slices_match_jax(runs, case):
    want, got = runs
    p = case["p"]
    for name in ("out", "dq", "dk", "dv"):
        chunks = np.split(want[case["name"]][name], p, axis=1)
        for r in range(p):
            err = _err(got[case["name"]][r][name], chunks[r])
            assert err <= TOL * max(1.0, np.abs(chunks[r]).max()), \
                (case["name"], name, r, err)


@pytest.mark.parametrize("name", ["ring_zigzag_gqa", "ring_contiguous_mha",
                                  "ring_full_mha"])
def test_ring_rotates_one_stacked_kv(runs, name):
    """P - 1 batched rotations forward and P - 1 back (k and v as one
    tensor: each a send and a receive); the zigzag case adds its two
    half-chunk exchanges each way."""
    _, got = runs
    case = next(c for c in CASES if c["name"] == name)
    p = case["p"]
    zig = name.startswith("ring_zigzag")
    for res in got[name]:
        counts = res["counts"]
        rotations = 2 * (p - 1)
        # an exchange sends to and receives from at most every other rank
        assert counts.get("send", 0) >= rotations
        assert counts.get("send", 0) == counts.get("recv", 0)
        if not zig:
            assert counts["send"] == rotations, counts


@pytest.mark.parametrize("s,p", [(32, 4), (16, 2), (24, 3), (10, 2)])
def test_zigzag_order_matches_jax(s, p):
    want, got = jring.zigzag_order(s, p), tring.zigzag_order(s, p)
    if want is None:
        assert got is None
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hkv", [4, 2])
def test_one_rank_takes_the_dense_path(hkv):
    """No topology: the whole sequence through dense attention (GQA kv
    expanded), as the reference's mesh without a sep axis."""
    x = _inputs(_case("dense", 1, hkv=hkv), 7)
    got = tring.sep_scaled_dot_product_attention(
        *(torch.from_numpy(x[n]) for n in "qkv"), None, causal=True)
    rep = 4 // hkv
    want = jring._dense_sdpa(
        jnp.asarray(x["q"]), jnp.repeat(jnp.asarray(x["k"]), rep, axis=2),
        jnp.repeat(jnp.asarray(x["v"]), rep, axis=2), True,
        1.0 / np.sqrt(8))
    assert _err(got.numpy(), np.asarray(want)) <= TOL


class _FourRanks:
    nranks, rank, ranks = 4, 0, [0, 1, 2, 3]


def test_refusals():
    q = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="not divisible by sep degree"):
        tring.ulysses_attention(q, q, q, _FourRanks())
    with pytest.raises(ValueError, match="not divisible by kv heads"):
        tring.ring_flash_attention(torch.zeros(1, 4, 6, 8),
                                   torch.zeros(1, 4, 4, 8),
                                   torch.zeros(1, 4, 4, 8), _FourRanks())
    with pytest.raises(ValueError, match="even local chunk"):
        tring.ring_flash_attention(torch.zeros(1, 3, 4, 8),
                                   torch.zeros(1, 3, 4, 8),
                                   torch.zeros(1, 3, 4, 8), _FourRanks(),
                                   zigzag=True)
    with pytest.raises(ValueError, match="only applies to causal"):
        tring.ring_flash_attention(q, q, q, _FourRanks(), causal=False,
                                   zigzag=True)
