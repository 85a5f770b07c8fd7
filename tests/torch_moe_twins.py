"""The tiny MoE-GPT's JAX ``TrainStep(mesh=...)`` run and the port's run
across gloo ranks, shared by ``test_torch_moe_dp.py`` and
``test_torch_expert_parallel.py``: both packages start from the same
seeded numpy weights (N(0, 0.05), LayerNorm scales 1 + N(0, 0.05)) and
take 3 AdamW steps (lr 1e-2, weight decay 0.01) on the same global
batches of 8 x 16 tokens, the JAX package on its host devices in the
test process, the port in a world of ``dp`` ranks."""

import jax.numpy as jnp
import numpy as np

import paddle_tpu as paddle
import torch_ctx_ranks as ranks
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models.moe_gpt import MoEGPTConfig as JMoEGPTConfig
from paddle_tpu.models.moe_gpt import MoEGPTForCausalLM as JMoEGPT
from paddle_tpu_torch.distributed import spawn

LR = 1e-2


def weights(cfg, seed=41):
    with paddle.LazyGuard():
        jm = JMoEGPT(JMoEGPTConfig.tiny(**cfg))
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jm.raw_state()[0].items():
        w = rng.standard_normal(spec.shape).astype(np.float32) * 0.05
        is_scale = "ln_" in name and name.endswith("weight")
        out[name] = w + 1.0 if is_scale else w
    return out


def batches(seed=31, n=3, b=8, s=16, vocab=512):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1].copy(), ids[:, 1:].copy()))
    return out


def case(name, dp, cfg, clip=None, weights_key="w"):
    return dict(name=name, dp=dp, cfg=cfg, clip=clip, lr=LR,
                batches=batches(), weights=weights_key)


def jax_run(c, w):
    """The JAX package's losses and final parameters for case ``c``
    (dp = 1: no mesh)."""
    _reset_hcg()
    with paddle.LazyGuard():
        jm = JMoEGPT(JMoEGPTConfig.tiny(**c["cfg"]))
    jm.load_raw_state({k: jnp.asarray(v) for k, v in w.items()})
    clip = (None if c["clip"] is None
            else paddle.nn.ClipGradByGlobalNorm(c["clip"]))
    opt = paddle.optimizer.AdamW(c["lr"], parameters=jm.parameters(),
                                 weight_decay=0.01, grad_clip=clip)
    mesh = (create_hybrid_communicate_group(dp_degree=c["dp"]).get_mesh()
            if c["dp"] > 1 else None)
    step = JTrainStep(jm, opt, mesh=mesh)
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         paddle.to_tensor(y.astype(np.int32))))
              for x, y in c["batches"]]
    step.sync_to_model()
    _reset_hcg()
    return losses, {k: np.asarray(v, np.float64)
                    for k, v in jm.raw_state()[0].items()}


def run_both(cases, w):
    """{name: (JAX losses and parameters, each port rank's results)}."""
    sizes = sorted({c["dp"] for c in cases})
    ctxs = {n: spawn(ranks.moe_rank, args=(cases, {"w": w}), nprocs=n,
                     join=False) for n in sizes}
    try:
        want = {c["name"]: jax_run(c, w) for c in cases}
        for ctx in ctxs.values():
            ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        for ctx in ctxs.values():
            ctx.terminate()
    return {c["name"]: (want[c["name"]],
                        [res[c["name"]] for res in ctxs[c["dp"]].results])
            for c in cases}


def key_bias(name, hidden):
    """The attention key bias's third of ``qkv_proj.bias`` (its exact
    gradient is 0), else None."""
    if name.endswith("qkv_proj.bias"):
        return slice(hidden, 2 * hidden)
    return None


def param_errors(got, want, init, hidden):
    """Each parameter's L2 distance from JAX's over the L2 of JAX's update
    (the attention key bias left out: its gradient is rounding in both)."""
    out = {}
    for name, g in got.items():
        g = np.asarray(g, np.float64)
        w, s = want[name], np.asarray(init[name], np.float64)
        kb = key_bias(name, hidden)
        if kb is not None:
            keep = np.ones(g.shape, bool)
            keep[kb] = False
            g, w, s = g[keep], w[keep], s[keep]
        out[name] = np.linalg.norm(g - w) / np.linalg.norm(w - s)
    return out
