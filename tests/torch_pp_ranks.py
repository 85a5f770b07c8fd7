"""Rank bodies for the port's pipeline tests (gloo on the CPU).

``paddle_tpu_torch.distributed.spawn`` starts each rank in a fresh
interpreter that imports this module (it imports neither JAX nor the JAX
package). A world runs its cases one after another: each builds its
hybrid topology, the port's pipe model on this rank's stage, loads the
JAX pipe's weights (``convert.pipe_state``), trains 3 AdamW steps and
returns numpy results: the losses, this stage's parameters under their
global names with their specs, the rank's coordinates and the pipe's
tied-copy aliases.
"""

from __future__ import annotations

import torch
from torch import nn

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet import base_topology as topo
from torch_dist_ranks import JOIN_TIMEOUT_S, _np, _start  # noqa: F401

H, VOCAB = 32, 64       # the three-axis model (tests/test_hybrid_3axis.py)


class TPBlock(nn.Module):
    """Megatron-style block: column-parallel up, row-parallel down."""

    def __init__(self, h=H, **kw):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            ColumnParallelLinear, RowParallelLinear)
        from paddle_tpu_torch.nn.layers.common import LayerNorm
        self.up = ColumnParallelLinear(h, 4 * h, gather_output=False, **kw)
        self.down = RowParallelLinear(4 * h, h, input_is_parallel=True, **kw)
        self.ln = LayerNorm(h, device=kw["device"], dtype=kw["dtype"])

    def forward(self, x):
        return x + self.down(nn.functional.gelu(self.up(self.ln(x))))


class Head(nn.Module):
    def __init__(self, h=H, vocab=VOCAB, **kw):
        super().__init__()
        from paddle_tpu_torch.nn.layers.common import LayerNorm, Linear
        self.ln = LayerNorm(h, device=kw["device"], dtype=kw["dtype"])
        self.proj = Linear(h, vocab, **kw)

    def forward(self, x):
        return self.proj(self.ln(x))


def ce_loss(out, y):
    return nn.functional.cross_entropy(out.reshape(-1, VOCAB).float(),
                                       y.reshape(-1).long())


def llama_config(layers=4):
    from paddle_tpu_torch.models import LlamaConfig
    c = LlamaConfig.tiny()
    c.num_hidden_layers = layers
    return c


def gpt_config(layers=4):
    from paddle_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=layers,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=32)


def build_pipe(case, hcg):
    """The case's pipe on this rank's stage (the JAX pipe's structure)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.models import (GPTForCausalLMPipe,
                                         LlamaForCausalLMPipe)
    kw = dict(topology=hcg, num_stages=case["pp"], device="cpu",
              num_virtual_pipeline_stages=case.get("V"))
    if case["model"] == "llama":
        return LlamaForCausalLMPipe(llama_config(case.get("layers", 4)),
                                    tensor_parallel=case.get("mp", 1) > 1,
                                    **kw)
    if case["model"] == "gpt":
        return GPTForCausalLMPipe(gpt_config(case.get("layers", 4)), **kw)
    from paddle_tpu_torch.nn.layers.common import Embedding
    descs = [LayerDesc(Embedding, VOCAB, H)]
    descs += [LayerDesc(TPBlock) for _ in range(4)]
    descs.append(LayerDesc(Head))
    return PipelineLayer(descs, loss_fn=ce_loss, **kw)


def optimizer(case, pipe):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr
    lr = case["lr"]
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(lr, T_max=10), 2,
                             lr / 10, lr)
    return AdamW(sched, parameters=pipe.named_parameters(),
                 weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(case["clip"]))


def _report(hcg, pipe, losses, **extra):
    return dict(
        losses=losses,
        coords={"dp": hcg.get_data_parallel_rank(),
                "pp": hcg.get_stage_id(),
                "mp": hcg.get_model_parallel_rank()},
        state={k: _np(p) for k, p in pipe.named_parameters()},
        specs={k: getattr(p, "dist_attr", None)
               for k, p in pipe.named_parameters()},
        aliases=dict(pipe.shared_aliases), **extra)


def _train(case, weights):
    from paddle_tpu_torch.convert import load_state, pipe_state
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineTrainStep)
    hcg = topo.create_hybrid_communicate_group(
        dp_degree=case.get("dp", 1), pp_degree=case["pp"],
        mp_degree=case.get("mp", 1))
    pipe = build_pipe(case, hcg)
    opt = optimizer(case, pipe)
    step = PipelineTrainStep(
        pipe, opt, hcg.get_mesh(), case["M"], remat=case.get("remat", True),
        virtual_pp_degree=case.get("V") or 1,
        schedule=case.get("schedule", "auto"),
        sharding_level=case.get("level"), sharding_axis=case.get("axis"))
    # the stage's own draws equal a whole build's (before any cut)
    whole = dict(build_pipe(dict(case, pp=1), None).named_parameters())
    src = {k: whole[pipe._copy_sources.get(k, k)]
           for k, _ in pipe.named_parameters()}
    own_draws = all(torch.equal(p, src[k]) for k, p in
                    pipe.named_parameters() if p.shape == src[k].shape)
    load_state(pipe, pipe_state(weights[case["weights"]], pipe))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in case["batches"]]
    out = _report(hcg, pipe, losses, ticks=len(step._ticks),
                  own_draws=own_draws,
                  state_bytes=step.per_device_state_bytes())
    topo._reset_hcg()
    return out


def _fleet(case, weights):
    """fleet.init at pp = 2, distributed_model -> PipelineParallel:
    train_batch, eval_batch, and the state_dict round trip."""
    from paddle_tpu_torch.convert import load_state, pipe_state
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": case["pp"]}
    strategy.pipeline_configs = {"accumulate_steps": case["M"],
                                 "micro_batch_size": 8 // case["M"]}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    pipe = build_pipe(case, hcg)
    load_state(pipe, pipe_state(weights[case["weights"]], pipe))
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(optimizer(case, pipe))
    x0, y0 = (torch.from_numpy(a) for a in case["batches"][0])
    before = float(model.eval_batch([x0, y0]))
    losses = [float(model.train_batch([torch.from_numpy(x),
                                       torch.from_numpy(y)], opt))
              for x, y in case["batches"]]
    after = float(model.eval_batch([x0, y0]))
    logits = model.eval_batch([x0, y0], compute_loss=False)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in pipe.parameters():
            p.zero_()
    model.set_state_dict(sd)
    restored = all(torch.equal(sd[k], v)
                   for k, v in model.state_dict().items())
    errors = {}
    try:
        model.train_batch([x0[:6], y0[:6]], opt)
    except ValueError as e:
        errors["micro_batch_size"] = type(e).__name__
    out = _report(hcg, pipe, losses, eval_before=before, eval_after=after,
                  logits=None if logits is None else _np(logits),
                  restored=restored, errors=errors,
                  wrapper=type(model).__name__, names=sorted(sd))
    topo._reset_hcg()
    return out


def _refusals(case):
    """The reference's validations, by the exception type each raises."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel, PipelineTrainStep)
    hcg = topo.create_hybrid_communicate_group(pp_degree=2)
    mesh = hcg.get_mesh()
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:      # the type is the result
            out[name] = (type(e).__name__, str(e))

    def step(layers=4, V=None, **kw):
        c = dict(case, layers=layers, V=V)
        pipe = build_pipe(c, hcg)
        return PipelineTrainStep(pipe, optimizer(c, pipe), mesh, **kw)

    attempt("microbatches_below_stages", lambda: step(num_microbatches=1))
    attempt("virtual_below_one", lambda: step(num_microbatches=2,
                                              virtual_pp_degree=0))
    attempt("interleaved_not_divisible", lambda: step(
        V=2, num_microbatches=3, virtual_pp_degree=2))
    attempt("too_few_blocks", lambda: step(layers=3, V=2,
                                           num_microbatches=2,
                                           virtual_pp_degree=2))
    attempt("unknown_schedule", lambda: step(num_microbatches=2,
                                             schedule="GPipe"))
    attempt("abstract", lambda: step(num_microbatches=2, abstract=True))
    attempt("param_dtype", lambda: step(num_microbatches=2,
                                        param_dtype=torch.bfloat16))
    attempt("lower", lambda: step(num_microbatches=2).lower())
    attempt("not_a_pipeline", lambda: PipelineParallel(
        nn.Linear(2, 2), hcg))
    attempt("zbh1_vpp", lambda: step(V=2, num_microbatches=2,
                                     virtual_pp_degree=2, schedule="zbh1"))
    attempt("zbh1_uneven", lambda: step(layers=3, num_microbatches=2,
                                        schedule="zbh1"))
    attempt("zbh1_zero3", lambda: step(num_microbatches=2, schedule="zbh1",
                                       sharding_level=3))
    topo._reset_hcg()
    return out


def _p2p(case):
    """The pp_utils surface over ``case["pp"]`` stages: a chain of
    send_forward / recv_forward and send_backward / recv_backward, then
    the paired forms a 1F1B steady state issues (each one batch)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_utils import \
        p2p_communication as p2p
    hcg = topo.create_hybrid_communicate_group(pp_degree=case["pp"])
    s = hcg.get_stage_id()
    dist.reset_collective_counts()
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = {"stage": s}
    x = p2p.recv_forward(hcg=hcg)
    p2p.send_forward(base + s, hcg=hcg)
    g = p2p.recv_backward(hcg=hcg)
    p2p.send_backward(base - s, hcg=hcg)
    x2 = p2p.send_backward_recv_forward(base * 0 + 100 + s, hcg=hcg)
    g2 = p2p.send_forward_recv_backward(base * 0 + 10 + s, hcg=hcg)
    for k, v in (("recv_forward", x), ("recv_backward", g),
                 ("paired_forward", x2), ("paired_backward", g2)):
        out[k] = None if v is None else _np(v)
    out["counts"] = dist.collective_counts()
    topo._reset_hcg()
    return out


def pp_rank(rank, cases, weights):
    """Each case of ``cases`` on this rank: ``kind`` "train" (a
    PipelineTrainStep), "fleet", "refusals" or "p2p"."""
    _start()
    try:
        out = {}
        for c in cases:
            kind = c.get("kind", "train")
            out[c["name"]] = (_train(c, weights) if kind == "train"
                              else _fleet(c, weights) if kind == "fleet"
                              else _p2p(c) if kind == "p2p"
                              else _refusals(c))
        return out
    finally:
        dist.destroy_process_group()
