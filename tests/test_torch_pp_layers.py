"""The pipeline's layers and schedules in one process, against the JAX
package: ``SegmentLayers``, ``stage_block_counts``, ``stack_region`` and
the interleaved placement equal the reference's; the eager forward of the
Llama and (tied) GPT pipes matches the JAX pipes within 1e-5;
``zbh1_schedule`` / ``_stash_tables`` equal the reference's tables; the
port's 1F1B order holds at most ``S - s`` microbatches on stage s, and
every tick table runs each unit once, after what it needs;
``convert.pipe_name_map`` maps a whole model onto its pipe.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import \
    SegmentLayers as JSegmentLayers
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_zbh1 as jz
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLMPipe as JLlamaPipe
from paddle_tpu_torch.convert import load_state, pipe_name_map, pipe_state
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    PipelineLayer, SegmentLayers)
from paddle_tpu_torch.distributed.fleet.meta_parallel import pipeline_zbh1
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel \
    import tick_table, unit_orders
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTForCausalLMPipe, LlamaConfig,
                                     LlamaForCausalLM, LlamaForCausalLMPipe)

TOL = 1e-5


def _gpt_cfgs(layers, tied=True):
    kw = dict(vocab_size=64, hidden_size=32, num_hidden_layers=layers,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=32, hidden_dropout_prob=0.0,
              tie_word_embeddings=tied)
    return (JGPTConfig(attention_probs_dropout_prob=0.0, **kw),
            GPTConfig(attention_probs_dropout_prob=0.0, **kw))


def _llama_cfgs(layers):
    j, t = JLlamaConfig.tiny(), LlamaConfig.tiny()
    j.num_hidden_layers = t.num_hidden_layers = layers
    return j, t


def _pipes(kind, layers, S, V=None, seg=None):
    """(JAX pipe, port pipe) of one structure, built in one process."""
    kw = {} if seg is None else {"seg_method": seg}
    if kind == "gpt":
        j, t = _gpt_cfgs(layers)
        return (JGPTPipe(j, num_stages=S, **kw),
                GPTForCausalLMPipe(t, num_stages=S, device="cpu",
                                   num_virtual_pipeline_stages=V, **kw))
    j, t = _llama_cfgs(layers)
    jp = JLlamaPipe(j, num_stages=S, **kw)
    jp.num_virtual_pipeline_stages = V or 1
    return jp, LlamaForCausalLMPipe(t, num_stages=S, device="cpu",
                                    num_virtual_pipeline_stages=V, **kw)


@pytest.mark.parametrize("n,parts", [(10, 4), (7, 3), (9, 2), (4, 4)])
def test_segment_layers_uniform(n, parts):
    assert (SegmentLayers(list(range(n)), parts).do_segment()
            == JSegmentLayers(list(range(n)), parts).do_segment())


@pytest.mark.parametrize("kind,layers,S,seg", [
    ("gpt", 6, 4, None), ("gpt", 8, 4, None), ("gpt", 5, 2, None),
    ("llama", 6, 4, None), ("llama", 6, 4, "uniform"),
    ("llama", 7, 2, "uniform")])
def test_counts_and_region_equal_reference(kind, layers, S, seg):
    j, t = _pipes(kind, layers, S, seg=seg)
    assert t.stack_region() == j.stack_region()
    assert t.stage_block_counts() == j.stage_block_counts()
    assert t.segment_parts == j.segment_parts


def test_uneven_counts_are_the_reference_example():
    assert _pipes("gpt", 6, 4)[1].stage_block_counts() == [2, 2, 1, 1]
    assert _pipes("gpt", 8, 4)[1].stage_block_counts() == [2, 2, 2, 2]


@pytest.mark.parametrize("kind,layers,S", [("gpt", 8, 4), ("gpt", 8, 2),
                                           ("llama", 5, 2),
                                           ("llama", 9, 2)])
def test_interleaved_placement_equals_reference(kind, layers, S):
    """At V = 2 stage s holds chunks {s, s + S}; leftover blocks join the
    suffix on the last stage."""
    j, t = _pipes(kind, layers, S, V=2)
    j.num_virtual_pipeline_stages = 2
    for s in range(S):
        assert t.get_stage_layer_indices(s) == j.get_stage_layer_indices(s)


def _seeded(kind, layers, tied=True):
    paddle.seed(3)
    if kind == "gpt":
        j, t = _gpt_cfgs(layers, tied)
        return JGPTPipe(j, num_stages=2), GPTForCausalLMPipe(
            t, num_stages=2, device="cpu")
    j, t = _llama_cfgs(layers)
    return JLlamaPipe(j, num_stages=2), LlamaForCausalLMPipe(
        t, num_stages=2, device="cpu")


@pytest.mark.parametrize("kind,tied", [("llama", False), ("gpt", True),
                                       ("gpt", False)])
def test_eager_forward_matches_jax(kind, tied):
    """Without a live pipeline the port's pipe builds every entry and its
    forward runs the whole stack: the JAX pipe's weights give its
    logits within 1e-5."""
    jpipe, tpipe = _seeded(kind, 3, tied)
    weights = {k: np.asarray(v) for k, v in jpipe.raw_state()[0].items()}
    load_state(tpipe, pipe_state(weights, tpipe))
    vocab = 256 if kind == "llama" else 64
    ids = np.random.default_rng(0).integers(0, vocab, (2, 12))
    want = np.asarray(jpipe(paddle.to_tensor(ids.astype(np.int32)))._value)
    with torch.no_grad():
        got = tpipe(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert sorted(weights) == sorted(k for k, _ in tpipe.named_parameters())


GRID = [(2, 2), (2, 4), (3, 5), (4, 4), (4, 8), (8, 8), (2, 7), (5, 3)]


@pytest.mark.parametrize("S,M", GRID)
def test_zbh1_tables_equal_reference(S, M):
    for got, want in zip(pipeline_zbh1.zbh1_schedule(S, M),
                         jz.zbh1_schedule(S, M)):
        np.testing.assert_array_equal(got, want)
    Ft, Bt, _ = jz.zbh1_schedule(S, M)
    for got, want in zip(pipeline_zbh1._stash_tables(Ft, Bt, S),
                         jz._stash_tables(Ft, Bt, S)):
        np.testing.assert_array_equal(got, want)


def in_flight_peak(order):
    """The most microbatches whose activations a stage holds at once
    (forwards begun, backwards not yet done) under ``order``."""
    peak = held = 0
    for kind, _, _ in order:
        held += 1 if kind == "F" else -1
        peak = max(peak, held)
    return peak


@pytest.mark.parametrize("S,M", [(2, 2), (2, 8), (4, 4), (4, 9), (8, 16),
                                 (3, 3)])
def test_1f1b_holds_at_most_s_minus_stage(S, M):
    """1F1B: stage s holds at most S - s microbatches' activations; FThenB
    holds all M."""
    for s, order in enumerate(unit_orders(S, M, 1, "1F1B")):
        assert in_flight_peak(order) == min(S - s, M)
    for order in unit_orders(S, M, 1, "FThenB"):
        assert in_flight_peak(order) == M


@pytest.mark.parametrize("S,M,V,schedule", [
    (2, 4, 1, "1F1B"), (4, 8, 1, "1F1B"), (4, 4, 1, "FThenB"),
    (2, 2, 2, "1F1B"), (2, 4, 2, "1F1B"), (4, 8, 2, "1F1B"),
    (4, 4, 3, "1F1B"), (2, 4, 2, "FThenB")])
def test_tick_tables_run_each_unit_once_in_order(S, M, V, schedule):
    C = S * V
    ticks = tick_table(unit_orders(S, M, V, schedule), S, V)
    at = {}
    for t, row in enumerate(ticks):
        for s, u in enumerate(row):
            if u is not None:
                assert u not in at and u[1] % S == s
                at[u] = t
    assert len(at) == 2 * C * M
    for c in range(C):
        for m in range(M):
            if c > 0:
                assert at[("F", c, m)] > at[("F", c - 1, m)]
            assert at[("B", c, m)] > at[("F", c, m)]
            if c < C - 1:
                assert at[("B", c, m)] > at[("B", c + 1, m)]


def test_zbh1_ticks_are_the_tables():
    ticks = pipeline_zbh1.zbh1_ticks(4, 8)
    Ft, Bt, Wt = jz.zbh1_schedule(4, 8)
    assert len(ticks) == Ft.shape[0]
    for t, row in enumerate(ticks):
        for s, u in enumerate(row):
            want = [(k, s, int(tab[t][s])) for k, tab in
                    (("F", Ft), ("B", Bt), ("W", Wt)) if tab[t][s] >= 0]
            assert [u] == want if want else u is None


@pytest.mark.parametrize("model", ["llama", "gpt_tied", "gpt_untied"])
def test_name_map_covers_the_pipe(model):
    """Every parameter of the whole model maps onto one of its pipe's, and
    the pipe's (a tied head's only in its embedding) are all covered."""
    if model == "llama":
        cfg = LlamaConfig.tiny()
        whole, pipe = (LlamaForCausalLM(cfg, device="cpu"),
                       LlamaForCausalLMPipe(cfg, num_stages=2, device="cpu"))
    else:
        cfg = _gpt_cfgs(2, model == "gpt_tied")[1]
        whole, pipe = (GPTForCausalLM(cfg, device="cpu"),
                       GPTForCausalLMPipe(cfg, num_stages=2, device="cpu"))
    names = pipe_name_map(whole)
    assert sorted(names.values()) == sorted(k for k, _ in
                                            pipe.named_parameters())
    shapes = dict(pipe.named_parameters())
    for k, p in whole.named_parameters():
        assert tuple(p.shape) == tuple(shapes[names[k]].shape), k


def test_whole_model_weights_give_its_logits():
    """LlamaForCausalLM's weights through the name map give its pipe the
    same logits."""
    cfg = LlamaConfig.tiny()
    whole = LlamaForCausalLM(cfg, device="cpu")
    pipe = LlamaForCausalLMPipe(cfg, num_stages=2, device="cpu")
    names = pipe_name_map(whole)
    load_state(pipe, {names[k]: v.detach().numpy()
                      for k, v in whole.named_parameters()})
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8)))
    with torch.no_grad():
        torch.testing.assert_close(pipe(ids), whole(ids), rtol=0, atol=0)


def test_layer_desc_refuses_a_non_module():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import LayerDesc
    with pytest.raises(TypeError):
        LayerDesc(lambda x: x)
    with pytest.raises(ValueError):
        PipelineLayer([torch.nn.Identity()], num_stages=2)
