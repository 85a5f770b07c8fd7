"""Weight-only quantization (``nn/quant.py``; ``incubate.nn.functional``'s
``weight_quantize`` / ``weight_only_linear``) against the JAX package on
the CPU.

Held: the int8 payloads bit for bit (int4 packed two a byte, the even row
in the low nibble) and the f32 scales within one f32 ulp, per channel and
grouped; ``weight_dequantize``, ``weight_only_linear`` (with a bias) and
``llm_int8_linear`` within 1e-5; ``QuantizedLinear.from_linear`` and
``quantize_linears`` (``skip``, a shared ``Linear``, a shared weight
parameter, odd ``in_features`` under int4); a quantized tiny Llama carried
from JAX's ``raw_state()`` (parameters and buffers) to the same logits; and
the same quantized model through both serving engines (the generic route:
its weights are buffers) and ``generate``, token for token.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation.serving import ServingEngine as JEngine
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import Linear as JLinear
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as tq
from torch_serving_twins import solo, tiny_llamas

TOL = 1e-5
ALGOS = ("weight_only_int8", "weight_only_int4")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _weight(seed=0, k=64, n=48):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _both(w, algo, group):
    jqw, js = JIF.weight_quantize(paddle.to_tensor(w), algo=algo,
                                  group_size=group)
    tqw, ts = TIF.weight_quantize(torch.from_numpy(w), algo=algo,
                                  group_size=group)
    return np.asarray(jqw.numpy()), np.asarray(js.numpy()), tqw, ts


@pytest.mark.parametrize("group", [-1, 16])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_bit_for_bit(algo, group):
    w = _weight()
    w[3, 5] = 0.0
    w[:, 7] = 0.0                    # an all-zero column: scale 1e-8 / qmax
    jqw, js, tqw, ts = _both(w, algo, group)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tqw.numpy(), jqw)
    ulp = np.spacing(np.abs(js).astype(np.float32))
    assert np.all(np.abs(ts.numpy() - js) <= ulp)
    k = 64 if algo == "weight_only_int8" else 32
    assert tqw.shape == (k, 48)
    assert ts.shape == ((48,) if group < 0 else (64 // group, 48))


@pytest.mark.parametrize("group", [-1, 16])
@pytest.mark.parametrize("algo", ALGOS)
def test_dequantize_and_weight_only_linear_match_jax(algo, group):
    w = _weight(1)
    jqw, js, tqw, ts = _both(w, algo, group)
    want = jq.weight_dequantize(paddle.to_tensor(jqw), paddle.to_tensor(js),
                                algo, group_size=group).numpy()
    got = tq.weight_dequantize(tqw, ts, algo, group_size=group)
    assert got.dtype == torch.float32
    assert _err(got.numpy(), want) <= TOL
    # half a scale step of the weight it came from
    scale = ts.numpy() if group < 0 else np.repeat(ts.numpy(), group, 0)
    assert np.all(np.abs(got.numpy() - w) <= 0.5 * scale * (1 + 1e-5))
    x = np.random.default_rng(2).standard_normal((3, 5, 64)).astype(
        np.float32)
    b = np.random.default_rng(3).standard_normal(48).astype(np.float32)
    wd = "int8" if "int8" in algo else "int4"
    want = JIF.weight_only_linear(
        paddle.to_tensor(x), paddle.to_tensor(jqw), paddle.to_tensor(b),
        paddle.to_tensor(js), weight_dtype=wd, group_size=group).numpy()
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = TIF.weight_only_linear(tx, tqw, tb, ts, weight_dtype=wd,
                                 group_size=group)
    assert got.shape == (3, 5, 48)
    assert _err(got.detach().numpy(), want) <= TOL
    got.sum().backward()             # the activations and bias learn
    assert tx.grad is not None and tb.grad is not None


def test_refusals():
    w = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="algo"):
        TIF.weight_quantize(w, algo="int3")
    with pytest.raises(ValueError, match="group_size"):
        TIF.weight_quantize(w, group_size=4)
    with pytest.raises(ValueError, match="even"):
        TIF.weight_quantize(torch.zeros(5, 4), algo="weight_only_int4")
    with pytest.raises(ValueError, match="weight dtype"):
        TIF.weight_only_linear(torch.zeros(2, 6), torch.zeros(
            6, 4, dtype=torch.int8), weight_scale=torch.ones(4),
            weight_dtype="int2")
    with pytest.raises(ValueError, match="even"):
        tq.QuantizedLinear(5, 4, algo="weight_only_int4")


def test_llm_int8_linear_matches_jax():
    w = _weight(4)
    jqw, js, tqw, ts = _both(w, "weight_only_int8", -1)
    x = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    want = jq.llm_int8_linear(paddle.to_tensor(x), paddle.to_tensor(jqw),
                              weight_scale=paddle.to_tensor(js)).numpy()
    got = tq.llm_int8_linear(torch.from_numpy(x), tqw, weight_scale=ts)
    assert _err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("algo", ALGOS)
def test_from_linear_matches_jax(algo):
    paddle.seed(6)
    jl = JLinear(64, 48)
    tl = Linear(64, 48, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.numpy())))
        tl.bias.copy_(torch.from_numpy(
            np.random.default_rng(7).standard_normal(48).astype(np.float32)))
    jl.bias.set_value(paddle.to_tensor(tl.bias.detach().numpy()))
    jql = jq.QuantizedLinear.from_linear(jl, algo, group_size=16)
    tql = tq.QuantizedLinear.from_linear(tl, algo, group_size=16)
    assert np.array_equal(tql.quant_weight.numpy(),
                          np.asarray(jql.quant_weight.numpy()))
    assert sorted(n for n, _ in tql.named_buffers()) == [
        "quant_weight", "weight_scale"]
    assert [n for n, _ in tql.named_parameters()] == ["bias"]
    x = np.random.default_rng(8).standard_normal((2, 64)).astype(np.float32)
    assert _err(tql(torch.from_numpy(x)).detach().numpy(),
                jql(paddle.to_tensor(x)).numpy()) <= TOL


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.a = Linear(8, 6, **kw)
        self.b = self.a                      # the same Linear twice
        self.c = Linear(8, 6, **kw)
        self.c.weight = self.a.weight        # a shared weight parameter
        self.odd = Linear(7, 4, **kw)
        self.lm_head = Linear(6, 5, **kw)
        self.inner = torch.nn.ModuleList([Linear(4, 4, **kw)])


@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_linears_skip_ties_and_odd_widths(algo):
    net = tq.quantize_linears(_Net(), algo, skip=("lm_head",))
    assert net.b is net.a and isinstance(net.a, tq.QuantizedLinear)
    assert isinstance(net.c, tq.QuantizedLinear) and net.c is not net.a
    assert net.c.quant_weight is net.a.quant_weight
    assert net.c.weight_scale is net.a.weight_scale
    assert type(net.lm_head) is Linear
    assert isinstance(net.inner[0], tq.QuantizedLinear)
    assert (type(net.odd) is Linear) == ("int4" in algo)


def _quantized_pair(seed, algo="weight_only_int8"):
    """(JAX Llama, port Llama), the same weights, each quantized by its own
    package."""
    jmodel, model = tiny_llamas(seed)
    jq.quantize_linears(jmodel, algo)
    tq.quantize_linears(model, algo)
    return jmodel, model


@pytest.mark.parametrize("algo", ALGOS)
def test_quantized_llama_state_carries_across(algo):
    jmodel, model = _quantized_pair(41, algo)
    params, buffers = jmodel.raw_state()
    tbufs = dict(model.named_buffers())
    assert sorted(tbufs) == sorted(k for k, v in buffers.items()
                                   if v is not None)
    for k, v in buffers.items():
        assert np.array_equal(tbufs[k].numpy(), np.asarray(v)), k
    # a fresh quantized port model loaded from JAX's (params, buffers)
    fresh = tq.quantize_linears(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), algo)
    fresh.load_numpy_state({k: np.asarray(v) for k, v in params.items()},
                           {k: np.asarray(v) for k, v in buffers.items()
                            if v is not None})
    assert fresh.llama.layers[0].mlp.up_proj.quant_weight.dtype == torch.int8
    ids = np.random.default_rng(9).integers(0, 256, (2, 12)).astype(np.int32)
    want = jmodel(paddle.to_tensor(ids)).numpy()
    got = fresh(torch.from_numpy(ids).long()).detach().numpy()
    assert _err(got, want) <= TOL
    with pytest.raises(KeyError, match="missing"):
        fresh.load_numpy_state({k: np.asarray(v) for k, v in params.items()},
                               {})


def test_quantized_llama_serves_through_the_generic_route():
    jmodel, model = _quantized_pair(42)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 11, 20, 7)]
    refs = [solo(jmodel, p, 6) for p in prompts]
    outs = []
    for cls, m in ((JEngine, jmodel), (ServingEngine, model)):
        eng = cls(m, max_batch=2, page_size=8, max_seq_len=64,
                  prefill_chunk=8)
        rids = [eng.submit(p, 6) for p in prompts[:2]]
        eng.step()
        rids += [eng.submit(p, 6) for p in prompts[2:]]
        out = eng.run()
        outs.append([out[r] for r in rids])
        assert eng._fused_spec() is None          # the generic route
    assert outs[1] == outs[0] == refs
    got = model.generate(torch.from_numpy(prompts[1][None]).long(),
                         max_new_tokens=6, return_full_sequence=False)
    assert got[0].tolist() == refs[1]
