"""``amp.debugging`` (the NaN/Inf checker) against the JAX package's, on
CPU tensors.

- ``FLAGS_check_nan_inf``: level 0 raises ``FloatingPointError`` naming the
  first ATen op whose output is not finite (a NaN planted in one weight of
  the tiny Llama: its matmul); level 1 warns and the forward completes;
  off, no dispatch mode is installed. Setting the flag directly installs
  the checker as ``enable_tensor_checker`` does.
- The dump (``TensorCheckerConfig(output_dir=...)``) writes the JAX
  package's JSONL lines (the same keys, the same statistics of the same
  values); ``compare_accuracy`` writes the JAX function's report for the
  same two dump files.
- ``check_numerics`` counts as the JAX function does and raises in the
  abort mode; ``checked_jit`` raises ``FloatingPointError`` and passes a
  finite function through.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM


@pytest.fixture(autouse=True)
def _checker_off():
    yield
    dbg.disable_tensor_checker()
    tflags.reset_flags()
    assert not dbg.checker_installed()


@pytest.fixture(scope="module")
def llama():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(3))


def _ids():
    return torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8)))


def _poisoned(model):
    """A copy whose first layer's down projection holds one NaN."""
    import copy
    bad = copy.deepcopy(model)
    with torch.no_grad():
        bad.llama.layers[0].mlp.down_proj.weight[3, 5] = float("nan")
    return bad


def test_abort_names_the_first_op(llama):
    bad = _poisoned(llama)
    assert _get_current_dispatch_mode() is None
    dbg.enable_tensor_checker()
    assert dbg.checker_installed()
    with pytest.raises(FloatingPointError,
                       match=r"Operator 'aten::(mm|addmm|matmul|bmm)'"):
        bad(_ids())
    # a clean model runs through, and so does a finite op chain
    with torch.no_grad():
        out = llama(_ids())
    assert torch.isfinite(out).all()
    with pytest.raises(FloatingPointError, match="aten::log"):
        torch.log(torch.tensor([1.0, 0.0]) - 1.0)


def test_warn_level_completes(llama):
    bad = _poisoned(llama)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    assert tflags.get_flag("check_nan_inf_level") == 1
    with pytest.warns(UserWarning, match="contains NaN or Inf"):
        out = bad(_ids())
    assert torch.isnan(out).any()


def test_flag_off_installs_nothing_and_the_flag_installs_it():
    assert not dbg.checker_installed()
    assert _get_current_dispatch_mode() is None
    torch.log(torch.tensor([0.0]))                     # -inf, unchecked
    tflags.set_flags({"check_nan_inf": True})
    assert dbg.checker_installed()
    with pytest.raises(FloatingPointError):
        torch.log(torch.tensor([0.0]))
    tflags.reset_flags()
    assert not dbg.checker_installed()
    assert _get_current_dispatch_mode() is None
    assert "check_nan_inf" not in tflags.PROGRAM_FLAGS


def test_dump_lines_read_like_jax(tmp_path):
    x = np.array([[1.0, -2.0, np.inf], [0.5, np.nan, 3.0]], np.float32)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF, output_dir=str(tmp_path)))
    with pytest.warns(UserWarning):
        torch.from_numpy(x) * 2.0
    dbg.disable_tensor_checker()
    lines = [json.loads(r) for r in
             (tmp_path / "op_stats.jsonl").read_text().splitlines()]
    assert [r["op"] for r in lines] == ["aten::mul.Tensor"]
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jdbg._dump.file = open(jdir / "op_stats.jsonl", "w")
    jdbg._dump.seq = 0
    jdbg.record_op_stats("multiply", x * 2.0)
    jdbg._dump.file.close()
    jdbg._dump.file = None
    want = json.loads((jdir / "op_stats.jsonl").read_text())
    got = lines[0]
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "op":
            assert got[k] == want[k], k


def _dump_file(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_compare_accuracy_writes_the_jax_report(tmp_path):
    def row(seq, op, mean, nan=0, inf=0, out=0):
        return {"seq": seq, "op": op, "out": out, "shape": [2],
                "dtype": "float32", "num_nan": nan, "num_inf": inf,
                "min": mean - 1, "max": mean + 1, "mean": mean,
                "abs_mean": abs(mean)}

    a = [row(1, "aten::mm", 1.0), row(2, "aten::add.Tensor", 2.0),
         row(3, "aten::mul.Tensor", 3.0), row(4, "aten::exp", 4.0),
         row(5, "aten::sum", 5.0)]
    b = [row(1, "aten::mm", 1.0005), row(2, "aten::add.Tensor", 2.5),
         row(3, "aten::mul.Tensor", 3.0, nan=1), row(4, "aten::log", 4.0)]
    _dump_file(tmp_path / "a.jsonl", a)
    _dump_file(tmp_path / "b.jsonl", b)
    got = dbg.compare_accuracy(str(tmp_path / "a.jsonl"),
                               str(tmp_path / "b.jsonl"),
                               str(tmp_path / "port.json"))
    want = jdbg.compare_accuracy(str(tmp_path / "a.jsonl"),
                                 str(tmp_path / "b.jsonl"),
                                 str(tmp_path / "jax.json"))
    assert got == want and len(got) == 4
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def test_check_numerics_matches_jax():
    arr = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    assert dbg.check_numerics(torch.from_numpy(arr), debug_mode=1) == \
        jdbg.check_numerics(arr, debug_mode=1) == (1, 2)
    with pytest.raises(FloatingPointError, match="1 NaN, 2 Inf"):
        dbg.check_numerics(torch.from_numpy(arr), "op", "x")
    assert dbg.check_numerics(torch.ones(3)) == (0, 0)


def test_checked_jit_raises_and_passes_through():
    def f(x):
        return torch.log(x) * 2.0

    checked = dbg.checked_jit(f)
    with pytest.raises(FloatingPointError, match="aten::log"):
        checked(torch.tensor([1.0, 0.0]))
    out = checked(torch.tensor([1.0, 2.0]))
    assert torch.allclose(out, torch.log(torch.tensor([1.0, 2.0])) * 2.0)
    assert not dbg.checker_installed()

    def nan_out(x):
        return x       # a NaN input passes no op: the output check sees it

    with pytest.raises(FloatingPointError, match="output 0"):
        dbg.checked_jit(nan_out)(torch.tensor([float("nan")]))
