"""``tools/torch_memwatch.py`` on the CPU: ``plan``'s figures are the
port's planner's (``estimate_engine_memory``, ``plan_fused_layers``) to
the byte, an unfittable N and a refused tensor-parallel degree exit 1;
``view`` prints ``format_program_table``; ``check``'s gate flags growth,
passes an unchanged table and fails when nothing matched; ``bank`` on the
CPU then ``check`` against it pass, with a row for every program of the
suite (the MoE-GPT train step among them)."""

import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
import json
from pathlib import Path

import pytest

from paddle_tpu_torch.models import LlamaConfig, MoEGPTConfig
from paddle_tpu_torch.observability import memory as mem

TOOL = Path(__file__).resolve().parents[1] / "tools" / "torch_memwatch.py"
GB = 1 << 30


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("torch_memwatch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_tail(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int4"])
def test_plan_figures_are_the_planners(tool, capsys, weight_dtype):
    rc = tool.main(["plan", "--model", "llama2_7b", "--rung", "4",
                    "--max-seq", "1024", "--page-size", "64", "--chunk",
                    "256", "--fused-layers", "4", "--weight-dtype",
                    weight_dtype, "--json"])
    doc = _json_tail(capsys.readouterr().out)
    dims = mem.ModelDims.of_config(LlamaConfig.llama2_7b())
    want = mem.estimate_engine_memory(
        dims, page_size=64, max_batch=4, max_seq_len=1024, chunk=256,
        weight_dtype=weight_dtype, kv_dtype="bfloat16")
    assert doc["plan"] == json.loads(json.dumps(want))
    fused = mem.plan_fused_layers(
        dims, fused_layers=4, batch=4, page_size=64, io_dtype_bytes=2,
        vmem_limit=48 * 1024, max_seq_len=1024,
        int4_weights=weight_dtype == "int4", hbm_bytes=80 * GB)
    assert doc["fused_decode"] == json.loads(json.dumps(fused))
    assert doc["verdict"] == mem.fits(want, 80 * GB)
    assert rc == 0
    # the largest page budget that fits, and one page more that does not
    kw = dict(page_size=64, max_batch=4, max_seq_len=1024, chunk=256,
              weight_dtype=weight_dtype, kv_dtype="bfloat16")
    top = doc["max_page_budget"]
    assert mem.estimate_engine_memory(dims, page_budget=top,
                                      **kw)["total"] <= 80 * GB
    assert mem.estimate_engine_memory(dims, page_budget=top + 1,
                                      **kw)["total"] > 80 * GB


def test_plan_refuses(tool, capsys):
    assert tool.main(["plan", "--model", "llama2_7b", "--fused-layers", "2",
                      "--shared-kb", "4"]) == 1
    assert "REFUSED" in capsys.readouterr().out
    assert tool.main(["plan", "--model", "llama2_70b", "--tp", "3"]) == 1
    assert "REFUSED" in capsys.readouterr().out
    # a 7B at bf16 does not fit a 10 GB card
    assert tool.main(["plan", "--model", "llama2_7b", "--hbm-gb", "10"]) == 1
    assert "DOES NOT FIT" in capsys.readouterr().out


def _row(kind, bucket, temp, peak, model="m0"):
    return {"model": model, "kind": kind, "bucket": bucket, "extra": "",
            "argument": 10, "output": 5, "temp": temp, "alias": 0,
            "generated_code": 0, "peak": peak, "captures": 1}


def test_view_prints_the_table(tool, capsys, tmp_path):
    rows = [_row("decode_fused", 4, 100, 200), _row("train_step", 2, 7, 9)]
    path = tmp_path / "a.json"
    path.write_text(json.dumps({"rows": rows}))
    assert tool.main(["view", str(path)]) == 0
    assert capsys.readouterr().out.strip() == \
        mem.format_program_table(rows).strip()


@pytest.mark.parametrize("now,rc,word", [
    ([_row("decode_fused", 4, 100, 200)], 0, "gate OK"),
    ([_row("decode_fused", 4, 120, 200)], 1, "GREW"),
    ([_row("decode_fused", 8, 100, 200)], 1, "FAILED")],
    ids=["unchanged", "grew", "nothing-matched"])
def test_check_gate(tool, capsys, tmp_path, monkeypatch, now, rc, word):
    path = tmp_path / "a.json"
    path.write_text(json.dumps({"rows": [_row("decode_fused", 4, 100,
                                              200)]}))
    monkeypatch.setattr(tool, "capture_suite",
                        lambda device=None: {"rows": now})
    assert tool.main(["check", "--artifact", str(path)]) == rc
    assert word in capsys.readouterr().out


def test_bank_then_check_on_the_cpu(tool, capsys, tmp_path):
    out = tmp_path / "mw.json"
    assert tool.main(["bank", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    kinds = sorted((r["kind"], r["bucket"]) for r in doc["rows"])
    assert kinds == sorted([("decode_fused", 2)] * 2
                           + [("decode_fused_nlayer", 2)] * 2
                           + [("prefill_chunk", 1), ("decode_generic", 2)]
                           + [("train_step", 2)] * 2)
    assert all(r["temp"] == 0 and r["captures"] == 1 for r in doc["rows"])
    assert doc["estimates"] and doc["device"] == "cpu"
    from paddle_tpu_torch.generation.program_cache import model_signature
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import MoEGPTForCausalLM
    sig = model_signature(MoEGPTForCausalLM(
        MoEGPTConfig.tiny(num_hidden_layers=2), device="cpu",
        generator=seed(13)))[:8]
    assert any(r["model"] == sig for r in doc["rows"])
    capsys.readouterr()
    assert tool.main(["check", "--device", "cpu", "--artifact",
                      str(out)]) == 0
    assert "gate OK: 8 programs" in capsys.readouterr().out
