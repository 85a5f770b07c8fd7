"""Rules the PyTorch port keeps.

  - No file of ``paddle_tpu_torch/``, not ``chip_smoke.py`` and no
    ``tools/torch_*.py`` imports ``jax`` or ``paddle_tpu`` (AST scan).
  - Entry points default to the CUDA card and raise, never fall back to
    the CPU, when there is none.
  - A kernel wrapper given CPU tensors runs its plain version and leaves
    its launch counter alone (the serving and the training kernels, the
    fused RMSNorm).
  - ``chip_smoke.py`` fails, printing no result, without a card and when
    it stands alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import kernels
from paddle_tpu_torch.device import resolve_device, seed
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_block_decode as fb
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.kernels.paged_attention import PagedKVCache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.testing.transport import adopt_and_decode_in_child

REPO = Path(__file__).resolve().parents[1]
PORT = Path(paddle_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("torch_*.py")))
    assert len(files) > 10
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for root in _imported_roots(tree):
            if root in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {root}")
    assert not bad, bad


def test_import_scan_catches_a_jax_import():
    tree = ast.parse("import os\nfrom jax import numpy\n"
                     "import paddle_tpu.nn as nn\n")
    assert {"jax", "paddle_tpu"} <= set(_imported_roots(tree))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: LlamaForCausalLM(LlamaConfig.tiny()),
    lambda: LlamaForCausalLM(LlamaConfig.tiny(), device="cuda"),
    lambda: Linear(4, 8),
    lambda: Embedding(4, 8),
    lambda: RMSNorm(8),
    lambda: PagedKVCache(1, 3, 8, 1, 8, 1, 16),
    lambda: seed(0, None),
    lambda: resolve_device(),
    lambda: DevicePrefetcher([]),
    lambda: adopt_and_decode_in_child({}),
], ids=["llama", "llama-cuda", "linear", "embedding", "rmsnorm",
        "paged-kv-cache", "seed", "resolve_device", "device-prefetcher",
        "child-decode"])
def test_entry_points_default_to_cuda_and_never_fall_back(no_cuda, build):
    with pytest.raises(RuntimeError, match="cuda"):
        build()


def test_cpu_is_explicit(no_cuda):
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=seed(3))
    assert model.device.type == "cpu"
    eng = ServingEngine(model, max_batch=2, page_size=8, max_seq_len=32)
    assert eng.pool.k_pages[0].device.type == "cpu"


def test_weights_come_from_the_generator():
    a = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=seed(5))
    b = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=seed(5))
    c = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=seed(6))
    for (n, pa_), (_, pb), (_, pc) in zip(a.named_parameters(),
                                          b.named_parameters(),
                                          c.named_parameters()):
        assert torch.equal(pa_, pb), n
        if pa_.dim() == 2:
            assert not torch.equal(pa_, pc), n


def _case(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _prefill_args(rng):
    return (_case(rng, 1, 6, 2, 8), _case(rng, 1, 6, 2, 8),
            _case(rng, 1, 6, 2, 8), 6)


def _paged_args(rng):
    bt = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    sl = torch.tensor([11, 0], dtype=torch.int32)
    return (_case(rng, 2, 2, 8), _case(rng, 1, 3, 8, 8),
            _case(rng, 1, 3, 8, 8), bt, sl)


def _block_args(rng):
    h, i = 16, 32
    w = fb.BlockDecodeWeights(
        ln1=_case(rng, h), wq=_case(rng, h, h), wk=_case(rng, h, h),
        wv=_case(rng, h, h), wo=_case(rng, h, h), ln2=_case(rng, h),
        wg=_case(rng, h, i), wu=_case(rng, h, i), wd=_case(rng, i, h))
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    sl = torch.tensor([5], dtype=torch.int32)
    return (_case(rng, 1, h), w, _case(rng, 2, 3, 8, 8),
            _case(rng, 2, 3, 8, 8), bt, sl)


def _chunk_args(rng):
    bt = torch.tensor([[2, 1]], dtype=torch.int32)
    st = torch.tensor([5], dtype=torch.int32)
    return (_case(rng, 1, 4, 2, 8), _case(rng, 1, 3, 8, 8),
            _case(rng, 1, 3, 8, 8), bt, st)


def _multi_block_args(rng):
    x, w, kp, vp, bt, sl = _block_args(rng)
    mw = fb.stack_block_weights([w, w])
    return (x, mw, [kp, kp.clone()], [vp, vp.clone()], bt, sl)


def _flash_args(rng):
    return (_case(rng, 4, 6, 8), _case(rng, 2, 6, 8), _case(rng, 2, 6, 8))


def _flash_bwd_args(rng):
    return _flash_args(rng) + (_case(rng, 4, 6, 8), _case(rng, 4, 6),
                               _case(rng, 4, 6))


def _rms_args(rng):
    return (_case(rng, 5, 16), _case(rng, 16), 1e-6)


def _rms_bwd_args(rng):
    return (_case(rng, 5, 16), _case(rng, 16), _case(rng, 5, 16),
            _case(rng, 5, 1).abs())


@pytest.mark.parametrize("mod,name,plain,make,kw", [
    (da, "flash_prefill", "flash_prefill_ref", _prefill_args, {}),
    (pa, "paged_attention", "paged_attention_ref", _paged_args, {}),
    (pa, "paged_chunk_attention", "paged_chunk_attention_ref", _chunk_args,
     {}),
    (fb, "fused_block_decode", "fused_block_decode_ref", _block_args,
     dict(num_heads=2, num_kv_heads=2)),
    (fb, "fused_multi_block_decode", "fused_multi_block_decode_ref",
     _multi_block_args, dict(num_heads=2, num_kv_heads=2)),
    (fa, "flash_attention_fwd", "flash_attention_fwd_ref", _flash_args,
     dict(n_heads=2, n_kv_heads=1)),
    (fa, "flash_attention_bwd_dq", "flash_attention_bwd_dq_ref",
     _flash_bwd_args, dict(n_heads=2, n_kv_heads=1)),
    (fa, "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ref",
     _flash_bwd_args, dict(n_heads=2, n_kv_heads=1)),
    (rn, "rms_norm_fwd", "rms_norm_fwd_ref", _rms_args, {}),
    (rn, "rms_norm_bwd_dx", "rms_norm_bwd_dx_ref", _rms_bwd_args, {}),
], ids=["flash_prefill", "paged_attention", "paged_chunk_attention",
        "fused_block_decode", "fused_multi_block_decode",
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "rms_norm_fwd", "rms_norm_bwd_dx"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, mod, name, plain,
                                            make, kw):
    calls = []
    real = getattr(mod, plain)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mod, plain, spy)

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(_build, "bind", no_build)
    kernels.reset_launches()
    getattr(mod, name)(*make(np.random.default_rng(0)), **kw)
    assert calls == [1]
    assert kernels.launch_counts()[name] == 0


def test_every_kernel_wrapper_counts_launches():
    names = {fn.__name__ for fn in kernels.wrappers()}
    assert names == {"flash_prefill", "paged_attention",
                     "paged_chunk_attention", "fused_block_decode",
                     "fused_multi_block_decode", "flash_attention_fwd",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                     "rms_norm_fwd", "rms_norm_bwd_dx"}
    # one library per source; the three attention kernels share one, the
    # two RMSNorm kernels another
    assert set(_build.sources()) == {"flash_prefill", "paged_attention",
                                     "paged_chunk_attention",
                                     "fused_block_decode",
                                     "fused_multi_block_decode",
                                     "flash_attention", "rms_norm"}
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, {})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
