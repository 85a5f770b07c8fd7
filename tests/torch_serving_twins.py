"""What the port's serving tests share when they hold the port's engine to
the JAX package's: one tiny GQA Llama (or GPT) in both packages from the
same numpy weights (carried into the port through ``convert``), a fake host clock
patched into both serving modules (it stands still inside a step and
advances ``DT`` before each one, and ``sleep`` returns at once), flags set
in both packages, and the JAX model's solo greedy decode.
"""

import contextlib
import dataclasses
import types

import numpy as np

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation import serving as jserving
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

DT = 0.01          # fake seconds a step


def tiny_llamas(seed: int, **overrides):
    """(the JAX model, the port's on the CPU) with the same weights; the
    tiny config with ``overrides`` (e.g. a longer context)."""
    paddle.seed(seed)
    jmodel = JLlamaForCausalLM(dataclasses.replace(JLlamaConfig.tiny(),
                                                   **overrides))
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(),
                                                 **overrides), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def tiny_gpts(seed: int, **overrides):
    """(the JAX GPT, the port's on the CPU) with the same weights; the tiny
    config with ``overrides``."""
    paddle.seed(seed)
    jmodel = JGPTForCausalLM(dataclasses.replace(JGPTConfig.tiny(),
                                                 **overrides))
    params, _ = jmodel.raw_state()
    model = GPTForCausalLM(dataclasses.replace(GPTConfig.tiny(),
                                               **overrides), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


class Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now


def patch_clock(monkeypatch) -> Clock:
    c = Clock()
    fake = types.SimpleNamespace(perf_counter=c.perf_counter,
                                 sleep=lambda s: None)
    monkeypatch.setattr(jserving, "time", fake)
    monkeypatch.setattr(tserving, "time", fake)
    return c


@contextlib.contextmanager
def both_flags(**kw):
    """Set flags in both packages; restore them after."""
    prev = {k: jflags.get_flag(k) for k in kw}
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    try:
        yield
    finally:
        jflags.set_flags(prev)
        tflags.reset_flags()


def clocked(cls, model, clock: Clock, **kw):
    """An engine whose every step first advances the clock by DT (the clock
    restarts at 1000 s for each engine)."""
    clock.now = 1000.0
    eng = cls(model, **kw)
    inner = eng.step

    def step():
        clock.now += DT
        inner()
    eng.step = step
    return eng


def solo(jmodel, prompt, n):
    """The JAX model's greedy decode of ``n`` tokens after ``prompt``."""
    return jmodel.generate(paddle.to_tensor(prompt[None]), max_new_tokens=n,
                           do_sample=False, return_full_sequence=False
                           ).numpy()[0].tolist()


def tokens(rng, n):
    return rng.integers(0, 256, (n,)).astype(np.int32)
