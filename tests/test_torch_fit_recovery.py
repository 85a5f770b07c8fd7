"""``Model.fit``'s step recovery, the training fault sites and the training
instruments, against the JAX package's, on the CPU.

Both packages fit the same seeded fp32 tiny Llama (the weights of
``test_torch_train_fit``'s pair) on the same shuffled batches: 12 rows,
batch 4, two epochs, the loss pulled every 2 steps, AdamW with a warmup
into a cosine decay and a global-norm clip, batches prefetched, a
``save_dir`` (so ``ModelCheckpoint`` saves too), backoff 0.

- Under ``FLAGS_fault_inject="train_dispatch:every=2:times=2;
  train_sync:every=3:times=1;checkpoint_save:every=1:times=1"`` (the
  first save is the first emergency checkpoint's, before epoch 0's
  ``ModelCheckpoint``, which no recovery guards): equal
  ``train_retries_total``, ``train_recoveries``,
  ``train_emergency_checkpoints`` and ``faults_injected{site}``, and the
  parameters within ``test_torch_train_fit``'s 1e-4 after AdamW (each
  update ~ g / |g| elementwise amplifies last-bit gradient differences);
  the port's parameters equal its own fault-free run's exactly; the JAX
  ``load`` reads the port's emergency checkpoint.
- ``train_syncs``, ``train_throttles``, ``train_in_flight``,
  ``train_metrics_staleness``, ``train_step_traces`` and
  ``io_batches_staged`` equal JAX's on that fit.
- A ``train_sync`` fault at a mid-epoch pull trains its batch once; a
  fault in the middle of a ``grad_accum_steps=2`` step leaves the
  parameters of no fault; ``checkpoint_save`` is retried inside the
  emergency save; an exhausted budget re-raises (the injected fault, or a
  loss function's ``RuntimeError`` after ``train_max_retries`` retries in
  both packages; the port also recovers a first step, where JAX falls back
  to its eager loop); a ``KernelError`` propagates untouched.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.framework.io import load as jload
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.kernels._build import KernelError
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.testing import faults

SPEC = ("train_dispatch:every=2:times=2;train_sync:every=3:times=1;"
        "checkpoint_save:every=1:times=1")
ADAM_PARAM_TOL = 1e-4
LR, STEPS = 1e-2, 6
FIT = dict(epochs=2, batch_size=4, metrics_every=2, verbose=0)
RECOVERY = ("train_retries_total", "train_recoveries",
            "train_emergency_checkpoints")
INSTRUMENTS = ("train_syncs", "train_throttles", "train_in_flight",
               "train_metrics_staleness", "train_step_traces",
               "io_batches_staged")


@pytest.fixture(autouse=True)
def _fresh():
    """Telemetry on, backoff 0, both registries empty, no spec armed."""
    kw = {"telemetry": True, "train_retry_backoff": 0.0}
    prior = {k: jflags.get_flag(k) for k in kw}
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    for obs in (jobs, tobs):
        obs.registry().clear()
    yield
    jflags.set_flags(prior)
    tflags.reset_flags()
    for obs in (jobs, tobs):
        obs.registry().clear()


def _weights(seed=41):
    return {k: np.asarray(v)
            for k, v in _jmodel(seed).raw_state()[0].items()}


def _data(n=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (n, 17))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def _jmodel(seed=41):
    """The JAX model of :func:`_weights` (the same seed)."""
    paddle.seed(seed)
    return JLlamaForCausalLM(JLlamaConfig.tiny())


def _jfit(save_dir, loss=None, **kw):
    jmodel = _jmodel()
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=STEPS), 2,
                             LR / 10, LR)
    m = JModel(jmodel)
    m.prepare(paddle.optimizer.AdamW(
        sched, parameters=jmodel.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
        loss=loss or JCriterion(JLlamaConfig.tiny()))
    x, y = _data()
    paddle.seed(5)
    loader = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                            shuffle=True, use_buffer_reader=False)
    m.fit(loader, save_dir=save_dir, **{**FIT, **kw})
    return jmodel


def _tfit(weights, save_dir, loss=None, **kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state(weights)
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR, T_max=STEPS), 2,
                             LR / 10, LR)
    m = Model(model)
    m.prepare(AdamW(sched, parameters=model.named_parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0)),
              loss=loss or LlamaPretrainingCriterion(LlamaConfig.tiny()))
    x, y = _data()
    m.fit(tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]),
          seed=5, save_dir=save_dir, **{**FIT, **kw})
    return m


def _counters(obs, names):
    snap = obs.snapshot()["metrics"]
    out = {}
    for name in names:
        for s in snap.get(name, {}).get("series", []):
            key = (name,) + tuple(sorted(s["labels"].items()))
            out[key] = s.get("count", s.get("value"))
    return out


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spec through both packages' fit, and the port's fault-free fit
    (registries cleared around each)."""
    weights = _weights()
    root = tmp_path_factory.mktemp("fit")
    out = {}
    for obs in (jobs, tobs):
        obs.registry().clear()
    with jfaults.armed(SPEC, train_retry_backoff=0.0, telemetry=True), \
            faults.armed(SPEC, train_retry_backoff=0.0, telemetry=True), \
            pytest.warns(UserWarning, match="attempting recovery"):
        jmodel = _jfit(str(root / "jax"))
        tm = _tfit(weights, str(root / "port"))
    names = RECOVERY + INSTRUMENTS + ("faults_injected",)
    out["jax"] = dict(counters=_counters(jobs, names), params={
        k: np.asarray(v) for k, v in jmodel.raw_state()[0].items()})
    out["port"] = dict(counters=_counters(tobs, names),
                       params=_params(tm.network), model=tm,
                       dir=root / "port")
    tobs.registry().clear()
    with tflags_set(telemetry=True, train_retry_backoff=0.0):
        clean = _tfit(weights, str(root / "clean"))
    out["clean"] = dict(params=_params(clean.network), model=clean)
    out["weights"] = weights
    return out


class tflags_set:
    """Set the port's flags for a block, then forget them."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        tflags.set_flags(self.kw)

    def __exit__(self, *exc):
        tflags.reset_flags()


def test_recovery_counters_match_jax(runs):
    got, want = runs["port"]["counters"], runs["jax"]["counters"]
    rec = {k: v for k, v in want.items()
           if k[0] in RECOVERY + ("faults_injected",)}
    assert {k: got.get(k) for k in rec} == rec
    # two dispatch faults recovered; the sync fault hit a recovery's
    # drain, which the same recovery retried
    assert rec[("train_recoveries",)] == 2
    assert rec[("train_retries_total",)] == 3
    assert rec[("train_emergency_checkpoints",)] == 2
    assert rec[("faults_injected", ("site", "train_dispatch"))] == 2
    assert rec[("faults_injected", ("site", "train_sync"))] == 1
    assert rec[("faults_injected", ("site", "checkpoint_save"))] == 1


def test_training_instruments_match_jax(runs):
    got, want = runs["port"]["counters"], runs["jax"]["counters"]
    inst = {k: v for k, v in want.items() if k[0] in INSTRUMENTS}
    assert {k[0] for k in inst} == set(INSTRUMENTS)
    assert {k: got.get(k) for k in inst} == inst
    assert inst[("io_batches_staged",)] == 6


def test_recovered_parameters_match_jax_and_the_fault_free_run(runs):
    jp, tp = runs["jax"]["params"], runs["port"]["params"]
    assert sorted(jp) == sorted(tp)
    for k in jp:
        err = float(np.max(np.abs(tp[k].numpy().astype(np.float64) - jp[k])))
        assert err <= ADAM_PARAM_TOL, k
    clean = runs["clean"]["params"]
    for k in tp:
        assert torch.equal(tp[k], clean[k]), k
    # one update an applied step, the scheduler with it
    for m in (runs["port"]["model"], runs["clean"]["model"]):
        assert m._optimizer.state_dict()["@step"] == STEPS
        assert m._optimizer._lr.last_epoch == STEPS


def test_jax_loads_the_emergency_checkpoint(runs):
    path = runs["port"]["dir"] / "emergency.pdparams"
    got = jload(str(path))
    tp = Model(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    tp.load(str(runs["port"]["dir"] / "emergency"))
    for k, v in tp.network.state_dict().items():
        np.testing.assert_array_equal(np.asarray(got[k].numpy()),
                                      v.numpy())


def _port_only(weights, tmp, spec, loss=None, **kw):
    tobs.registry().clear()
    with faults.armed(spec, train_retry_backoff=0.0, telemetry=True):
        m = _tfit(weights, str(tmp), loss=loss, **kw)
    return m, _counters(tobs, RECOVERY + ("faults_injected",))


def test_a_sync_fault_at_a_pull_trains_its_batch_once(runs, tmp_path):
    """train_sync:every=1:times=1 fires at the first pull (inside step 1's
    call, after its update): recovery resumes from the sync."""
    with pytest.warns(UserWarning, match="attempting recovery"):
        m, c = _port_only(runs["weights"], tmp_path,
                          "train_sync:every=1:times=1")
    assert c[("train_recoveries",)] == 1
    assert c[("faults_injected", ("site", "train_sync"))] == 1
    assert m._optimizer.state_dict()["@step"] == STEPS
    clean = runs["clean"]["params"]
    for k, p in m.network.named_parameters():
        assert torch.equal(p, clean[k]), k


class _FlakyLoss(torch.nn.Module):
    """The criterion, raising once at its ``at``-th call (with
    ``accumulate_grad_batches=2``: a step's second micro-batch)."""

    def __init__(self, at, always=False):
        super().__init__()
        self.calls, self.at, self.always = 0, at, always
        self.ce = LlamaPretrainingCriterion(LlamaConfig.tiny())

    def forward(self, logits, labels):
        self.calls += 1
        if self.calls == self.at or (self.always and self.calls >= self.at):
            raise RuntimeError("flaky loss")
        return self.ce(logits, labels)


def test_a_fault_inside_an_accumulated_step_leaves_no_gradient(runs,
                                                               tmp_path):
    weights = runs["weights"]
    with tflags_set(telemetry=True, train_retry_backoff=0.0):
        clean = _tfit(weights, None, accumulate_grad_batches=2)
        with pytest.warns(UserWarning, match="flaky loss"):
            flaky = _tfit(weights, str(tmp_path), loss=_FlakyLoss(at=4),
                          accumulate_grad_batches=2)
    for (k, a), b in zip(clean.network.named_parameters(),
                         flaky.network.parameters()):
        assert torch.equal(a, b), k
    assert flaky._optimizer.state_dict()["@step"] == STEPS


def test_checkpoint_save_is_retried_inside_the_emergency_save(runs,
                                                              tmp_path):
    spec = "train_dispatch:every=2:times=1;checkpoint_save:every=1:times=2"
    with pytest.warns(UserWarning, match="attempting recovery"):
        m, c = _port_only(runs["weights"], tmp_path, spec)
    assert c[("faults_injected", ("site", "checkpoint_save"))] == 2
    assert c[("train_emergency_checkpoints",)] == 1
    assert (tmp_path / "emergency.pdparams").exists()
    assert (tmp_path / "emergency.pdopt").exists()


def test_an_exhausted_budget_reraises(runs, tmp_path):
    with pytest.warns(UserWarning), pytest.raises(faults.InjectedFault,
                                                  match="train_dispatch"):
        _port_only(runs["weights"], tmp_path, "train_dispatch:every=1")
    c = _counters(tobs, RECOVERY)
    assert c[("train_retries_total",)] == 2       # FLAGS_train_max_retries
    assert c[("train_recoveries",)] == 0


def test_a_raising_loss_is_retried_then_reraised_as_in_jax(runs, tmp_path):
    """The loss raises on every batch of 2 rows: the last of 10 rows in
    batches of 4, a new shape the jitted JAX step retraces for (its trace
    runs the loss), so both packages recover it past step 0."""
    weights = runs["weights"]

    def failing(crit):
        def loss(logits, labels):
            if labels.shape[0] == 2:
                raise RuntimeError("boom")
            return crit(logits, labels)
        return loss

    x, y = _data(10)
    seen = {}
    for pkg, obs in (("jax", jobs), ("port", tobs)):
        obs.registry().clear()
        with pytest.warns(UserWarning), pytest.raises(RuntimeError,
                                                      match="boom"):
            if pkg == "jax":
                jmodel = _jmodel()
                m = JModel(jmodel)
                m.prepare(paddle.optimizer.AdamW(
                    LR, parameters=jmodel.parameters()),
                    loss=failing(JCriterion(JLlamaConfig.tiny())))
                m.fit(jio.TensorDataset([x, y]), batch_size=4,
                      shuffle=False, save_dir=str(tmp_path / pkg),
                      verbose=0)
            else:
                model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
                model.load_numpy_state(weights)
                m = Model(model)
                m.prepare(AdamW(LR, parameters=model.named_parameters()),
                          loss=failing(LlamaPretrainingCriterion(
                              LlamaConfig.tiny())))
                m.fit(tio.TensorDataset([torch.from_numpy(x),
                                         torch.from_numpy(y)]),
                      batch_size=4, shuffle=False,
                      save_dir=str(tmp_path / pkg), verbose=0)
        seen[pkg] = _counters(obs, RECOVERY)
    assert seen["port"] == seen["jax"]
    assert seen["port"][("train_retries_total",)] == 2
    assert seen["port"][("train_emergency_checkpoints",)] == 2


def test_a_first_step_that_always_raises_is_retried_then_reraised(
        runs, tmp_path):
    with tflags_set(telemetry=True, train_retry_backoff=0.0,
                    train_max_retries=3):
        with pytest.warns(UserWarning, match="attempting recovery"), \
                pytest.raises(RuntimeError, match="flaky loss"):
            _tfit(runs["weights"], str(tmp_path),
                  loss=_FlakyLoss(at=1, always=True))
        c = _counters(tobs, RECOVERY)
    assert c[("train_retries_total",)] == 3
    assert c[("train_emergency_checkpoints",)] == 3


def test_a_kernel_error_propagates_untouched(runs, tmp_path):
    def broken(logits, labels):
        raise KernelError("a kernel did not launch")

    with tflags_set(telemetry=True, train_retry_backoff=0.0):
        with pytest.raises(KernelError, match="did not launch"):
            _tfit(runs["weights"], str(tmp_path), loss=broken)
        assert _counters(tobs, RECOVERY) == {}
