"""The port's one-card training stack above the step against the JAX
package's, on the CPU, with a tiny GQA Llama (2 layers) built by the JAX
package from a seed and carried into the port through ``raw_state()``.

Tolerances (fp32; JAX at ``jax_default_matmul_precision=highest``): 1e-5
on losses, logits and parameters, since both sides sum in f32 in another
order (the port's attention runs the flash kernels' plain versions, JAX's
its dense or Pallas route); 1e-4 on the parameters after ``fit``'s five
AdamW updates (each ~ g / |g| elementwise, which amplifies last-bit
gradient differences). Checked:
  - the Llama forward with a padding ``attn_mask`` (SDPA's dense path) and
    ``LlamaPretrainingCriterion``;
  - ``TrainStep(remat=True)``: gradients equal the port's without remat
    bit for bit, and three steps match JAX's remat step;
  - ``gradient_merge_k=2`` over four calls, averaged and summed;
  - ``metrics_every`` / ``pull_metrics(lag)``: the same loss steps and
    staleness as JAX's, losses within 1e-5;
  - a JAX ``TrainStep.state_dict()`` (parameters, ``@opt_state`` and the
    scheduler) resumed in the port through
    ``convert.optimizer_state_from_jax``: the next steps match;
  - ``RandomSampler`` / ``DataLoader`` batch order equal to JAX's for the
    same seed (exactly), on the thread path (``use_shared_memory=False``
    on both sides; the native path's order is
    ``tests/test_torch_io_workers.py``'s). The JAX loaders here run
    without their buffer-reader thread: the reference's global seed is
    thread-local, so a sampler iterated on that thread draws with seed 0
    whatever ``paddle.seed`` said. ``fit`` over a shuffled
    ``TensorDataset`` takes the native path in both packages;
  - ``Model.fit`` with ``accumulate_grad_batches``, ``metrics_every``,
    prefetch and callbacks: the losses JAX's ``fit`` logs, then
    ``evaluate``; ``nan_policy`` (fit recovery is
    ``tests/test_torch_fit_recovery.py``'s); ``VisualDL``'s
    ``scalars.jsonl`` rows and ``Model.summary``'s counts;
    ``ModelCheckpoint`` files loading back, also a JAX-written file.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi.callbacks as jcb
import paddle_tpu.io as jio
from paddle_tpu.framework.io import load as jload
from paddle_tpu.framework.io import save as jsave
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.convert import optimizer_state_from_jax
from paddle_tpu_torch.framework import load, save
from paddle_tpu_torch.hapi import Model, TrainStep
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.optimizer import lr as tlr

TOL = 1e-5
ADAM_PARAM_TOL = 1e-4
LR = 1e-2


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _pair(seed):
    paddle.seed(seed)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _batches(n, b=4, s=16, vocab=256, seed=0):
    rng = np.random.default_rng(seed + n)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _jopt(jmodel, steps=10, cls="AdamW"):
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=steps), 2,
                             LR / 10, LR)
    return getattr(paddle.optimizer, cls)(
        sched, parameters=jmodel.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def _topt(model, steps=10, cls="AdamW"):
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR, T_max=steps), 2,
                             LR / 10, LR)
    return getattr(topt_mod, cls)(
        sched, parameters=model.named_parameters(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(1.0))


def _jt(x):
    return paddle.to_tensor(np.asarray(x).astype(np.int32))


def _params_match(jmodel, model, tol=TOL):
    jp = {k: np.asarray(v) for k, v in jmodel.raw_state()[0].items()}
    tp = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert _max_err(tp[k], jp[k]) <= tol, k


# ------------------------------------------------------- model, criterion
def _padding_mask(b, s, lens):
    keep = np.tril(np.ones((s, s), bool))[None, None].repeat(b, 0)
    for i, n in enumerate(lens):
        keep[i, :, :, n:] = False
        keep[i, :, n:, :] = np.eye(s, dtype=bool)[n:]   # pads see themselves
    return keep


def test_llama_forward_with_padding_mask_matches_jax():
    jmodel, model = _pair(31)
    (x, _), = _batches(1, b=3, s=12)
    mask = _padding_mask(3, 12, (12, 7, 3))
    want = jmodel(_jt(x), attn_mask=paddle.to_tensor(mask)).numpy()
    got = model(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    assert _max_err(got.detach().numpy(), want) <= TOL
    # the mask replaces the causal one: a full causal mask is the default
    causal = _padding_mask(3, 12, (12, 12, 12))
    assert _max_err(model(torch.from_numpy(x),
                          attn_mask=torch.from_numpy(causal)).detach(),
                    model(torch.from_numpy(x)).detach()) <= TOL


def test_criterion_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 256)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 5))
    labels[0, 1] = -100
    want = float(JCriterion(JLlamaConfig.tiny())(
        paddle.to_tensor(logits), paddle.to_tensor(labels)))
    got = float(LlamaPretrainingCriterion(LlamaConfig.tiny())(
        torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= TOL


# ---------------------------------------------------------------- TrainStep
def test_remat_gives_the_same_gradients_and_matches_jax():
    jmodel, model = _pair(32)
    batches = _batches(3)
    x, y = (torch.from_numpy(t) for t in batches[0])
    plain = TrainStep(model, _topt(model), grad_accum_steps=2)
    _, g_plain = plain.compute_loss_grads(x, y)
    g_plain = {k: g.clone() for k, g in g_plain.items()}
    step = TrainStep(model, _topt(model), grad_accum_steps=2, remat=True)
    _, g_remat = step.compute_loss_grads(x, y)
    assert sorted(g_plain) == sorted(g_remat)
    for k in g_plain:
        assert torch.equal(g_plain[k], g_remat[k]), k
    assert not model.llama.remat          # switched on only inside a step
    jstep = JTrainStep(jmodel, _jopt(jmodel), grad_accum_steps=2, remat=True)
    for xb, yb in batches:
        jl = float(jstep(_jt(xb), _jt(yb)))
        tl = float(step(torch.from_numpy(xb), torch.from_numpy(yb)))
        assert abs(tl - jl) <= TOL
    jstep.sync_to_model()
    _params_match(jmodel, model)
    with pytest.raises(NotImplementedError, match="remat"):
        TrainStep(torch.nn.Linear(2, 2), _topt(model), remat=True)


@pytest.mark.parametrize("avg", [True, False], ids=["avg", "sum"])
def test_gradient_merge_matches_jax(avg):
    """Momentum, whose update is linear in the merged gradient: Adam's
    first update is ~ g / |g| elementwise, where a merged g1 + g2 that
    nearly cancels turns last-bit differences of the two sums into
    updates of up to the learning rate."""
    jmodel, model = _pair(33)
    jstep = JTrainStep(jmodel, _jopt(jmodel, cls="Momentum"),
                       gradient_merge_k=2, gradient_merge_avg=avg)
    opt = _topt(model, cls="Momentum")
    step = TrainStep(model, opt, gradient_merge_k=2, gradient_merge_avg=avg)
    for i, (x, y) in enumerate(_batches(4)):
        jl = float(jstep(_jt(x), _jt(y)))
        tl = float(step(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(tl - jl) <= TOL
        assert opt.state_dict()["@step"] == (i + 1) // 2
    jstep.sync_to_model()
    _params_match(jmodel, model)


def test_pull_metrics_lag_matches_jax():
    jmodel, model = _pair(34)
    jstep = JTrainStep(jmodel, _jopt(jmodel), metrics_every=2)
    step = TrainStep(model, _topt(model), metrics_every=2)
    for x, y in _batches(5):
        jstep(_jt(x), _jt(y))
        step(torch.from_numpy(x), torch.from_numpy(y))
        jm, tm = jstep.last_metrics, step.last_metrics
        assert (jm is None) == (tm is None)
        if jm is not None:
            assert (tm["loss_step"], tm["staleness"]) == (
                jm["loss_step"], jm["staleness"])
            assert abs(tm["loss"] - jm["loss"]) <= TOL
    for lag in (0, 3):
        jm, tm = jstep.pull_metrics(lag), step.pull_metrics(lag)
        assert (tm["loss_step"], tm["staleness"]) == (
            jm["loss_step"], jm["staleness"])
    assert abs(step.sync() - jstep.sync()) <= TOL
    assert step.sync_count == jstep.sync_count


def test_jax_state_dict_resumes_in_the_port():
    jmodel, model = _pair(35)
    jopt = _jopt(jmodel)
    jstep = JTrainStep(jmodel, jopt)
    batches = _batches(4)
    for x, y in batches[:2]:
        jstep(_jt(x), _jt(y))
    sd = jstep.state_dict()
    jax_opt = sd.pop("@opt_state")
    topt = _topt(model)
    step = TrainStep(model, topt)
    state = {k: torch.from_numpy(np.array(v.numpy())) for k, v in sd.items()}
    state["@opt_state"] = optimizer_state_from_jax(
        jax_opt, lr_state=jopt._lr.state_dict())
    step.set_state_dict(state)
    assert topt.state_dict()["@step"] == 2 and topt.get_lr() == jopt.get_lr()
    for x, y in batches[2:]:
        jl = float(jstep(_jt(x), _jt(y)))
        tl = float(step(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(tl - jl) <= TOL
    jstep.sync_to_model()
    _params_match(jmodel, model)


def test_stage_and_staged_batch():
    _, model = _pair(36)
    step = TrainStep(model, _topt(model))
    (x, y), = _batches(1)
    staged = step.stage(torch.from_numpy(x), torch.from_numpy(y))
    assert all(t.device == torch.device("cpu") for t in staged.vals)
    assert np.isfinite(float(step(staged)))


# ----------------------------------------------------------------- io
def _dataset(n=10, s=16, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (n, s + 1))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


@pytest.mark.parametrize("drop_last", [False, True])
def test_random_order_matches_jax(drop_last):
    x, y = _dataset(11)
    paddle.seed(77)
    jdl = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=3,
                         shuffle=True, drop_last=drop_last,
                         use_shared_memory=False, use_buffer_reader=False)
    tdl = tio.DataLoader(tio.TensorDataset([torch.from_numpy(x),
                                            torch.from_numpy(y)]),
                         batch_size=3, shuffle=True, drop_last=drop_last,
                         seed=77, num_workers=2, use_shared_memory=False)
    for _ in range(2):                                   # two epochs
        jb = [b[0].numpy() for b in jdl]
        tb = [b[0].numpy() for b in tdl]
        assert len(jb) == len(tb) == len(tdl)
        for a, b in zip(jb, tb):
            assert np.array_equal(a, b)
    js = jio.RandomSampler(list(range(9)))
    ts = tio.RandomSampler(list(range(9)), seed=77)
    assert list(js) == list(ts) and list(js) == list(ts)
    with pytest.raises(ValueError, match="seed"):
        tio.DataLoader(tio.TensorDataset([x]), shuffle=True)


def test_collate_and_device_prefetcher_on_the_cpu():
    x, y = _dataset(5)
    ds = tio.TensorDataset([x, y])                         # numpy rows
    batches = list(tio.DevicePrefetcher(tio.DataLoader(ds, batch_size=2),
                                        device="cpu"))
    assert [tuple(b[0].shape) for b in batches] == [(2, 16)] * 2 + [(1, 16)]
    assert all(isinstance(t, torch.Tensor) for b in batches for t in b)
    assert np.array_equal(batches[1][1].numpy(), y[2:4])
    dicts = tio.default_collate_fn([{"a": 1, "b": np.ones(2)}] * 3)
    assert dicts["a"].tolist() == [1, 1, 1] and dicts["b"].shape == (3, 2)


# -------------------------------------------------------------- Model.fit
class _JRecord(jcb.Callback):
    def __init__(self):
        super().__init__()
        self.logs = []

    def on_train_batch_end(self, step, logs=None):
        self.logs.append(dict(logs))


class _TRecord(tcb.Callback):
    def __init__(self):
        super().__init__()
        self.logs = []

    def on_train_batch_end(self, step, logs=None):
        self.logs.append(dict(logs))


def _fit_pair(seed, tmp_path, jcallbacks=(), tcallbacks=(), **fit_kw):
    jmodel, model = _pair(seed)
    x, y = _dataset(12)
    paddle.seed(5)
    jloader = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                             shuffle=True, use_buffer_reader=False)
    jm = JModel(jmodel)
    jm.prepare(_jopt(jmodel), loss=JCriterion(JLlamaConfig.tiny()))
    jrec = _JRecord()
    jm.fit(jloader, verbose=0, callbacks=[jrec, *jcallbacks], **fit_kw)
    tm = Model(model)
    tm.prepare(_topt(model), loss=LlamaPretrainingCriterion(
        LlamaConfig.tiny()))
    trec = _TRecord()
    tm.fit(tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]),
           batch_size=4, seed=5, verbose=0, save_dir=str(tmp_path),
           callbacks=[trec, tcb.LRScheduler(by_step=False),
                      tcb.EarlyStopping(patience=5), *tcallbacks], **fit_kw)
    return jm, jmodel, jrec, tm, model, trec


def test_fit_matches_jax_and_evaluates(tmp_path):
    jm, jmodel, jrec, tm, model, trec = _fit_pair(
        37, tmp_path, epochs=2, accumulate_grad_batches=2, metrics_every=2,
        num_iters=5)
    assert len(trec.logs) == len(jrec.logs) == 5
    for t, j in zip(trec.logs, jrec.logs):
        assert (t["loss"] is None) == (j["loss"] is None)
        if j["loss"] is not None:
            assert abs(t["loss"] - j["loss"]) <= TOL
            assert (t["loss_step"], t["staleness"]) == (
                j["loss_step"], j["staleness"])
    # five AdamW updates, each ~ g / |g| elementwise: last-bit gradient
    # differences reach the parameters amplified (the losses hold 1e-5)
    _params_match(jmodel, model, tol=ADAM_PARAM_TOL)
    x, y = _dataset(6, seed=8)
    want = jm.evaluate(jio.TensorDataset([x, y]), batch_size=3, verbose=0)
    got = tm.evaluate(tio.TensorDataset([torch.from_numpy(x),
                                         torch.from_numpy(y)]), batch_size=3)
    assert abs(got["loss"] - want["loss"]) <= TOL
    # ModelCheckpoint (save_dir): the epoch and final files load back
    fresh = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    Model(fresh).load(str(tmp_path / "final"))
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    opt_state = load(str(tmp_path / "final.pdopt"))
    assert opt_state["@step"] == 5
    assert (tmp_path / "0.pdparams").exists()
    out = tm.predict([(torch.from_numpy(x[:2]),)])
    assert out[0].shape == (2, 16, 256)


def test_fit_eager_loop_matches_the_async_one(tmp_path):
    _, a = _pair(38)
    _, b = _pair(38)
    x, y = _dataset(8)
    ds = tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    recs = []
    for model, jit in ((a, None), (b, False)):
        m = Model(model)
        m.prepare(_topt(model), loss=LlamaPretrainingCriterion(
            LlamaConfig.tiny()))
        rec = _TRecord()
        m.fit(ds, batch_size=4, seed=1, verbose=0, metrics_every=1, jit=jit,
              callbacks=[rec])
        recs.append([r["loss"] for r in rec.logs])
    assert _max_err(recs[0], recs[1]) <= TOL


class _NanLoss(torch.nn.Module):
    """The criterion, but NaN from its ``at``-th call on."""

    def __init__(self, at):
        super().__init__()
        self.calls, self.at = 0, at
        self.ce = LlamaPretrainingCriterion(LlamaConfig.tiny())

    def forward(self, logits, labels):
        self.calls += 1
        loss = self.ce(logits, labels)
        return loss * float("nan") if self.calls >= self.at else loss


@pytest.mark.parametrize("policy", ["raise", "skip", "stop"])
def test_fit_nan_policy(policy, tmp_path):
    _, model = _pair(39)
    x, y = _dataset(12)
    ds = tio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    m = Model(model)
    m.prepare(_topt(model), loss=_NanLoss(at=2))
    rec = _TRecord()
    kw = dict(batch_size=4, seed=1, verbose=0, metrics_every=1,
              callbacks=[rec], save_dir=str(tmp_path), epochs=2)
    if policy == "raise":
        with pytest.raises(FloatingPointError):
            m.fit(ds, nan_policy=policy, **kw)
        return
    with pytest.warns(UserWarning, match=policy):
        m.fit(ds, nan_policy=policy, **kw)
    if policy == "skip":
        assert len(rec.logs) == 6
    else:
        assert len(rec.logs) == 2 and m.stop_training
        assert (tmp_path / "emergency.pdparams").exists()


def test_visualdl_scalars_match_jax(tmp_path):
    jlog, tlog = tmp_path / "jax", tmp_path / "port"
    _fit_pair(39, tmp_path / "ckpt", epochs=1, metrics_every=2,
              num_iters=3, jcallbacks=[jcb.VisualDL(str(jlog))],
              tcallbacks=[tcb.VisualDL(str(tlog))])
    jrows = [json.loads(r) for r in
             (jlog / "scalars.jsonl").read_text().splitlines()]
    trows = [json.loads(r) for r in
             (tlog / "scalars.jsonl").read_text().splitlines()]
    assert len(trows) == len(jrows) > 0
    for t, j in zip(trows, jrows):
        assert sorted(t) == sorted(j)
        for k in j:
            if k == "loss":
                assert abs(t[k] - j[k]) <= TOL
            else:
                assert t[k] == j[k], k


def test_summary_matches_jax(tmp_path):
    jm, _, _, tm, model, _ = _fit_pair(40, tmp_path, epochs=1, num_iters=1)
    assert tm.summary() == jm.summary()
    model.llama.norm.weight.requires_grad_(False)
    got = tm.summary()
    assert got["total_params"] == jm.summary()["total_params"]
    assert got["trainable_params"] == (got["total_params"]
                                       - model.llama.norm.weight.numel())


def test_load_reads_a_jax_written_checkpoint(tmp_path):
    jmodel, _ = _pair(41)
    jsave(jmodel.state_dict(), str(tmp_path / "j.pdparams"))
    got = load(str(tmp_path / "j.pdparams"))
    for k, v in jmodel.state_dict().items():
        assert np.array_equal(got[k].numpy(), np.asarray(v.numpy())), k
    save({"w": torch.ones(2, dtype=torch.bfloat16), "n": [1, 2]},
         str(tmp_path / "t.pd"))
    back = load(str(tmp_path / "t.pd"))
    assert back["w"].dtype == torch.bfloat16 and back["n"] == [1, 2]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_jax_load_reads_a_port_written_checkpoint(tmp_path, dtype):
    """A port-written file is the JAX package's format: its ``load`` gives
    the same values (bf16 as bf16), a parameter as a Parameter, and nested
    containers as they were; the port reads the file back too."""
    g = torch.Generator().manual_seed(3)
    w = torch.nn.Parameter(torch.randn(5, 7, generator=g).to(dtype))
    obj = {"w": w, "m": [torch.randn(3, generator=g).to(dtype), 4],
           "step": 2}
    path = str(tmp_path / "port.pdparams")
    save(obj, path)
    got = jload(path)
    assert isinstance(got["w"], paddle.Parameter)
    assert got["m"][1] == 4 and got["step"] == 2
    for j, t in ((got["w"], w), (got["m"][0], obj["m"][0])):
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(
            np.asarray(j.astype("float32").numpy()),
            t.detach().float().numpy())
    back = load(path)
    assert torch.equal(back["w"], w.detach()) and back["m"][1] == 4
    assert back["w"].dtype == dtype
