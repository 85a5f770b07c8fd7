"""``paddle.Model`` (counterpart of ``paddle_tpu/hapi/model.py``).

``fit`` / ``evaluate`` / ``predict`` over an ``nn.Module``, an optimizer
and a loss, with callbacks. ``fit``'s inner loop is a :class:`TrainStep`
and runs ahead of the card: a step is dispatched without reading its loss,
the loss reaches the callbacks every ``metrics_every`` steps (default
``log_freq``), ``metrics_every`` steps stale, and the only hard barriers
are the epoch ends, where checkpoints and early stopping read exact state.
With ``prefetch_to_device`` a :class:`DevicePrefetcher` stages batch N+1 on
the card while step N runs. ``jit=False`` runs the eager per-step loop
(``train_batch``, one host read a step).

``accumulate_grad_batches`` splits each batch into that many micro-batches
(the TrainStep's ``grad_accum_steps``), as the reference does.
``nan_policy`` decides what a non-finite loss does: ``raise``
(``FloatingPointError``), ``skip`` (a warning) or ``stop`` (a checkpoint
under ``save_dir/emergency`` and a clean stop).

Not ported: the reference's fault recovery (retrying a failed step after an
emergency checkpoint, and falling back to the eager loop when the first
jitted step fails). A step that raises inside ``fit`` raises
``NotImplementedError("fit recovery is not ported")`` chained to the
original error; it neither retries nor swallows it.
``prepare(amp_configs=...)`` (use ``amp.decorate``) raises too.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..io import DataLoader, Dataset, DevicePrefetcher
from ..metric import Metric
from . import callbacks as cb_mod
from .train_step import StagedBatch, TrainStep


def _split(batch):
    """``(inputs, label)`` of a loader batch: the last element is the
    label when there are at least two."""
    if isinstance(batch, (list, tuple)) and len(batch) >= 2:
        *xs, y = batch
        return list(xs), y
    return [batch], None


def _first(labels):
    return labels[0] if isinstance(labels, (list, tuple)) else labels


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _on_device(self, xs):
        dev = self._device
        return [x.to(dev) if isinstance(x, torch.Tensor) else x for x in xs]

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...) is not ported: call "
                "amp.decorate on the network and optimizer first")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(metrics) if metrics else []
        self._train_step = None

    # ----------------------------------------------------------------- train
    def train_batch(self, inputs, labels=None, update=True):
        """One eager step (forward, backward, and with ``update`` the
        optimizer's step); returns ``[loss]`` read on the host."""
        self._train_step = None
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*self._on_device(inputs))
        label = _first(labels)
        loss = self._loss(outputs, self._on_device([label])[0])
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss.detach())]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*self._on_device(inputs))
        label = self._on_device([_first(labels)])[0]
        loss = self._loss(outputs, label)
        for m in self._metrics:
            m.update(m.compute(outputs, label))
        return [float(loss)]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self.network(*self._on_device(inputs))

    def _ensure_train_step(self, metrics_every, accumulate_grad_batches=1):
        accum = max(1, int(accumulate_grad_batches or 1))
        ts = self._train_step
        if ts is not None and ts.grad_accum_steps != accum:
            ts = None
        if ts is None:
            if self._optimizer is None or self._loss is None:
                raise ValueError("Model.fit needs prepare(optimizer, loss)")
            ts = TrainStep(self.network, self._optimizer,
                           loss_fn=self._loss, grad_accum_steps=accum)
        ts.metrics_every = max(0, int(metrics_every))
        self._train_step = ts
        return ts

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, metrics_every=None,
            jit=None, prefetch_to_device=True, use_process_workers=False,
            nan_policy="raise", *, seed: Optional[int] = None):
        """Train over ``train_data`` (a ``Dataset``, loaded with
        ``batch_size``, ``shuffle`` under ``seed``, or any iterable of
        ``(inputs..., label)`` batches) for ``epochs`` epochs or
        ``num_iters`` steps. See the module docstring for the loop."""
        if nan_policy not in ("raise", "skip", "stop"):
            raise ValueError(f"nan_policy must be 'raise', 'skip' or "
                             f"'stop'; got {nan_policy!r}")
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(
                train_data, batch_size=batch_size, shuffle=shuffle,
                drop_last=drop_last, num_workers=num_workers,
                use_process_workers=use_process_workers, seed=seed)
        else:
            train_loader = train_data
        metrics_every = (int(metrics_every) if metrics_every is not None
                         else max(1, log_freq))
        step_obj = (None if jit is False else
                    self._ensure_train_step(metrics_every,
                                            accumulate_grad_batches))
        cbks = cb_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, verbose=verbose,
            log_freq=log_freq, save_dir=save_dir, save_freq=save_freq,
            metrics=["loss"] + [m.name() for m in self._metrics])
        cbks.on_begin("train")
        it = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            logs = {}
            iterator = iter(train_loader)
            if step_obj is not None and prefetch_to_device:
                iterator = iter(DevicePrefetcher(
                    iterator, self._stage_batch, device=self._device))
            # callbacks count steps per epoch, the TrainStep globally
            epoch_base = step_obj._step_count if step_obj is not None else 0
            for step, batch in enumerate(iterator):
                cbks.on_batch_begin("train", step, {})
                try:
                    logs = (self._async_batch(step_obj, batch, step,
                                              epoch_base)
                            if step_obj is not None
                            else self._eager_batch(batch, step))
                except Exception as exc:
                    raise NotImplementedError(
                        "fit recovery is not ported: the step failed "
                        "(cause chained)") from exc
                loss_val = logs.get("loss")
                if loss_val is not None and not np.isfinite(loss_val):
                    self._handle_nan(nan_policy, save_dir, float(loss_val),
                                     where=f"epoch {epoch} step {step}")
                cbks.on_batch_end("train", step, logs)
                it += 1
                if self.stop_training:
                    break
                if num_iters is not None and it >= num_iters:
                    break
            done = self.stop_training or (num_iters is not None
                                          and it >= num_iters)
            if step_obj is not None:
                # the epoch's one hard barrier: the exact loss for
                # early stopping and checkpoints
                logs = dict(logs)
                logs["loss"] = step_obj.sync()
                if logs["loss"] is not None and not np.isfinite(
                        logs["loss"]):
                    self._handle_nan(nan_policy, save_dir,
                                     float(logs["loss"]),
                                     where=f"epoch {epoch} sync")
                m = step_obj.last_metrics
                if m is not None and m["loss_step"] >= epoch_base:
                    logs["loss_step"] = m["loss_step"] - epoch_base
                    logs["staleness"] = m["staleness"]
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size, verbose=0)
            if done or self.stop_training:
                break
        cbks.on_end("train")

    def _handle_nan(self, policy, save_dir, loss, where):
        if policy == "raise":
            raise FloatingPointError(
                f"Model.fit: non-finite loss {loss} at {where} "
                f"(nan_policy='raise'; use 'skip' or 'stop' to tolerate)")
        if policy == "stop":
            warnings.warn(f"Model.fit: non-finite loss {loss} at {where}; "
                          f"nan_policy='stop': checkpoint and stop")
            if save_dir is not None:
                self.save(os.path.join(save_dir, "emergency"))
            self.stop_training = True
        else:
            warnings.warn(f"Model.fit: non-finite loss {loss} at {where}; "
                          f"nan_policy='skip': continuing")

    def _stage_batch(self, batch):
        """A loader batch staged on the card by the TrainStep (batches it
        cannot take pass through unchanged)."""
        ts = self._train_step
        if ts is not None and isinstance(batch, (list, tuple)) \
                and len(batch) >= 2:
            return ts.stage(*batch)
        return batch

    def _async_batch(self, step_obj, batch, step, epoch_base=0):
        """Dispatch one step without reading its loss. The logs carry a
        loss every ``metrics_every`` steps (``loss_step`` in the epoch's
        numbering), None in between."""
        if not isinstance(batch, StagedBatch):
            if not (isinstance(batch, (list, tuple)) and len(batch) >= 2):
                raise NotImplementedError(
                    "the fit loop needs (inputs..., labels) batches")
            batch = self._stage_batch(batch)
        step_obj(batch)
        logs = {"step": step, "loss": None}
        m = step_obj.last_metrics
        if (m is not None and step_obj.metrics_every
                and step_obj._step_count % step_obj.metrics_every == 0
                and m["loss_step"] >= epoch_base):
            logs.update(loss=m["loss"], loss_step=m["loss_step"] - epoch_base,
                        staleness=m["staleness"])
        return logs

    def _eager_batch(self, batch, step):
        xs, y = _split(batch)
        return {"loss": self.train_batch(xs, y)[0], "step": step}

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean loss over ``eval_data`` and each metric's
        ``accumulate()``."""
        loader = (DataLoader(eval_data, batch_size=batch_size,
                             num_workers=num_workers)
                  if isinstance(eval_data, Dataset) else eval_data)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            xs, y = _split(batch)
            losses.append(self.eval_batch(xs, y)[0])
        out = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            name = m.name()
            out[name if isinstance(name, str) else name[0]] = m.accumulate()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = (DataLoader(test_data, batch_size=batch_size,
                             num_workers=num_workers)
                  if isinstance(test_data, Dataset) else test_data)
        outs = []
        for batch in loader:
            xs = batch if isinstance(batch, (list, tuple)) else [batch]
            outs.append(self.predict_batch(xs))
        return outs

    # ------------------------------------------------------------ state mgmt
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, with ``training``,
        ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load
        self.network.load_state_dict(load(path + ".pdparams"))
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """Print and return the network's parameter counts:
        ``{"total_params", "trainable_params"}`` (trainable: parameters
        that require gradients)."""
        params = list(self.network.parameters())
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        print(f"Total params: {total:,}\nTrainable params: {trainable:,}")
        return {"total_params": total, "trainable_params": trainable}
