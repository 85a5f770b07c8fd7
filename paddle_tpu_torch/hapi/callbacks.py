"""Training callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

A copy of the reference's callbacks, host-side Python. Not ported:
``VisualDL`` (the logger it stands for is not on the card's machine), which
raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from ..optimizer.lr import LRScheduler as _Scheduler


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda logs=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda logs=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    """Prints loss + ips (steps/sec) — the reference's headline trainer log.

    Async-aware: under the dispatch-ahead fit loop the loss arrives only
    every ``metrics_every`` steps and is stale-by-k (``logs["loss_step"]``
    names the step it belongs to); in between, ``logs["loss"]`` is None
    and nothing is printed. The ips figure is computed over wall time
    since train begin, so it reflects true dispatch throughput rather
    than per-step host round-trips."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = None
        self._count = 0
        self._last_print = None

    def on_epoch_begin(self, epoch, logs=None):
        # callback steps restart each epoch; so must the print throttle
        self._last_print = None

    def on_train_batch_begin(self, step, logs=None):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        self._count += 1
        if not self.verbose:
            return
        loss = logs.get("loss") if logs else None
        is_async = bool(logs) and "loss_step" in logs
        # async loop: print when a fresh (stale-by-k) loss lands, but
        # never more often than log_freq (metrics_every=1 syncs every
        # step — that must not mean a print every step); eager loop:
        # keep the classic every-log_freq cadence
        if loss is None:
            return
        if not is_async and step % self.log_freq != 0:
            return
        if is_async and self._last_print is not None \
                and step - self._last_print < self.log_freq:
            return
        self._last_print = step
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        ips = self._count / dt if dt > 0 else 0.0
        at = (f" (@step {logs['loss_step']})"
              if is_async and logs.get("loss_step") != step else "")
        print(f"step {step}: loss {loss:.4f}{at} - {ips:.2f} steps/sec")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and epoch % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        better = (self.best is None or
                  (cur < self.best - self.min_delta if self.mode == "min"
                   else cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._lr, _Scheduler):
            return opt._lr
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Not ported: raises ``NotImplementedError``."""

    def __init__(self, log_dir: str = "./log"):
        raise NotImplementedError(
            "VisualDL is not ported: the logger it writes for is not on "
            "the card's machine")


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=10, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train") -> CallbackList:
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    for c in cbks:
        c.set_model(model)
        c.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                      "metrics": metrics or []})
    return CallbackList(cbks)


class ReduceLROnPlateau(Callback):
    """reference: paddle.callbacks.ReduceLROnPlateau — shrink the lr when
    the monitored metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cooldown_counter = 0

    def _is_better(self, cur):
        if self._best is None:
            return True
        if self.mode == "max" or (self.mode == "auto"
                                  and "acc" in self.monitor):
            return cur > self._best + self.min_delta
        return cur < self._best - self.min_delta

    def on_eval_end(self, logs=None):
        self._step(logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._step(logs or {})

    def _step(self, logs):
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if self._is_better(cur):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                try:
                    lr = opt.get_lr()
                    new = max(lr * self.factor, self.min_lr)
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {lr:.3e} -> {new:.3e}")
                except RuntimeError:
                    pass   # scheduler-driven lr: leave to the scheduler
            self._cooldown_counter = self.cooldown
            self._wait = 0
