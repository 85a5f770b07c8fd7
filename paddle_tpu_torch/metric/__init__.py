"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``): host-side
numpy over the predictions and labels, which are read back from the
card once a call."""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _trapezoid(y, x):
    return float((np.trapezoid if hasattr(np, "trapezoid") else np.trapz)(
        y, x))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        top = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        correct = (top == label_np[..., None])
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        for i, k in enumerate(self.topk):
            num = c[..., :k].sum()
            self.total[i] += float(num)
            self.count[i] += int(np.prod(c.shape[:-1]))
        acc = self.total[0] / max(self.count[0], 1)
        return acc

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0, self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds, descending
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        return _trapezoid(tpr, fpr)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    pred_np = _np(input)
    label_np = _np(label)
    if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
        label_np = label_np.squeeze(-1)
    top = np.argsort(-pred_np, axis=-1)[..., :k]
    c = (top == label_np[..., None]).any(axis=-1)
    return torch.tensor(float(c.mean()), dtype=torch.float32)
