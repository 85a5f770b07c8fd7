"""The port's training input against the JAX package's, on the CPU: the
native (C++) prefetcher's batch order and the worker-process transport.

- a shuffled ``TensorDataset`` loader of the port gives the reference's
  native batches (order and contents) bit for bit, at two seeds and over
  two epochs, and ``native.shuffled_indices`` / ``gather`` equal the
  reference's;
- ``DataLoader(use_process_workers=True)`` delivers the reference's
  process loader's batches in sampler order; a worker's exception
  re-raises in the parent; ``dataloader_worker`` deaths are restarted
  within ``FLAGS_dataloader_max_worker_restarts`` (counted in
  ``io_worker_restarts``) and raise past it; ``get_worker_info`` is set
  inside a worker;
- a failed build of ``io_core.cpp`` raises and does not fall back; only
  ``PADDLE_TPU_DISABLE_NATIVE=1`` takes the thread path.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import native as jnative
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.testing import faults as tfaults

N_ROWS, BATCH = 23, 4


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1000, (N_ROWS, 5)).astype(np.int64),
            rng.standard_normal((N_ROWS, 3)).astype(np.float32))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("seed", [5, 77])
def test_native_order_matches_jax(seed, drop_last):
    x, y = _arrays()
    paddle.seed(seed)
    jdl = jio.DataLoader(jio.TensorDataset([x, y]), batch_size=BATCH,
                         shuffle=True, drop_last=drop_last)
    tdl = tio.DataLoader(tio.TensorDataset([torch.from_numpy(x),
                                            torch.from_numpy(y)]),
                         batch_size=BATCH, shuffle=True, drop_last=drop_last,
                         seed=seed, num_workers=2)
    for _ in range(2):                                   # two epochs
        jb = [(b[0].numpy(), b[1].numpy()) for b in jdl]
        tb = [(b[0].numpy(), b[1].numpy()) for b in tdl]
        assert len(jb) == len(tb) == len(tdl)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            # (the JAX package narrows int64 to int32 on the way in)
            assert np.array_equal(jx, tx) and tx.dtype == x.dtype
            assert np.array_equal(jy.view(np.int32), ty.view(np.int32))
    assert tdl.transports == ["native", "native"]
    # the order is the native shuffle's at seed + epoch (epochs from 1)
    one = tio.DataLoader(tio.TensorDataset([x]), batch_size=N_ROWS,
                         shuffle=True, seed=seed)
    (first,), = list(one)
    assert np.array_equal(first.numpy(),
                          x[tnative.shuffled_indices(N_ROWS, seed + 1)])


def test_native_functions_match_jax():
    for n, seed in ((1, 0), (17, 5), (1000, 2 ** 40 + 3)):
        assert np.array_equal(tnative.shuffled_indices(n, seed),
                              jnative.shuffled_indices(n, seed))
    src = np.random.default_rng(1).standard_normal((50, 7, 3))
    idx = np.array([49, 0, 3, 3, 17, 8] * 5)
    assert np.array_equal(tnative.gather(src, idx, n_threads=3),
                          jnative.gather(src, idx, n_threads=3))
    pf = tnative.BatchPrefetcher([src], batch_size=8, shuffle=True)
    try:
        got = np.concatenate([b[0] for b in pf.epoch(seed=9)])
    finally:
        pf.close()
    assert np.array_equal(got, src[tnative.shuffled_indices(50, 9)])


def test_cuda_free_tensor_dataset_variants_take_the_native_path():
    """numpy rows and CPU tensors alike; a bf16 tensor (no numpy dtype) and
    a custom collate take the thread path, in the sampler's order."""
    x, _ = _arrays()
    for ds in (tio.TensorDataset([x]),
               tio.TensorDataset([torch.from_numpy(x)])):
        dl = tio.DataLoader(ds, batch_size=BATCH)
        assert np.array_equal(torch.cat([b[0] for b in dl]).numpy(), x)
        assert dl.transports == ["native"]
    bf16 = tio.DataLoader(tio.TensorDataset(
        [torch.ones(6, 2, dtype=torch.bfloat16)]), batch_size=4)
    assert [tuple(b[0].shape) for b in bf16] == [(4, 2), (2, 2)]
    custom = tio.DataLoader(tio.TensorDataset([x]), batch_size=4,
                            collate_fn=lambda b: tio.default_collate_fn(b))
    assert np.array_equal(torch.cat([b[0] for b in custom]).numpy(), x)
    assert bf16.transports == custom.transports == ["thread"]


# --------------------------------------------------------- process workers
class Rows:
    """A deterministic map-style dataset whose __getitem__ is pure Python
    work (GIL-bound) and returns numpy rows and a label."""

    def __init__(self, n=22, fail_at=None):
        self.n = n
        self.fail_at = fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad row {i}")
        acc = 0
        for k in range(200):
            acc = (acc * 31 + i + k) % 1009
        return (np.arange(4, dtype=np.float32) * i + acc,
                np.int64(i % 3))


class WorkerIds:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([i, -1 if info is None else info.id,
                         -1 if info is None else info.num_workers])


def _port_loader(ds, workers=2, **kw):
    return tio.DataLoader(ds, batch_size=3, shuffle=True, seed=77,
                          num_workers=workers, use_process_workers=True, **kw)


def _batches(loader):
    return [(b[0].numpy(), b[1].numpy()) for b in loader]


def test_process_workers_match_jax():
    paddle.seed(77)
    jdl = jio.DataLoader(Rows(), batch_size=3, shuffle=True, num_workers=2,
                         use_process_workers=True)
    tdl = _port_loader(Rows())
    want = [(b[0].numpy(), b[1].numpy()) for b in jdl]
    got = _batches(tdl)
    assert tdl.transports == ["process"]
    assert len(got) == len(want) == len(tdl) == 8
    for (wx, wy), (gx, gy) in zip(want, got):
        assert np.array_equal(wx, gx) and np.array_equal(wy, gy)
    # sampler order: the thread path's batches
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(
        got, _batches(tio.DataLoader(Rows(), batch_size=3, shuffle=True,
                                     seed=77, num_workers=2))))


def test_worker_info_inside_workers():
    assert tio.get_worker_info() is None
    dl = tio.DataLoader(WorkerIds(), batch_size=2, num_workers=3,
                        use_process_workers=True)
    rows = torch.cat(list(dl)).numpy()
    assert rows[:, 0].tolist() == list(range(12))
    assert set(rows[:, 1].tolist()) <= {0, 1, 2}
    assert set(rows[:, 2].tolist()) == {3}
    assert tio.get_worker_info() is None


def test_worker_exception_reraised():
    with pytest.raises(RuntimeError, match="bad row 7") as e:
        list(_port_loader(Rows(fail_at=7)))
    assert "Traceback" in str(e.value)


def _restarts():
    snap = tobs.registry().snapshot()["metrics"]
    series = snap.get("io_worker_restarts", {}).get("series", [])
    return sum(s["value"] for s in series)


def test_worker_deaths_recovered_within_budget():
    clean = _batches(_port_loader(Rows()))
    before = _restarts()
    loader = _port_loader(Rows())
    with tfaults.armed("dataloader_worker:every=3",
                       dataloader_max_worker_restarts=8):
        got = _batches(loader)
    restarts = _restarts() - before
    assert 1 <= restarts <= 2 * 8
    # every replaced worker died of the fault (exit code 3)
    replaced = [e for e in loader.worker_exits if e[2]]
    assert len(replaced) == restarts
    assert all(code == 3 for _, code, _ in replaced)
    assert len(got) == len(clean)
    for (cx, cy), (gx, gy) in zip(clean, got):
        assert np.array_equal(cx, gx) and np.array_equal(cy, gy)


def test_worker_deaths_past_budget_raise():
    with tfaults.armed("dataloader_worker:every=1",
                       dataloader_max_worker_restarts=1):
        with pytest.raises(RuntimeError,
                           match=r"died \d+ times \(budget 2\)"):
            list(_port_loader(Rows(), workers=2))
    assert tflags.get_flag("dataloader_max_worker_restarts") == 2


# ------------------------------------------------------------ the build
def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    bad = tmp_path / "io_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(tnative.NativeCompileError, match="g\\+\\+ failed"):
        tnative.available()
    x, _ = _arrays()
    dl = tio.DataLoader(tio.TensorDataset([x]), batch_size=4, shuffle=True,
                        seed=5)
    with pytest.raises(tnative.NativeCompileError):
        list(dl)
    assert not list((tmp_path / "build").rglob("*.so"))
    # the explicit opt-out: the thread path, the sampler's order
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    assert not tnative.available()
    got = torch.cat([b[0] for b in dl]).numpy()
    want = x[np.random.RandomState(5).permutation(N_ROWS)]
    assert np.array_equal(got, want)
    assert dl.transports == ["thread"]
