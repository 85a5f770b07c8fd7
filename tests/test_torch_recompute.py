"""``fleet.utils.recompute`` against the JAX package's, on the CPU.

The cases of ``tests/test_recompute.py`` on the port: a Block under
recompute equals the same Block without it and the JAX package's
recompute on the same weights (loss and every gradient within 1e-6, fp32);
the dropout path runs and gives every parameter a gradient; non-tensor
positional arguments stay Python values; a trainable tensor keyword
raises ``TypeError``; a nested return comes back in its structure with
gradients flowing; a plain function. Plus the replay: the port's dropout
draws from an explicit generator, and a recomputed Block with dropout
gives the gradients of the plain Block bit for bit on the same generator
seed (the recompute saw the first forward's mask); the generator ends
where the plain run leaves it.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import Dropout, Linear

TOL = 1e-6
H = 8


class Block(nn.Module):
    def __init__(self, h, dropout=0.0, generator=None):
        super().__init__()
        self.fc1 = Linear(h, 2 * h, device="cpu")
        self.fc2 = Linear(2 * h, h, device="cpu")
        self.drop = Dropout(dropout, generator=generator)

    def forward(self, x):
        return self.fc2(self.drop(F.gelu(self.fc1(x))))


class JBlock(jnn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc1 = jnn.Linear(h, 2 * h)
        self.fc2 = jnn.Linear(2 * h, h)

    def forward(self, x):
        return self.fc2(JF.gelu(self.fc1(x)))


def _weights():
    rng = np.random.default_rng(0)
    return {"fc1.weight": rng.standard_normal((H, 2 * H)) * 0.3,
            "fc1.bias": rng.standard_normal(2 * H) * 0.1,
            "fc2.weight": rng.standard_normal((2 * H, H)) * 0.3,
            "fc2.bias": rng.standard_normal(H) * 0.1}


X = np.random.default_rng(1).standard_normal((4, H)).astype(np.float32)


def _port(with_recompute, dropout=0.0, gen_seed=None):
    gen = None if gen_seed is None else seed(gen_seed, "cpu")
    net = Block(H, dropout, gen)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(torch.from_numpy(_weights()[k].astype(np.float32)))
    x = torch.from_numpy(X).requires_grad_(True)
    out = recompute(net, x) if with_recompute else net(x)
    loss = (out * out).mean()
    loss.backward()
    return (float(loss.detach()), {k: p.grad.numpy() for k, p in
                          net.named_parameters()}, x.grad.numpy(), gen)


def _jax():
    net = JBlock(H)
    net.load_raw_state({k: jnp.asarray(v, jnp.float32)
                        for k, v in _weights().items()})
    x = paddle.to_tensor(X, stop_gradient=False)
    out = jrecompute(net, x)
    loss = (out * out).mean()
    loss.backward()
    return (float(loss), {k: np.asarray(p.grad.numpy())
                          for k, p in net.named_parameters()},
            np.asarray(x.grad.numpy()))


def test_matches_no_recompute_and_jax():
    loss_a, grads_a, xg_a, _ = _port(False)
    loss_b, grads_b, xg_b, _ = _port(True)
    loss_j, grads_j, xg_j = _jax()
    assert loss_a == loss_b and abs(loss_b - loss_j) <= TOL
    assert set(grads_b) == set(grads_j)
    for k in grads_b:
        np.testing.assert_array_equal(grads_a[k], grads_b[k])
        np.testing.assert_allclose(grads_b[k], grads_j[k], atol=TOL,
                                   rtol=TOL, err_msg=k)
    np.testing.assert_array_equal(xg_a, xg_b)
    np.testing.assert_allclose(xg_b, xg_j, atol=TOL, rtol=TOL)


def test_dropout_path_runs():
    net = Block(H, 0.5, seed(1, "cpu"))
    net.train()
    x = torch.from_numpy(X).requires_grad_(True)
    loss = recompute(net, x).mean()
    loss.backward()
    assert np.isfinite(float(loss))
    assert all(p.grad is not None for p in net.parameters())


def test_dropout_replays_the_generator():
    """The recompute must redraw the first forward's mask from the
    module's generator: gradients equal the plain run's bit for bit."""
    plain = _port(False, dropout=0.5, gen_seed=5)
    again = _port(True, dropout=0.5, gen_seed=5)
    assert plain[0] == again[0]
    for k in plain[1]:
        np.testing.assert_array_equal(plain[1][k], again[1][k])
    np.testing.assert_array_equal(plain[2], again[2])
    # and the generator stands where the plain run left it
    assert torch.equal(plain[3].get_state(), again[3].get_state())
    # a different seed draws another mask (the check can fail)
    other = _port(False, dropout=0.5, gen_seed=6)
    assert not np.array_equal(other[2], plain[2])


def test_non_tensor_args_stay_static():
    class Flagged(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(H, H, device="cpu")

        def forward(self, x, double, mask=None):
            h = self.fc(x)
            if double:
                h = h * 2
            if mask is not None:
                h = h + mask
            return h

    net = Flagged()
    x = torch.from_numpy(X).requires_grad_(True)
    out = recompute(net, x, True)
    torch.testing.assert_close(out, net(x, True), rtol=0, atol=0)
    out.mean().backward()
    assert all(p.grad is not None for p in net.parameters())


def test_trainable_tensor_kwarg_rejected():
    x = torch.ones(2, H)
    bias = torch.ones(2, H, requires_grad=True)
    with pytest.raises(TypeError, match="positionally"):
        recompute(lambda t, mask=None: t + mask, x, mask=bias)


def test_pytree_return():
    class Pair(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(H, H, device="cpu")

        def forward(self, x):
            h = self.fc(x)
            return {"hidden": h, "aux": (h * 2, h.sum())}

    net = Pair()
    x = torch.from_numpy(X).requires_grad_(True)
    out = recompute(net, x)
    assert set(out) == {"hidden", "aux"}
    ref = net(x)
    torch.testing.assert_close(out["hidden"], ref["hidden"])
    torch.testing.assert_close(out["aux"][0], ref["aux"][0])
    (out["hidden"].mean() + out["aux"][1]).backward()
    assert all(p.grad is not None for p in net.parameters())
    assert x.grad is not None


def test_bound_method_parameters_get_gradients():
    net = Block(H)
    x = torch.from_numpy(X).requires_grad_(True)
    recompute(net.forward, x).sum().backward()
    assert all(p.grad is not None for p in net.parameters())


def test_plain_function():
    x = torch.ones(3, 3, requires_grad=True)
    recompute(lambda t: (t * 3).sum(), x).backward()
    np.testing.assert_array_equal(x.grad.numpy(), 3 * np.ones((3, 3)))
    jx = paddle.to_tensor(np.ones((3, 3), np.float32), stop_gradient=False)
    jrecompute(lambda t: (t * 3).sum(), jx).backward()
    np.testing.assert_array_equal(x.grad.numpy(), jx.grad.numpy())
