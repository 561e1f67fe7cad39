"""Basic one-hidden-layer neural network classifier, the port of
`avenir_tpu/models/neural.py`.

The reference (python/supv/basic_nn.py, SURVEY §2.10) is a numpy
two-layer net: tanh hidden layer, softmax output, cross-entropy loss with
L2 decay, trained by full-batch ("batch") or per-sample ("stochastic")
gradient descent on moons data. The JAX package scans its steps with
`jax.grad`; here the net is an `nn.Module` with the parameters `w1`,
`b1`, `w2` and `b2` (the reference's pytree keys and layouts, so that
`models/convert.neural_params_from_jax` carries a JAX net over), and each
step is one `torch.autograd` gradient and an update, in a Python loop.

The initial weights are the reference's draws: `jax.random.key(seed)`
split into (k1, k2), each a `jax.random.normal` matrix from the port's
copy of threefry (`ops/prng.normal`, within the log1p's rounding of
JAX's) divided by float32 sqrt(n_in) or sqrt(n_hidden). The minibatch
rows are numpy's `default_rng(seed).integers(0, n, (iterations, bs))`,
as the reference draws them. The moons generator is the reference's
numpy copy. Runs on the card unless `device="cpu"`; predictions come
back as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from avenir_tpu_torch.ops import prng
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

F32 = np.float32


def make_moons(n: int, noise: float = 0.2, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Two interleaving half circles (sklearn.datasets.make_moons analog,
    basic_nn.py:46)."""
    rng = np.random.default_rng(seed)
    n_out = n // 2
    n_in = n - n_out
    t_out = np.pi * rng.random(n_out)
    t_in = np.pi * rng.random(n_in)
    x = np.concatenate([
        np.stack([np.cos(t_out), np.sin(t_out)], axis=1),
        np.stack([1.0 - np.cos(t_in), 0.5 - np.sin(t_in)], axis=1),
    ])
    y = np.concatenate([np.zeros(n_out, np.int64), np.ones(n_in, np.int64)])
    x += rng.normal(0.0, noise, x.shape)
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


class TwoLayerNet(nn.Module):
    """tanh(x @ w1 + b1) @ w2 + b2: the reference's params as a module."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2

    def arrays(self) -> dict:
        """The parameters as float32 numpy arrays, by the reference's keys."""
        return {k: p.detach().cpu().numpy()
                for k, p in self.named_parameters()}


def _init_params(key, n_in: int, n_hidden: int, n_out: int,
                 device: torch.device) -> TwoLayerNet:
    """The reference's initial net: normal weights over float32 sqrt of
    the fan-in, zero biases."""
    k1, k2 = prng.split(key)
    return TwoLayerNet(
        prng.normal(k1, (n_in, n_hidden), device) / float(np.sqrt(F32(n_in))),
        torch.zeros(n_hidden, device=device),
        prng.normal(k2, (n_hidden, n_out), device)
        / float(np.sqrt(F32(n_hidden))),
        torch.zeros(n_out, device=device))


def _loss(net: TwoLayerNet, x: torch.Tensor, y: torch.Tensor,
          reg: float) -> torch.Tensor:
    logp = torch.log_softmax(net(x), dim=1)
    nll = -torch.mean(torch.gather(logp, 1, y[:, None]))
    l2 = torch.sum(net.w1 * net.w1) + torch.sum(net.w2 * net.w2)
    return nll + reg * l2


def _step(net: TwoLayerNet, x: torch.Tensor, y: torch.Tensor, lr: float,
          reg: float) -> None:
    params = list(net.parameters())
    grads = torch.autograd.grad(_loss(net, x, y, reg), params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)


def _train_batch(net: TwoLayerNet, x: torch.Tensor, y: torch.Tensor,
                 lr: float, epochs: int, reg: float) -> TwoLayerNet:
    """`epochs` full-batch gradient steps on (x, y), in place."""
    for _ in range(epochs):
        _step(net, x, y, lr, reg)
    return net


def _train_minibatch(net: TwoLayerNet, xb: torch.Tensor, yb: torch.Tensor,
                     lr: float, reg: float) -> TwoLayerNet:
    """One gradient step a batch, xb [steps, B, D] and yb [steps, B], in
    place."""
    for x, y in zip(xb, yb):
        _step(net, x, y, lr, reg)
    return net


@dataclass
class BasicNeuralNetwork:
    """1-hidden-layer tanh classifier (basic_nn.py surface: hidden size,
    iteration count, learning rate epsilon, training mode batch/stochastic).
    Runs on the card unless `device="cpu"`."""

    n_hidden: int = 8
    n_classes: int = 2
    learning_rate: float = 0.01
    iterations: int = 1000
    reg: float = 0.0001
    training_mode: str = "batch"        # batch / stochastic / minibatch
    batch_size: int = 32
    seed: int = 0
    device: DeviceLike = None

    params: Optional[TwoLayerNet] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            init: Optional[TwoLayerNet] = None) -> "BasicNeuralNetwork":
        """Train from the seed's initial net, or from `init` (trained in
        place) where one is given."""
        dev = resolve_device(self.device)
        xt = torch.as_tensor(np.asarray(x, F32), device=dev)
        yt = torch.as_tensor(np.asarray(y).astype(np.int64), device=dev)
        net = init if init is not None else _init_params(
            prng.PRNGKey(self.seed), xt.shape[1], self.n_hidden,
            self.n_classes, dev)
        lr = float(F32(self.learning_rate))
        if self.training_mode == "batch":
            net = _train_batch(net, xt, yt, lr, self.iterations, self.reg)
        else:
            n = xt.shape[0]
            bs = 1 if self.training_mode == "stochastic" else min(
                self.batch_size, n)
            rng = np.random.default_rng(self.seed)
            # exactly `iterations` gradient steps, one sampled batch each
            order = torch.as_tensor(rng.integers(0, n, (self.iterations, bs)),
                                    device=dev)
            net = _train_minibatch(net, xt[order], yt[order], lr, self.reg)
        self.params = net
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("model not fitted")
        dev = resolve_device(self.device)
        with torch.no_grad():
            logits = self.params(torch.as_tensor(np.asarray(x, F32),
                                                 device=dev))
            return torch.softmax(logits, dim=1).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self.predict_proba(x).argmax(axis=1))

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))
