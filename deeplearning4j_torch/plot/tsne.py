"""t-SNE embedding (the port of ``deeplearning4j_tpu/plot/tsne.py``;
reference: deeplearning4j-core plot/BarnesHutTsne.java:65 — Barnes-Hut
approximated gradients over an SPTree, theta=0.5).

Like the JAX package, this computes the EXACT O(N^2) gradient: a pair of
[N, N] products per step on the card, for the N <= ~20k regime t-SNE is
used in, with the same knobs (perplexity, theta accepted-but-ignored,
learning rate, momentum schedule, early exaggeration) and the same
``fit / get_y`` surface as the reference. The input similarities P come
from the JAX package's host arithmetic (numpy, float64), so they are
bitwise its; the steps run in f32 on ``device`` (CUDA unless the caller
passes another device).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch import resolve_device


def _hbeta(d_row, beta):
    p = np.exp(-d_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float((d_row * p).sum()) / sum_p
    return h, p / sum_p


def _binary_search_p(d2: np.ndarray, perplexity: float, tol=1e-5,
                     max_tries=50) -> np.ndarray:
    """Per-row precision search for target perplexity (reference:
    BarnesHutTsne.computeGaussianPerplexity)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        idx = np.arange(n) != i
        beta, lo, hi = 1.0, -np.inf, np.inf
        row = d2[i, idx]
        for _ in range(max_tries):
            h, p = _hbeta(row, beta)
            diff = h - target
            if abs(diff) < tol:
                break
            if diff > 0:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        P[i, idx] = p
    return P


def _tsne_step(y, P, gains, inc, momentum: float, lr: float):
    """One exact t-SNE gradient step: Q from pairwise distances, gradient
    4(P-Q)(y_i-y_j)q_ij, with gains + momentum (reference: gradient loop in
    BarnesHutTsne.step)."""
    n = y.shape[0]
    sum_y = torch.sum(y * y, dim=1)
    num = 1.0 / (1.0 + sum_y[:, None] - 2.0 * (y @ y.T) + sum_y[None, :])
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    Q = num / torch.clamp(torch.sum(num), min=1e-12)
    PQ = (P - torch.clamp(Q, min=1e-12)) * num  # [N, N]
    grad = 4.0 * (torch.diag(PQ.sum(dim=1)) - PQ) @ y
    gains = torch.where(torch.sign(grad) != torch.sign(inc),
                        gains + 0.2, gains * 0.8)
    gains = torch.clamp(gains, min=0.01)
    inc = momentum * inc - lr * gains * grad
    y = y + inc
    y = y - torch.mean(y, dim=0)
    kl = torch.sum(P * torch.log(torch.clamp(P, min=1e-12)
                                 / torch.clamp(Q, min=1e-12)))
    return y, gains, inc, kl


class Tsne:
    """reference: plot/BarnesHutTsne.java:65 builder (numDimension,
    perplexity, theta, learningRate, setMaxIter)."""

    def __init__(self, num_dimension: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 max_iter: int = 500, momentum: float = 0.5,
                 final_momentum: float = 0.8, switch_momentum_iter: int = 250,
                 stop_lying_iter: int = 100, exaggeration: float = 12.0,
                 seed: int = 42, device=None):
        self.device = resolve_device(device)
        self.num_dimension = num_dimension
        self.perplexity = perplexity
        self.theta = theta  # accepted for API parity; exact gradient used
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iter = switch_momentum_iter
        self.stop_lying_iter = stop_lying_iter
        self.exaggeration = exaggeration
        self.seed = seed
        self.y: np.ndarray = None
        self.kl: float = float("nan")

    def fit(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        P = _binary_search_p(d2, min(self.perplexity, (n - 1) / 3.0))
        P = (P + P.T) / (2.0 * n)
        P = np.maximum(P / P.sum(), 1e-12)

        rng = np.random.default_rng(self.seed)
        dev = self.device
        y = torch.as_tensor(rng.normal(0, 1e-4, (n, self.num_dimension)),
                            dtype=torch.float32, device=dev)
        gains = torch.ones_like(y)
        inc = torch.zeros_like(y)
        P_dev = torch.as_tensor(P * self.exaggeration, dtype=torch.float32,
                                device=dev)
        P_plain = torch.as_tensor(P, dtype=torch.float32, device=dev)
        kl = torch.tensor(float("inf"))
        with torch.inference_mode():
            for it in range(self.max_iter):
                mom = self.momentum if it < self.switch_momentum_iter \
                    else self.final_momentum
                Pcur = P_dev if it < self.stop_lying_iter else P_plain
                y, gains, inc, kl = _tsne_step(y, Pcur, gains, inc,
                                               float(np.float32(mom)),
                                               float(np.float32(
                                                   self.learning_rate)))
        self.y = y.cpu().numpy()
        self.kl = float(kl)
        return self.y

    def get_y(self) -> np.ndarray:
        return self.y
