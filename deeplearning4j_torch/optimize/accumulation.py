"""Gradient sharing with threshold-encoding compression, on one device
(port of ``deeplearning4j_tpu/optimize/accumulation.py``).

``threshold_encode`` quantises ``g = grad + residual`` to ``sign(g) ·
threshold`` where ``|g| >= threshold`` (else 0) and keeps ``g - message``
as the new residual (error feedback, so the quantised sum converges).
``sparsify``/``unsparsify`` turn a dense message into its wire form
(int32 indices and sign bits) and back, on the host as the JAX package
does. ``EncodingHandler`` carries one worker's residual;
``BasicGradientsAccumulator`` averages the workers' messages of a round.
``parallel/parameter_server.py`` sends the messages to a parameter server
in the JAX package's wire form. The JAX package exchanges no message
between processes (its only user is the parameter server's in-process
push), and neither does the port: across processes the data axis of
``parallel/model_sharding.py`` all-reduces the gradients themselves.
"""

from __future__ import annotations

import numpy as np
import torch


def threshold_encode(grad: torch.Tensor, residual: torch.Tensor,
                     threshold) -> tuple:
    """``(message, new residual)`` for ``grad`` on its device; ``threshold``
    a Python float or a 0-d tensor, compared and multiplied in the
    gradient's dtype."""
    g = grad + residual
    t = torch.as_tensor(threshold, dtype=g.dtype, device=g.device)
    msg = torch.where(g.abs() >= t, torch.sign(g) * t,
                      torch.zeros((), dtype=g.dtype, device=g.device))
    return msg, g - msg


def sparsify(message, threshold: float):
    """Dense quantised message → ``(int32 index array, sign bits)``."""
    if torch.is_tensor(message):
        message = message.detach().cpu().numpy()
    message = np.asarray(message).ravel()
    idx = np.nonzero(message)[0].astype(np.int32)
    return idx, message[idx] > 0


def unsparsify(idx, signs, threshold: float, size: int) -> np.ndarray:
    out = np.zeros(size, np.float32)
    out[idx] = np.where(signs, threshold, -threshold)
    return out


class EncodingHandler:
    """One worker's residual-carrying encoder (a fixed threshold). The
    residual lives on the device of the gradients it is given."""

    def __init__(self, threshold: float = 1e-3):
        self.threshold = threshold
        self._residual = None

    def encode(self, flat_grad):
        g = torch.as_tensor(flat_grad)
        if self._residual is None:
            self._residual = torch.zeros_like(g)
        msg, self._residual = threshold_encode(
            g, self._residual, np.float32(self.threshold).item())
        return msg

    def residual_norm(self) -> float:
        return 0.0 if self._residual is None else \
            float(torch.linalg.vector_norm(self._residual))


class BasicGradientsAccumulator:
    """Each of ``workers`` stores its (encoded, with ``compress``) update;
    ``get_update`` returns their mean and clears the round."""

    def __init__(self, workers: int, threshold: float = 1e-3,
                 compress: bool = True):
        self.workers = workers
        self.compress = compress
        self._handlers = [EncodingHandler(threshold)
                          for _ in range(workers)]
        self._pending: list = []

    def store_update(self, worker: int, flat_grad) -> None:
        if self.compress:
            msg = self._handlers[worker].encode(flat_grad)
        else:
            msg = torch.as_tensor(flat_grad)
        self._pending.append(msg)

    def get_update(self):
        """Mean of the stored updates; clears the round."""
        if not self._pending:
            return None
        out = self._pending[0]
        for m in self._pending[1:]:
            out = out + m
        out = out / float(len(self._pending))
        self._pending = []
        return out
