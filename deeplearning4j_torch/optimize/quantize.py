"""Post-training int8 weight quantization (port of
``deeplearning4j_tpu/optimize/quantize.py``).

- ``quantize_params(net) -> (qparams, scales)`` rewrites the dense,
  convolution and attention-projection weights (every layer's
  ``QUANT_PARAMS``) to absmax
  per-output-channel int8 (``scale = absmax / 127`` over every axis but
  the last), leaving biases, norms and the rest untouched. The int8 tensor
  and its ``"<name>_scale"`` f32 sibling ride the same params tree.
- Layers key on the sibling's presence: ``DenseLayer.preactivate`` and
  ``SelfAttentionLayer._proj`` compute ``(x @ W_q.to(x.dtype)) * scale``
  (the JAX package leaves the dequant to XLA's matmul epilogue; here the
  widened weight goes to ``torch.matmul``), and the convolutions scale
  their output the same way (``ConvolutionLayer``'s ``W``,
  ``SeparableConvolution2D``'s ``dW`` and ``pW``), so the weights stay
  int8 in memory.
- ``quantize_net(net)`` returns a servable shallow copy whose params are
  quantized; the source net is untouched.

The codes are computed on the host in numpy exactly as the JAX package
computes them (``np.round``, half to even; clip to ±127; all-zero channels
get scale 0), so for the same f32 weights the port's codes and scales are
bitwise the JAX package's; the result then moves to each weight's device.
Quantized outputs are gated on ``confusion_delta`` and ``greedy_agreement``,
not on bit equality. Nothing here imports JAX.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

#: suffix marking a dequant scale riding next to its int8 tensor in the
#: params tree; layers key the dequant path on its presence
SCALE_SUFFIX = "_scale"


def quantize_array(w):
    """Absmax per-output-channel int8 of ``w`` (a tensor or array):
    ``(q, scale)`` as CPU tensors, int8 and f32, the scale reduced over
    every axis but the LAST (the output channel of a ``[in, out]`` dense
    or ``[d_model, d_model]`` projection weight).

    ``q * scale`` reconstructs ``w`` to within half a quantization step per
    channel; all-zero channels get scale 0 and reconstruct as exact zeros.
    A bf16 weight is widened to f32 first (exactly): numpy promotes the JAX
    package's bf16 arrays to f32 in the same two divisions."""
    t = torch.as_tensor(w).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    w = t.numpy()
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) \
        if w.ndim > 1 else np.abs(w)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(w / safe), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


def dequantize_array(q, scale, dtype=np.float32):
    """``q * scale`` as a numpy array (the reference the dequant path
    computes against), for tests and round-trip bounds."""
    q = torch.as_tensor(q).cpu().numpy()
    scale = torch.as_tensor(scale).cpu().numpy()
    return (q.astype(np.float32) * scale).astype(dtype)


def quantize_params(net):
    """Quantize every ``QUANT_PARAMS`` weight of ``net`` (dense ``W``,
    attention ``Wq``/``Wk``/``Wv``/``Wo``; layers opt in by the class
    attribute). Returns ``(qparams, scales)``: ``qparams`` the params tree
    with each quantized weight replaced by its int8 codes plus a
    ``"<name>_scale"`` sibling, both on the weight's device, and ``scales``
    ``{layer_key: {param_name: scale}}`` for inspection. ``net.params`` is
    not changed."""
    qparams = {k: dict(v) if isinstance(v, dict) else v
               for k, v in net.params.items()}
    scales: dict = {}
    for key, layer in net._param_owners().items():
        names = getattr(layer, "QUANT_PARAMS", ())
        lp = qparams.get(key)
        if not names or not isinstance(lp, dict):
            continue
        for pname in names:
            w = lp.get(pname)
            if w is None:
                continue
            q, scale = quantize_array(w)
            dev = w.device if torch.is_tensor(w) else "cpu"
            lp[pname] = q.to(dev)
            lp[pname + SCALE_SUFFIX] = scale.to(dev)
            scales.setdefault(key, {})[pname] = lp[pname + SCALE_SUFFIX]
    return qparams, scales


def quantize_net(net, mode: str = "int8"):
    """A servable copy of ``net`` with int8-quantized weights.

    The copy is shallow: conf, state and updater state are shared; only
    ``params`` is its own. The source net's params are untouched, so its
    outputs stay bit-exact. Inference only: a gradient through int8 codes
    has no meaning."""
    if mode != "int8":
        raise ValueError(f"unsupported quantization mode {mode!r} "
                         "(only 'int8')")
    qparams, _ = quantize_params(net)
    qnet = copy.copy(net)
    qnet.params = qparams
    return qnet


def is_quantized(params: dict) -> bool:
    """Whether a ``{vertex: {name: tensor}}`` params tree carries dequant
    scales (``"<name>_scale"`` siblings)."""
    return any(isinstance(p, dict) and any(k.endswith(SCALE_SUFFIX)
                                           for k in p)
               for p in params.values())


# ------------------------------------------------------- accuracy gates
def confusion_delta(ev_a, ev_b) -> float:
    """Fraction of evaluated examples that changed confusion-matrix cells
    between two evaluations (objects with ``.confusion``, or the matrices
    themselves); 0.0 means identical classifications."""
    cm_a = ev_a.confusion if hasattr(ev_a, "confusion") else ev_a
    cm_b = ev_b.confusion if hasattr(ev_b, "confusion") else ev_b
    cm_a = np.zeros((1, 1), np.int64) if cm_a is None else np.asarray(cm_a)
    cm_b = np.zeros((1, 1), np.int64) if cm_b is None else np.asarray(cm_b)
    if cm_a.shape != cm_b.shape:
        raise ValueError(f"confusion shapes differ: {cm_a.shape} vs "
                         f"{cm_b.shape}")
    n = cm_a.sum()
    if n != cm_b.sum():
        raise ValueError("evaluations cover different example counts: "
                         f"{n} vs {cm_b.sum()}")
    if n == 0:
        return 0.0
    # each moved example leaves one cell and enters another
    return float(np.abs(cm_a - cm_b).sum()) / (2.0 * float(n))


def greedy_agreement(a, b) -> float:
    """Fraction of aligned positions where two greedy completions pick the
    same token (a length mismatch counts the missing tail as
    disagreement)."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    n = min(a.size, b.size)
    hi = max(a.size, b.size)
    if hi == 0:
        return 1.0
    return float(np.count_nonzero(a[:n] == b[:n])) / float(hi)
