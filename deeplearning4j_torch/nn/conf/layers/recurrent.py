"""Recurrent-family layers (port of ``nn/conf/layers/recurrent.py``): LSTM,
GravesLSTM (peepholes), GravesBidirectionalLSTM, SimpleRnn, RnnOutputLayer
and LastTimeStep.

Written as the JAX layers compute: the input projection of every time step
is one ``[B·T, n_in] × [n_in, 4H]`` product plus the bias, then a loop over
time does one ``[B, H] × [H, 4H]`` recurrent product and the gate
arithmetic per step (JAX's ``lax.scan``); the outputs are collected in a
list and stacked once, and autograd differentiates the loop. Arrays are
``[batch, time, features]``. The fused 4H axis holds the gates in the order
**[i, f, o, g]** (not ``torch.nn.LSTM``'s [i, f, g, o], which also has no
peepholes, so it is not called). A mask is carry-through: a masked step
keeps the previous h and c, ``h = m·h + (1 − m)·h_prev``, by that
arithmetic (a NaN at a masked step propagates, as in JAX). ``h``/``c`` in
the layer state are the initial state (zeros in x's dtype without them);
the forward returns the final state under the same keys, which the nets
keep in the streaming or TBPTT carry (``nn/network.py``'s ``CARRY_KEYS``),
never in the layer state.

Assumed: f32 products run in full f32. They are plain ``torch.matmul``,
which is f32-accurate while ``torch.backends.cuda.matmul.allow_tf32`` is
False (torch's default); these layers do not set it. A process that turns
TF32 on gets TF32-rounded products here, as in every Dense layer of the
port (cuDNN convolutions, whose TF32 flag defaults to on, set their own
flags in ``convolution.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.nn.conf.layers.core import DenseLayer
from deeplearning4j_torch.ops.activations import get_activation
from deeplearning4j_torch.ops.losses import get_loss
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    gate_activation: str = "sigmoid"

    INPUT_KIND = "rnn"
    DEFAULT_ACTIVATION = "tanh"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.size


def _lstm_scan(x_proj, rw, c0, h0, gate_act, cell_act, mask,
               peepholes=None):
    """Run an LSTM over time (JAX ``_lstm_scan``).

    ``x_proj`` ``[B, T, 4H]`` the input projections plus bias, ``rw``
    ``[H, 4H]``, ``mask`` ``[B, T]`` or None, ``peepholes`` ``(pi, pf,
    po)`` or None. Returns ``(outputs [B, T, H], (h_T, c_T))``."""
    H = rw.shape[0]
    ms = None if mask is None else mask.to(x_proj.dtype)
    h_prev, c_prev = h0, c0
    outs = []
    for t in range(x_proj.shape[1]):
        z = x_proj[:, t] + torch.matmul(h_prev, rw)
        zi, zf, zo, zg = torch.split(z, H, dim=-1)
        if peepholes is not None:
            pi, pf, po = peepholes
            i = gate_act(zi + pi * c_prev)
            f = gate_act(zf + pf * c_prev)
            g = cell_act(zg)
            c = f * c_prev + i * g
            # the output gate reads the NEW cell state
            o = gate_act(zo + po * c)
        else:
            i = gate_act(zi)
            f = gate_act(zf)
            g = cell_act(zg)
            c = f * c_prev + i * g
            o = gate_act(zo)
        h = o * cell_act(c)
        if ms is not None:
            m = ms[:, t, None]
            h = m * h + (1.0 - m) * h_prev
            c = m * c + (1.0 - m) * c_prev
        outs.append(h)
        h_prev, c_prev = h, c
    return torch.stack(outs, dim=1), (h_prev, c_prev)


def _zeros_state(x, H):
    return torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)


@register_serializable
@dataclass
class LSTM(BaseRecurrentLayer):
    """Peephole-free LSTM. Params: W ``[n_in, 4H]``, RW ``[H, 4H]``, b
    ``[4H]`` (its forget block ``[H:2H]`` starts at
    ``forget_gate_bias_init``)."""

    forget_gate_bias_init: float = 1.0

    def param_order(self):
        return ["W", "RW", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        H = self.n_out
        W = self._init_w(gen, (self.n_in, 4 * H), self.n_in, H, dtype,
                         device)
        RW = self._init_w(gen, (H, 4 * H), H, H, dtype, device)
        b = torch.zeros((4 * H,), dtype=dtype, device=device)
        b[H:2 * H] = self.forget_gate_bias_init
        return {"W": W, "RW": RW, "b": b}

    def _peepholes(self, params):
        return None

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        H = self.n_out
        x_proj = torch.matmul(x, params["W"]) + params["b"]
        h0 = state["h"] if "h" in state else _zeros_state(x, H)
        c0 = state["c"] if "c" in state else _zeros_state(x, H)
        outs, (hT, cT) = _lstm_scan(
            x_proj, params["RW"], c0, h0,
            get_activation(self.gate_activation), self.act(), mask,
            self._peepholes(params))
        new_state = dict(state)
        new_state["h"], new_state["c"] = hT, cT
        return outs, new_state


@register_serializable
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013): adds pi/pf/po
    ``[H]``, zeros at init; i and f read ``c_prev``, o the new ``c``."""

    def param_order(self):
        return ["W", "RW", "b", "pi", "pf", "po"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        params = super().init_params(gen, dtype, device)
        for k in ("pi", "pf", "po"):
            params[k] = torch.zeros((self.n_out,), dtype=dtype,
                                    device=device)
        return params

    def _peepholes(self, params):
        return (params["pi"], params["pf"], params["po"])


@register_serializable
@dataclass
class GravesBidirectionalLSTM(GravesLSTM):
    """Bidirectional Graves LSTM: the forward and backward directions'
    outputs are ADDED. The backward direction runs on the time-flipped
    input and mask from zero state; both start from zeros, and the state
    passes through unchanged (no streaming carry). Params ``f_*`` then
    ``b_*``, each a GravesLSTM's; ``f_b``/``b_b`` are the biases (they take
    ``l1_bias``/``l2_bias``, the peepholes take l1/l2)."""

    def param_order(self):
        base = super().param_order()
        return [f"f_{k}" for k in base] + [f"b_{k}" for k in base]

    def bias_param_names(self):
        return frozenset({"f_b", "b_b"})

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        fwd = GravesLSTM.init_params(self, gen, dtype, device)
        bwd = GravesLSTM.init_params(self, gen, dtype, device)
        out = {f"f_{k}": v for k, v in fwd.items()}
        out.update({f"b_{k}": v for k, v in bwd.items()})
        return out

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        H = self.n_out
        gact, cact = get_activation(self.gate_activation), self.act()

        def run(prefix, xx, mm):
            x_proj = (torch.matmul(xx, params[f"{prefix}_W"])
                      + params[f"{prefix}_b"])
            peep = (params[f"{prefix}_pi"], params[f"{prefix}_pf"],
                    params[f"{prefix}_po"])
            outs, _ = _lstm_scan(x_proj, params[f"{prefix}_RW"],
                                 _zeros_state(x, H), _zeros_state(x, H),
                                 gact, cact, mm, peep)
            return outs

        fwd = run("f", x, mask)
        mask_rev = None if mask is None else torch.flip(mask, dims=(1,))
        bwd = torch.flip(run("b", torch.flip(x, dims=(1,)), mask_rev),
                         dims=(1,))
        return fwd + bwd, state


@register_serializable
@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: ``h_t = act(x_t W + h_{t-1} RW + b)``."""

    def param_order(self):
        return ["W", "RW", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        H = self.n_out
        return {"W": self._init_w(gen, (self.n_in, H), self.n_in, H, dtype,
                                  device),
                "RW": self._init_w(gen, (H, H), H, H, dtype, device),
                "b": self._bias(H, dtype, device)}

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        act = self.act()
        x_proj = torch.matmul(x, params["W"]) + params["b"]
        h_prev = state["h"] if "h" in state else _zeros_state(x, self.n_out)
        ms = None if mask is None else mask.to(x.dtype)
        outs = []
        for t in range(x_proj.shape[1]):
            h = act(x_proj[:, t] + torch.matmul(h_prev, params["RW"]))
            if ms is not None:
                m = ms[:, t, None]
                h = m * h + (1.0 - m) * h_prev
            outs.append(h)
            h_prev = h
        new_state = dict(state)
        new_state["h"] = h_prev
        return torch.stack(outs, dim=1), new_state


@register_serializable
@dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense + loss over ``[B, T, F]``. A ``[B, T]`` label mask
    leaves masked steps out of the loss mean."""

    loss: str = "mcxent"

    INPUT_KIND = "rnn"
    DEFAULT_ACTIVATION = "softmax"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def loss_fn(self):
        return get_loss(self.loss)

    def compute_loss_per_example(self, params, x, labels, weights=None):
        """``[B, T]`` losses of the preactivations against ``labels``."""
        pre = self.preactivate(params, x)
        return self.loss_fn().per_example(labels, pre, self.act(), weights)


@register_serializable
@dataclass
class LastTimeStep(BaseRecurrentLayer):
    """``[B, T, F] -> [B, F]``: each row's step at its LAST nonzero mask
    entry (non-contiguous masks included); an all-masked row takes step 0;
    without a mask, the last step. The mask ends here."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def param_order(self):
        return []

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        return {}

    def feed_forward_mask(self, mask):
        return None

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        if mask is None:
            return x[:, -1, :], state
        t_idx = torch.arange(x.shape[1], device=x.device)[None, :]
        idx = torch.where(mask > 0, t_idx, -1).amax(dim=1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx], state
