"""Model zoo (port of ``deeplearning4j_tpu/models/zoo.py``): TransformerLM,
``lm_stream_forward``, the sampled next-token select and the streaming
``greedy_generate``/``sample_generate``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch.nn.conf.graph_conf import (ElementWiseVertex,
                                                     GraphBuilder)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)
from deeplearning4j_torch.nn.conf.layers.core import DenseLayer
from deeplearning4j_torch.nn.conf.layers.normalization import (
    LayerNormalization)
from deeplearning4j_torch.nn.conf.layers.recurrent import RnnOutputLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.updater import Adam
from deeplearning4j_torch.ops import random


class TransformerLM:
    """Causal transformer language model, built as the same graph with the
    same vertex names as the JAX zoo model: one-hot tokens -> Dense embed +
    sinusoidal positions -> n_blocks x [LN -> causal multi-head
    SelfAttention -> +residual -> LN -> Dense(4D, gelu) -> Dense(D) ->
    +residual] -> LN -> RnnOutputLayer softmax/mcxent per timestep; trained
    with ``Adam(learning_rate=3e-4)``."""

    def __init__(self, num_labels: int = 256, max_length: int = 128,
                 d_model: int = 256, n_heads: int = 8, n_blocks: int = 4,
                 seed: int = 123, dtype: str = "float32",
                 max_cache: int = 512):
        self.num_labels = num_labels
        self.max_length = max_length
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_blocks = n_blocks
        self.seed = seed
        self.dtype = dtype
        self.max_cache = max_cache

    def conf(self):
        D = self.d_model
        g = (GraphBuilder(seed=self.seed, dtype=self.dtype)
             .updater(Adam(learning_rate=3e-4))
             .add_inputs("tokens")
             .set_input_types(InputType.recurrent(self.num_labels,
                                                  self.max_length)))
        g.add_layer("embed", DenseLayer(n_out=D, activation="identity"),
                    "tokens")
        g.add_layer("pos", PositionalEncodingLayer(), "embed")
        x = "pos"
        for i in range(self.n_blocks):
            g.add_layer(f"ln{i}a", LayerNormalization(), x)
            g.add_layer(f"attn{i}",
                        SelfAttentionLayer(n_out=D, n_heads=self.n_heads,
                                           causal=True, helper="auto",
                                           max_cache=self.max_cache),
                        f"ln{i}a")
            g.add_vertex(f"res{i}a", ElementWiseVertex(op="add"),
                         x, f"attn{i}")
            g.add_layer(f"ln{i}b", LayerNormalization(), f"res{i}a")
            g.add_layer(f"ff{i}a", DenseLayer(n_out=4 * D,
                                              activation="gelu"),
                        f"ln{i}b")
            g.add_layer(f"ff{i}b", DenseLayer(n_out=D,
                                              activation="identity"),
                        f"ff{i}a")
            g.add_vertex(f"res{i}b", ElementWiseVertex(op="add"),
                         f"res{i}a", f"ff{i}b")
            x = f"res{i}b"
        g.add_layer("ln_f", LayerNormalization(), x)
        g.add_layer("output",
                    RnnOutputLayer(n_out=self.num_labels,
                                   activation="softmax", loss="mcxent"),
                    "ln_f")
        g.set_outputs("output")
        return g.build()

    def init(self, params=None, *, device=None) -> ComputationGraph:
        """The initialized graph on ``device`` (CUDA unless the caller
        passes another device; raises on a host without CUDA)."""
        return ComputationGraph(self.conf()).init(params, device=device)


def lm_stream_forward(net):
    """One streaming forward chunk through ``net`` as a plain function:
    ``fwd(params, state, x, carry, mask=None) -> (out, new_carry)``."""

    def fwd(params, state, x, carry, mask=None):
        outs, new_carry, _, _ = net._forward(params, state, [x], [mask],
                                             carry=carry)
        return outs[0], new_carry

    return fwd


def sampled_next_token(probs, keys, temperature, top_k):
    """Next-token select with per-row sampling values (JAX
    ``zoo.sampled_next_token``): ``probs`` ``[B, V]`` softmax outputs,
    ``keys`` ``[B, 2]`` PRNG keys (``ops/random.py``), ``temperature``
    ``[B]`` f32 and ``top_k`` ``[B]`` integer tensors. Rows with
    temperature <= 0 take the argmax; the others sample from
    ``log(max(p, 1e-30)) / max(T, 1e-30)`` with every logit under the
    row's k-th largest cut to -1e30 (``top_k <= 0``: no cut; ties at the
    k-th value all stay), by a Gumbel-argmax drawn from the row's key.
    The logarithm is XLA's (``random._xla_log``), so the tokens are the JAX
    package's bit for bit on the same probabilities."""
    V = probs.shape[-1]
    greedy = torch.argmax(probs, dim=-1)
    # max(p, 1e-30) in p's dtype (a 16-bit p rounds the floor to its own)
    logp = random._xla_log(torch.clamp(probs, min=1e-30).float()).to(
        probs.dtype)
    # JAX promotes 16-bit log-probabilities to f32 by the f32 temperature
    logits = logp.float() / torch.clamp(temperature.float(),
                                        min=1e-30)[:, None]
    srt = torch.sort(logits, dim=-1).values                 # ascending
    k_idx = torch.clamp(V - top_k.long(), 0, V - 1)
    kth = torch.gather(srt, 1, k_idx[:, None])
    cut = (top_k[:, None] > 0) & (logits < kth)
    logits = torch.where(cut, -1e30, logits)
    sampled = random.categorical_rows(keys, logits)
    return torch.where(temperature <= 0, greedy, sampled)


def greedy_generate(net, prompt_ids, steps: int, vocab: int,
                    device_loop: bool = True):
    """Greedy decoding: ``sample_generate`` with temperature 0."""
    return sample_generate(net, prompt_ids, steps, vocab, temperature=0.0,
                           device_loop=device_loop)


def sample_generate(net, prompt_ids, steps: int, vocab: int,
                    temperature: float = 1.0, top_k: int = 0, seed: int = 0,
                    device_loop: bool = True):
    """Autoregressive decoding over the KV-cache streaming forward (JAX
    ``zoo.sample_generate``): the prompt is consumed once, then each token
    costs one incremental attention row.

    ``temperature`` 0 is greedy; otherwise tokens are sampled from the
    softmax sharpened by 1/temperature, restricted to the ``top_k`` most
    likely when ``top_k > 0``. ``device_loop=True`` keeps the JAX device
    loop's key schedule on the net's device: the first token is drawn with
    ``fold_in(PRNGKey(seed), 0)`` and token i with ``fold_in(.., i)``, one
    Gumbel draw over the whole ``[B, V]`` batch (the same tokens as the JAX
    package's for the same probabilities). ``device_loop=False`` streams
    through ``rnn_time_step`` and samples with numpy's ``RandomState(seed)``
    on the host, as the JAX package does on that path.

    prompt_ids: ``[B, T0]`` ints. Returns ``[B, steps]`` generated ids
    (numpy int64).
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0 or top_k > vocab:
        raise ValueError(f"top_k must be in [0, vocab], got {top_k}")
    prompt_ids = np.asarray(prompt_ids)
    if device_loop:
        return _device_generate(net, prompt_ids, steps, vocab, temperature,
                                top_k, seed)

    rs = np.random.RandomState(seed)

    def pick(probs):  # [B, V] -> [B]
        if temperature <= 0:
            return probs.argmax(-1)
        logp = np.log(np.maximum(probs, 1e-30)) / temperature
        if top_k > 0:
            kth = np.sort(logp, axis=-1)[:, -top_k][:, None]
            logp = np.where(logp >= kth, logp, -1e30)
        p = np.exp(logp - logp.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return np.stack([rs.choice(vocab, p=row) for row in p])

    eye = np.eye(vocab, dtype=np.float32)
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(eye[prompt_ids])          # [B, T0, V]
    last = pick(_host(out)[:, -1])
    generated = [last]
    for _ in range(steps - 1):
        out = net.rnn_time_step(eye[last][:, None, :])  # [B, 1, V]
        last = pick(_host(out)[:, 0])
        generated.append(last)
    return np.stack(generated, axis=1).astype(np.int64)


def _host(t):
    return t.float().cpu().numpy()


@torch.inference_mode()
def _device_generate(net, prompt_ids, steps: int, vocab: int,
                     temperature: float, top_k: int, seed: int):
    """The JAX device loop's schedule on the net's device: consume the
    prompt, then one streaming forward per token, keys folded per step."""
    B = prompt_ids.shape[0]
    # generation is its own stream: any live rnn_time_step stream is
    # cleared, and left cleared
    net.rnn_clear_previous_state()
    carry = net._seed_streaming_carry(B)
    cap = net._stream_capacity
    needed = prompt_ids.shape[1] + steps - 1
    if cap is not None and needed > cap:
        raise ValueError(
            f"KV cache overflow: prompt + generated positions ({needed}) "
            f"> max_cache ({cap}); raise SelfAttentionLayer.max_cache")
    dtype = getattr(torch, net.conf.dtype)
    fwd = lm_stream_forward(net)
    key = random.PRNGKey(seed, device=net.device)

    def pick(probs, i):  # [B, V], step -> [B]
        if temperature <= 0:
            return torch.argmax(probs, dim=-1)
        logp = random._xla_log(torch.clamp(probs, min=1e-30).float()).to(
            probs.dtype)
        # a Python temperature divides in the probabilities' dtype, as a
        # weakly typed JAX scalar does
        logits = logp / torch.tensor(temperature, dtype=torch.float32).to(
            probs.dtype).item()
        if top_k > 0:
            kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
            # -1e30 in the logits' dtype, as JAX casts it (f16: -inf)
            logits = torch.where(logits >= kth, logits,
                                 float(torch.tensor(-1e30).to(logits.dtype)))
        return random.categorical(random.fold_in(key, i), logits)

    ids = torch.as_tensor(prompt_ids, device=net.device)
    x = F.one_hot(ids, vocab).to(dtype)
    out, carry = fwd(net.params, net.state, x, carry)
    last = pick(out[:, -1], 0)
    generated = [last]
    for i in range(1, steps):
        x = F.one_hot(last, vocab).to(dtype)[:, None, :]
        out, carry = fwd(net.params, net.state, x, carry)
        last = pick(out[:, 0], i)
        generated.append(last)
    net.rnn_clear_previous_state()
    return torch.stack(generated, dim=1).cpu().numpy().astype(np.int64)
