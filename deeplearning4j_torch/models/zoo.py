"""Model zoo (port of ``deeplearning4j_tpu/models/zoo.py``): the
MultiLayerNetwork models (LeNet, SimpleCNN, AlexNet, VGG16, VGG19,
TextGenerationLSTM) at the JAX package's architectures and
hyperparameters, NHWC; TransformerLM, ``lm_stream_forward``, the sampled
next-token select and the streaming ``greedy_generate``/
``sample_generate`` (over a TransformerLM's KV caches or an LSTM net's
h/c). The graph models of the CNN zoo (ResNet50, GoogLeNet,
FaceNetNN4Small2, InceptionResNetV1) need vertices the port lacks; they
raise naming ROADMAP A12."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)
from deeplearning4j_torch.nn.conf.layers.convolution import (
    ConvolutionLayer, SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers.core import (ActivationLayer,
                                                      DenseLayer,
                                                      DropoutLayer,
                                                      OutputLayer)
from deeplearning4j_torch.nn.conf.layers.normalization import (
    BatchNormalization, LayerNormalization)
from deeplearning4j_torch.nn.conf.layers.pooling import GlobalPoolingLayer
from deeplearning4j_torch.nn.conf.layers.recurrent import (GravesLSTM,
                                                           RnnOutputLayer)
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.nn.updater import (AdaDelta, Adam, Nesterovs,
                                             RmsProp)
from deeplearning4j_torch.nn.weights import Distribution
from deeplearning4j_torch.ops import random


class ZooModel:
    """Base of the instantiable zoo models. ``input_shape`` is (height,
    width, channels), NHWC. ``quantize="int8"`` quantizes the initialized
    net's dense and convolution weights at ``init()``
    (``optimize/quantize.py``); ``compute_dtype`` is set on the
    configuration at ``init()``, as the JAX ``ZooModel`` sets it."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape: Optional[tuple] = None, dtype: str = "float32",
                 compute_dtype: Optional[str] = None,
                 quantize: Optional[str] = None):
        self.num_labels = num_labels
        self.seed = seed
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        if input_shape is not None:
            self.input_shape = tuple(input_shape)

    def conf(self):
        raise NotImplementedError

    def init(self, params=None, *, device=None):
        """The initialized net on ``device`` (CUDA unless the caller passes
        another device; raises on a host without CUDA)."""
        c = self.conf()
        c.compute_dtype = self.compute_dtype
        cls = (ComputationGraph
               if type(c).__name__ == "ComputationGraphConfiguration"
               else MultiLayerNetwork)
        net = cls(c).init(params, device=device)
        if self.quantize is not None:
            from deeplearning4j_torch.optimize.quantize import quantize_net
            net = quantize_net(net, self.quantize)
        return net

    def init_pretrained(self, pretrained_type: str = "imagenet"):
        raise NotImplementedError(
            "Pretrained weights need a download; restore from a local zip "
            "with utils.model_serializer.load_model instead.")

    def model_type(self) -> str:
        return "MultiLayerNetwork"


class LeNet(ZooModel):
    """LeNet-5 for MNIST: conv5x5(20) -> max2 -> conv5x5(50) -> max2 ->
    dense500 -> softmax, AdaDelta."""

    input_shape = (28, 28, 1)

    def __init__(self, num_labels: int = 10, **kw):
        super().__init__(num_labels=num_labels, **kw)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).activation("identity").weight_init("xavier")
                .updater(AdaDelta()).dtype(self.dtype)
                .list(
                    ConvolutionLayer(name="cnn1", n_out=20, kernel_size=(5, 5),
                                     stride=(1, 1), convolution_mode="same",
                                     activation="relu"),
                    SubsamplingLayer(name="maxpool1", kernel_size=(2, 2),
                                     stride=(2, 2)),
                    ConvolutionLayer(name="cnn2", n_out=50, kernel_size=(5, 5),
                                     stride=(1, 1), convolution_mode="same",
                                     activation="relu"),
                    SubsamplingLayer(name="maxpool2", kernel_size=(2, 2),
                                     stride=(2, 2)),
                    DenseLayer(name="ffn1", n_out=500, activation="relu"),
                    OutputLayer(name="output", n_out=self.num_labels,
                                activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """Five conv/BN blocks and a global-average-pool head, AdaDelta; the
    head is an OutputLayer (softmax, mcxent) so the net trains alone, as
    the JAX model's is."""

    input_shape = (48, 48, 1)

    def __init__(self, num_labels: int = 10, **kw):
        super().__init__(num_labels=num_labels, **kw)

    def conf(self):
        h, w, c = self.input_shape

        def block(k, n):
            return [ConvolutionLayer(n_out=n, kernel_size=(k, k),
                                     convolution_mode="same"),
                    BatchNormalization(),
                    ConvolutionLayer(n_out=n, kernel_size=(k, k),
                                     convolution_mode="same"),
                    BatchNormalization(),
                    ActivationLayer(activation="relu"),
                    SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                                     stride=(2, 2)),
                    DropoutLayer(dropout=0.5)]

        layers = (block(7, 16) + block(5, 32) + block(3, 64) + block(3, 128)
                  + [ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                      convolution_mode="same"),
                     BatchNormalization(),
                     ConvolutionLayer(n_out=self.num_labels,
                                      kernel_size=(3, 3),
                                      convolution_mode="same"),
                     GlobalPoolingLayer(pooling_type="avg"),
                     OutputLayer(n_out=self.num_labels, activation="softmax",
                                 loss="mcxent")])
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).activation("identity").weight_init("relu")
                .updater(AdaDelta()).dtype(self.dtype)
                .list(*layers)
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class AlexNet(ZooModel):
    """AlexNet, one tower, with the JAX model's strides, normal(0, 0.01)
    weights, dropout 0.5 on the dense layers, L2 5e-4 and Nesterovs."""

    input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        non_zero_bias = 1.0
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).activation("relu")
                .weight_init("distribution")
                .dist(Distribution.normal(0.0, 0.01))
                .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
                .l2(5e-4).dtype(self.dtype)
                .list(
                    ConvolutionLayer(name="cnn1", n_out=64,
                                     kernel_size=(11, 11), stride=(4, 4),
                                     padding=(2, 2),
                                     convolution_mode="truncate"),
                    SubsamplingLayer(name="maxpool1", kernel_size=(3, 3),
                                     stride=(2, 2), padding=(1, 1),
                                     convolution_mode="truncate"),
                    ConvolutionLayer(name="cnn2", n_out=192,
                                     kernel_size=(5, 5), stride=(2, 2),
                                     padding=(2, 2),
                                     convolution_mode="truncate",
                                     bias_init=non_zero_bias),
                    SubsamplingLayer(name="maxpool2", kernel_size=(3, 3),
                                     stride=(2, 2)),
                    ConvolutionLayer(name="cnn3", n_out=384,
                                     kernel_size=(3, 3), stride=(1, 1),
                                     padding=(1, 1)),
                    ConvolutionLayer(name="cnn4", n_out=256,
                                     kernel_size=(3, 3), stride=(1, 1),
                                     padding=(1, 1), bias_init=non_zero_bias),
                    ConvolutionLayer(name="cnn5", n_out=256,
                                     kernel_size=(3, 3), stride=(1, 1),
                                     padding=(1, 1), bias_init=non_zero_bias),
                    SubsamplingLayer(name="maxpool3", kernel_size=(3, 3),
                                     stride=(7, 7)),
                    DenseLayer(name="ffn1", n_out=4096,
                               dist=Distribution.normal(0, 0.005),
                               weight_init="distribution",
                               bias_init=non_zero_bias, dropout=0.5),
                    DenseLayer(name="ffn2", n_out=4096,
                               dist=Distribution.normal(0, 0.005),
                               weight_init="distribution",
                               bias_init=non_zero_bias, dropout=0.5),
                    OutputLayer(name="output", n_out=self.num_labels,
                                activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg_convs(*spec):
    """spec: channel counts; 'M' is a 2x2 max pool."""
    return [SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                             stride=(2, 2)) if s == "M"
            else ConvolutionLayer(n_out=s, kernel_size=(3, 3), stride=(1, 1),
                                  padding=(1, 1))
            for s in spec]


class VGG16(ZooModel):
    """VGG-16 with the conv-only head of the JAX model, Nesterovs."""

    input_shape = (224, 224, 3)
    SPEC = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
            "M", 512, 512, 512, "M")

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).activation("relu")
                .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
                .dtype(self.dtype)
                .list(*_vgg_convs(*self.SPEC),
                      OutputLayer(name="output", n_out=self.num_labels,
                                  activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """VGG-19: VGG16 with a fourth conv in the last three stages."""

    SPEC = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
            512, 512, "M", 512, 512, 512, 512, "M")


def _not_ported(name, item, what):
    def conf(self):
        raise NotImplementedError(f"{name} is not ported yet: {what} "
                                  f"(ROADMAP {item})")

    return type(name, (ZooModel,), {"conf": conf, "__doc__":
                                    f"{name}: {what} (ROADMAP {item})."})


_GRAPH_ZOO = "the graph models of the zoo come with the graph vertices"
ResNet50 = _not_ported("ResNet50", "A12", _GRAPH_ZOO)
GoogLeNet = _not_ported("GoogLeNet", "A12", _GRAPH_ZOO)
FaceNetNN4Small2 = _not_ported("FaceNetNN4Small2", "A12", _GRAPH_ZOO)
InceptionResNetV1 = _not_ported("InceptionResNetV1", "A12", _GRAPH_ZOO)


class TextGenerationLSTM(ZooModel):
    """Char-level text-generation LSTM (the JAX zoo's): GravesLSTM(256) ×2
    and a softmax/mcxent RnnOutputLayer over one-hot characters, RmsProp
    0.01, L2 1e-3, truncated BPTT 50/50. ``greedy_generate`` and
    ``sample_generate`` stream through its h/c."""

    def __init__(self, num_labels: int = 77, max_length: int = 40, **kw):
        super().__init__(num_labels=num_labels, **kw)
        self.max_length = max_length
        self.input_shape = (max_length, num_labels)

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).weight_init("xavier")
                .updater(RmsProp(learning_rate=0.01)).l2(0.001)
                .dtype(self.dtype)
                .list(
                    GravesLSTM(n_out=256, activation="tanh"),
                    GravesLSTM(n_out=256, activation="tanh"),
                    RnnOutputLayer(n_out=self.num_labels,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(self.num_labels))
                .t_bptt_lengths(50, 50)
                .build())


class TransformerLM:
    """Causal transformer language model, built as the same graph with the
    same vertex names as the JAX zoo model: one-hot tokens -> Dense embed +
    sinusoidal positions -> n_blocks x [LN -> causal multi-head
    SelfAttention -> +residual -> LN -> Dense(4D, gelu) -> Dense(D) ->
    +residual] -> LN -> RnnOutputLayer softmax/mcxent per timestep; trained
    with ``Adam(learning_rate=3e-4)``. ``quantize="int8"`` quantizes the
    initialized net's dense and attention weights at ``init()``
    (``optimize/quantize.py``), as the JAX ``ZooModel`` does; None (the
    default) keeps full-precision params. ``compute_dtype`` (e.g.
    ``"bfloat16"``) is the training forward's dtype, set on the
    configuration at ``init()`` as the JAX ``ZooModel`` sets it; ``remat``
    recomputes the attention and FFN-expansion vertices' activations in
    the backward."""

    def __init__(self, num_labels: int = 256, max_length: int = 128,
                 d_model: int = 256, n_heads: int = 8, n_blocks: int = 4,
                 remat: bool = False, seed: int = 123,
                 dtype: str = "float32", compute_dtype: Optional[str] = None,
                 max_cache: int = 512, quantize: Optional[str] = None):
        self.num_labels = num_labels
        self.max_length = max_length
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_blocks = n_blocks
        self.remat = remat
        self.seed = seed
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.max_cache = max_cache
        self.quantize = quantize

    def conf(self):
        D = self.d_model
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).weight_init("xavier")
             .updater(Adam(learning_rate=3e-4))
             .dtype(self.dtype)
             .graph_builder()
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
                        f"ln{i}a", remat=self.remat)
            g.add_vertex(f"res{i}a", ElementWiseVertex(op="add"),
                         x, f"attn{i}")
            g.add_layer(f"ln{i}b", LayerNormalization(), f"res{i}a")
            g.add_layer(f"ff{i}a", DenseLayer(n_out=4 * D,
                                              activation="gelu"),
                        f"ln{i}b", remat=self.remat)
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
        passes another device; raises on a host without CUDA), its weights
        int8-quantized when ``quantize`` is set."""
        c = self.conf()
        c.compute_dtype = self.compute_dtype
        net = ComputationGraph(c).init(params, device=device)
        if self.quantize is not None:
            from deeplearning4j_torch.optimize.quantize import quantize_net
            net = quantize_net(net, self.quantize)
        return net


def lm_stream_forward(net):
    """One streaming forward chunk through ``net`` (a graph or a
    MultiLayerNetwork) as a plain function: ``fwd(params, state, x, carry,
    mask=None) -> (out, new_carry)``."""
    if not hasattr(net.conf, "network_inputs"):
        def fwd_mln(params, state, x, carry, mask=None):
            out, new_carry, _ = net._forward(params, state, x, mask,
                                             carry=carry)
            return out, new_carry

        return fwd_mln

    def fwd(params, state, x, carry, mask=None):
        outs, new_carry, _, _ = net._forward(params, state, [x], [mask],
                                             train=False, rng=None,
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


def spec_verify_tokens(probs, base_keys, counts, temperature, top_k):
    """The target's token selections at K consecutive positions per row,
    the verification half of speculative decoding (JAX
    ``zoo.spec_verify_tokens``): ``probs`` ``[B, K, V]`` softmax outputs of
    one chunked forward over ``[last, draft_1, ..., draft_{K-1}]``,
    ``base_keys`` ``[B, 2]``, ``counts`` ``[B]`` the index of the first
    token selected, ``temperature``/``top_k`` ``[B]``. Position i of row b
    selects with ``fold_in(base_keys[b], counts[b] + i)``, the key the
    serial decode uses for that token, so every emitted token is the
    target's selection under the serial schedule whatever the draft
    proposed. One ``sampled_next_token`` over the ``[B·K, V]`` rows."""
    B, K, V = probs.shape
    idx = counts.long()[:, None] + torch.arange(K, device=probs.device)
    keys = random.fold_in(base_keys[:, None, :], idx)           # [B, K, 2]
    flat = sampled_next_token(probs.reshape(B * K, V), keys.reshape(B * K, 2),
                              temperature.repeat_interleave(K),
                              top_k.repeat_interleave(K))
    return flat.reshape(B, K)


def greedy_generate(net, prompt_ids, steps: int, vocab: int,
                    device_loop: bool = True):
    """Greedy decoding: ``sample_generate`` with temperature 0."""
    return sample_generate(net, prompt_ids, steps, vocab, temperature=0.0,
                           device_loop=device_loop)


def sample_generate(net, prompt_ids, steps: int, vocab: int,
                    temperature: float = 1.0, top_k: int = 0, seed: int = 0,
                    device_loop: bool = True):
    """Autoregressive decoding over the streaming forward (JAX
    ``zoo.sample_generate``): the prompt is consumed once, then each token
    costs one incremental attention row (a TransformerLM's KV caches) or
    one recurrent step (a TextGenerationLSTM's h/c).

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


def zoo_models() -> dict:
    """Name -> zoo model class, as the JAX package's ``zoo_models``."""
    return {
        "alexnet": AlexNet,
        "facenetnn4small2": FaceNetNN4Small2,
        "googlenet": GoogLeNet,
        "inceptionresnetv1": InceptionResNetV1,
        "lenet": LeNet,
        "resnet50": ResNet50,
        "simplecnn": SimpleCNN,
        "textgenlstm": TextGenerationLSTM,
        "transformerlm": TransformerLM,
        "vgg16": VGG16,
        "vgg19": VGG19,
    }
