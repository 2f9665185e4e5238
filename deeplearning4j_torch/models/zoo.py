"""Model zoo (port of ``deeplearning4j_tpu/models/zoo.py``): TransformerLM and
``lm_stream_forward``."""

from __future__ import annotations

from deeplearning4j_torch.nn.conf.graph_conf import (ElementWiseVertex,
                                                     GraphBuilder)
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)
from deeplearning4j_torch.nn.conf.layers.core import DenseLayer
from deeplearning4j_torch.nn.conf.layers.normalization import (
    LayerNormalization)
from deeplearning4j_torch.nn.conf.layers.recurrent import RnnOutputLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.updater import Adam


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
             .add_inputs("tokens").set_input_sizes(self.num_labels))
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
