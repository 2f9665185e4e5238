"""Legacy visual iteration listeners, rebuilt on the declarative
components (port of ``deeplearning4j_tpu/ui/legacy.py``).

Reference: deeplearning4j-ui ui/weights/HistogramIterationListener.java
(per-iteration weight/gradient histograms + score to a web view),
ui/weights/ConvolutionalIterationListener.java (conv activation grids
rendered server-side to PNG), ui/flow/FlowIterationListener.java (model
topology + per-layer metadata view). Each listener writes a
SELF-CONTAINED html report file every ``frequency`` iterations (a file per
listener is scp-able and diffable), rendered via ui/components.py.
Activation grids become ChartMatrix heatmaps of the feature maps computed
from a user-supplied probe batch (NHWC, as the port's convolution layers
take it). Parameters and activations live on the net's device and are
copied to the host explicitly (``.cpu()``) at reporting iterations only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartMatrix,
    ComponentTable,
    ComponentText,
    render_html_file,
)


def _host(v) -> np.ndarray:
    """``v`` as a host numpy array (a tensor is copied with ``.cpu()``;
    bf16 widened exactly to f32, which numpy has)."""
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _histogram_chart(title: str, arr: np.ndarray,
                     bins: int = 30) -> ChartHistogram:
    counts, edges = np.histogram(np.asarray(arr).ravel(), bins=bins)
    h = ChartHistogram(title=title)
    for i, c in enumerate(counts):
        h.add_bin(edges[i], edges[i + 1], float(c))
    return h


class HistogramIterationListener(TrainingListener):
    """Score curve + per-parameter histograms every ``frequency``
    iterations (reference: HistogramIterationListener.java)."""

    def __init__(self, out_dir: str, frequency: int = 10,
                 filename: str = "histograms.html"):
        self.out_dir = out_dir
        self.frequency = max(1, frequency)
        self.filename = filename
        self._scores: list = []
        self._iters: list = []

    def iteration_done(self, model, iteration: int):
        self._iters.append(iteration)
        self._scores.append(float(model.score_value))
        if iteration % self.frequency != 0:
            return
        comps = [ComponentText(text=f"iteration {iteration}"),
                 ChartLine(title="score").add_series("score", self._iters,
                                                     self._scores)]
        for lk, lp in model.params.items():
            for pk, v in lp.items():
                comps.append(_histogram_chart(f"{lk}/{pk}", _host(v)))
        os.makedirs(self.out_dir, exist_ok=True)
        render_html_file(comps, os.path.join(self.out_dir, self.filename),
                         title="histograms")


class FlowIterationListener(TrainingListener):
    """Model topology + per-layer parameter counts and score (reference:
    FlowIterationListener.java builds the flow view from model info)."""

    def __init__(self, out_dir: str, frequency: int = 10,
                 filename: str = "flow.html"):
        self.out_dir = out_dir
        self.frequency = max(1, frequency)
        self.filename = filename

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        rows = []
        if hasattr(model, "layers"):  # MultiLayerNetwork
            it = ((str(i), layer) for i, layer in enumerate(model.layers))
        else:  # ComputationGraph
            it = ((name, v.layer) for name, v in model.conf.vertices.items()
                  if getattr(v, "layer", None) is not None)
        for key, layer in it:
            n = sum(int(p.numel()) if torch.is_tensor(p)
                    else int(np.asarray(p).size)
                    for p in model.params.get(key, {}).values())
            rows.append([key, type(layer).__name__, str(n)])
        comps = [
            ComponentText(text=f"{type(model).__name__} — iteration "
                               f"{iteration}, score "
                               f"{float(model.score_value):.6f}"),
            ComponentTable(header=["layer", "type", "params"], content=rows),
        ]
        os.makedirs(self.out_dir, exist_ok=True)
        render_html_file(comps, os.path.join(self.out_dir, self.filename),
                         title="flow")


class ConvolutionalIterationListener(TrainingListener):
    """Feature-map heatmaps of convolutional layers on a fixed probe input
    (reference: ConvolutionalIterationListener.java renders the same grids
    to PNG server-side). ``probe``: one input example [1, H, W, C] (NHWC);
    activations are recomputed at reporting iterations only."""

    def __init__(self, out_dir: str, probe, frequency: int = 10,
                 max_maps: int = 8, filename: str = "activations.html"):
        self.out_dir = out_dir
        self.probe = _host(probe)
        self.frequency = max(1, frequency)
        self.max_maps = max_maps
        self.filename = filename

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        if not hasattr(model, "feed_forward"):
            return
        acts = model.feed_forward(self.probe)
        # MultiLayerNetwork returns [input, act0, act1, ...];
        # ComputationGraph returns {vertex_name: activation}
        if isinstance(acts, dict):
            acts = list(acts.values())
        else:
            acts = acts[1:]
        comps = [ComponentText(text=f"activations at iteration "
                                    f"{iteration}")]
        for li, a in enumerate(acts):
            a = _host(a)
            if a.ndim != 4:  # only conv-shaped [B, H, W, C]
                continue
            for ch in range(min(a.shape[-1], self.max_maps)):
                comps.append(ChartMatrix(
                    title=f"layer {li} map {ch}",
                    values=[[float(x) for x in row]
                            for row in a[0, :, :, ch]]))
        os.makedirs(self.out_dir, exist_ok=True)
        render_html_file(comps, os.path.join(self.out_dir, self.filename),
                         title="activations")
