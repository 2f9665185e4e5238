"""Dimensionality-reduction plotting tools (the port of
``deeplearning4j_tpu/plot``; reference: deeplearning4j-core plot/ —
BarnesHutTsne.java:65).

``Tsne`` is the exact O(N^2) implementation (dense [N, N] products on the
card, fine for N <= ~5k); ``BarnesHutTsne`` is the grid-ladder Barnes-Hut
implementation (sparse kNN attraction + FMM-style far field) for
reference-scale N; ``build_sparse_p`` is its symmetrized sparse input
similarity."""

from deeplearning4j_torch.plot.barnes_hut import BarnesHutTsne, build_sparse_p
from deeplearning4j_torch.plot.tsne import Tsne

__all__ = ["Tsne", "BarnesHutTsne", "build_sparse_p"]
