"""Port parity: graph embeddings (``deeplearning4j_torch/graph``) against
the JAX package's ``deeplearning4j_tpu/graph`` on the CPU — the
``TestGraphEmbeddings`` cases of ``tests/test_coredata.py``: for a seed the
three walk iterators give JAX's walks exactly, and ``DeepWalk`` /
``Node2Vec`` train tables within ``EPOCH_ATOL`` of JAX's (the trainer is
the port's ``SequenceVectors``, held in ``tests/test_torch_nlp.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu import graph as jgraph  # noqa: E402
from deeplearning4j_torch import graph as tgraph  # noqa: E402
from tests.test_torch_nlp import EPOCH_ATOL  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its batch loops run thousands
    of small ops, whose thread pools only contend with the other test
    workers sharing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_cliques(mod, weighted=False):
    """Two 6-cliques joined by one bridge edge."""
    edges = []
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                edges.append((base + i, base + j, 1.0 + (i + j) % 3)
                             if weighted else (base + i, base + j))
    edges.append((0, 6, 0.5) if weighted else (0, 6))
    return mod.Graph.from_edges(12, edges)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("it", ["RandomWalkIterator",
                                "WeightedRandomWalkIterator",
                                "Node2VecWalkIterator"])
@pytest.mark.parametrize("seed", [0, 5])
def test_walks_equal_jax(it, seed):
    weighted = it == "WeightedRandomWalkIterator"
    tg, jg = _two_cliques(tgraph, weighted), _two_cliques(jgraph, weighted)
    kw = dict(p=0.5, q=2.0) if it == "Node2VecWalkIterator" else {}
    got = list(getattr(tgraph, it)(tg, 12, 3, seed=seed, **kw))
    want = list(getattr(jgraph, it)(jg, 12, 3, seed=seed, **kw))
    assert got == want and len(got) == 36
    for walk in got:
        for a, b in zip(walk, walk[1:]):
            assert b in tg.neighbors(a) or a == b


def test_graph_api_equals_jax():
    tg, jg = _two_cliques(tgraph, True), _two_cliques(jgraph, True)
    for v in range(12):
        assert tg.neighbors(v) == jg.neighbors(v)
        assert tg.edges_out(v) == jg.edges_out(v)
        assert tg.degree(v) == jg.degree(v)
    d = tgraph.Graph(3, directed=True)
    d.add_edge(0, 1)
    assert d.neighbors(1) == [] and d.num_vertices() == 3


@pytest.mark.parametrize("cls,kw", [
    ("DeepWalk", dict(vector_size=16, window=3, walk_length=20,
                      walks_per_vertex=8, epochs=2, seed=3)),
    ("DeepWalk", dict(vector_size=16, window=3, walk_length=20,
                      walks_per_vertex=4, epochs=1, negative=4,
                      use_hierarchic_softmax=False, seed=2)),
    ("Node2Vec", dict(p=0.5, q=2.0, vector_size=8, walk_length=10,
                      walks_per_vertex=4, epochs=1, seed=4))])
def test_trains_as_jax(cls, kw):
    """Same walks, vocab and tables as JAX's; the negative-sampling
    config takes the native loop in both packages (bitwise)."""
    t = getattr(tgraph, cls)(device="cpu", **kw)
    j = getattr(jgraph, cls)(**kw)
    t.fit(_two_cliques(tgraph))
    j.fit(_two_cliques(jgraph))
    atol = 0 if kw.get("negative") else EPOCH_ATOL
    np.testing.assert_allclose(_np(t._sv.syn0), np.asarray(j._sv.syn0),
                               rtol=0, atol=atol)
    assert t.vertex_vector(11).shape == (kw["vector_size"],)
    near = t.verts_nearest(3, 3)
    assert [v for v, _ in near] == [v for v, _ in j.verts_nearest(3, 3)]


def test_deepwalk_community_structure():
    dw = tgraph.DeepWalk(vector_size=16, window=3, walk_length=20,
                         walks_per_vertex=8, epochs=2, seed=3, device="cpu")
    dw.fit(_two_cliques(tgraph))
    same = np.mean([dw.similarity(1, j) for j in range(2, 6)])
    cross = np.mean([dw.similarity(1, j) for j in range(7, 12)])
    assert same > cross
