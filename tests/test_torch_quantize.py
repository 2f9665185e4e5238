"""Port parity: int8 weights (``deeplearning4j_torch/optimize/quantize.py``)
against the JAX package's ``optimize/quantize.py``, on the CPU.

The weight cases of ``tests/test_quantize.py`` that need no unported module:
the round-trip bound, the quantized keys and the untouched source, the
refused mode, and the two accuracy gates, each also held to the JAX
function on the same arrays; the port's codes and scales bitwise the JAX
package's for the same weights (f32, bf16, f16); a quantized
``TransformerLM``'s ``output()`` against the JAX quantized net's (f32 within
1e-5; bf16 within two bf16 steps of max|out|, the two frameworks rounding
the bf16 products at other places); the zoo knob; quantized greedy serving
token for token the JAX server's (f32 and int8 KV, and a quantized draft at
``spec_k`` 4); a quantized JAX tree carried onto the port; ``save_model``
refusing a quantized net. The LeNet case is in
``tests/test_torch_multilayer.py``, the ``ParallelInference`` case in
``tests/test_torch_inference.py``, the Keras case in
``tests/test_torch_keras.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.optimize import quantize as jq  # noqa: E402
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch.models import zoo  # noqa: E402
from deeplearning4j_torch.optimize import quantize as tq  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402
from deeplearning4j_torch.utils.model_serializer import (  # noqa: E402
    save_model)

pytestmark = [pytest.mark.torch_port, pytest.mark.quant]

V = 17
CAP = 64
LM = dict(num_labels=V, max_length=16, d_model=16, n_heads=2, n_blocks=1)
SHAPES = [(3, 6), (5, 4), (9, 5), (3, 5), (5, 6), (9, 4)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_pair(seed=3, dtype="float32", **kw):
    """A JAX ``TransformerLM`` (its own initialisation at ``seed``) and the
    port's twin holding the same weights, both with ``max_cache`` CAP."""
    cfg = dict(LM, **kw)
    jnet = jzoo.TransformerLM(seed=seed, dtype=dtype, **cfg).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = CAP
    tnet = zoo.TransformerLM(max_cache=CAP, dtype=dtype,
                             **cfg).init(device="cpu")
    params = _np(jnet.params)
    if dtype != "float32":
        # bf16 leaves go over as f32 (exact), and the port casts them back
        params = {v: {k: a.astype(np.float32) for k, a in p.items()}
                  for v, p in params.items()}
    params_from_jax(params, tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def pair():
    return jax_pair()


@pytest.fixture(scope="module")
def qpair(pair):
    jnet, tnet = pair
    return jq.quantize_net(jnet), tq.quantize_net(tnet)


@pytest.fixture(scope="module")
def reqs():
    rs = np.random.RandomState(4)
    return [(rs.randint(0, V, p), s) for p, s in SHAPES]


def probe(T=12, B=3, seed=5):
    rs = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[rs.randint(0, V, (B, T))]


def test_roundtrip_error_bound():
    """q * scale reconstructs within half a quantization step per output
    channel; all-zero channels reconstruct exactly."""
    rs = np.random.RandomState(0)
    for shape in [(7, 5), (3, 3, 2, 4), (16, 16)]:
        w = (rs.randn(*shape) * rs.uniform(0.01, 10)).astype(np.float32)
        w[..., -1] = 0.0
        q, scale = tq.quantize_array(w)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert tuple(scale.shape) == (shape[-1],)
        rt = tq.dequantize_array(q, scale)
        step = scale.numpy().reshape((1,) * (w.ndim - 1) + (-1,))
        assert np.all(np.abs(rt - w) <= 0.5001 * np.maximum(step, 1e-12))
        np.testing.assert_array_equal(rt[..., -1], 0.0)
        np.testing.assert_array_equal(
            rt, jq.dequantize_array(np.asarray(q), np.asarray(scale)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_codes_and_scales_bitwise_equal_jax(dtype):
    """``quantize_array`` on the same weights: the port's int8 codes and f32
    scales are the JAX package's bit for bit, whatever the weight's dtype
    (half-to-even rounding, the ±127 clip, zero channels and 1-D vectors
    included)."""
    rs = np.random.RandomState(1)
    for shape in [(7, 5), (16, 16), (3, 3, 2, 4), (9,), (33, 64)]:
        w = (rs.randn(*shape) * rs.uniform(0.01, 10)).astype(np.float32)
        if w.ndim > 1:
            w[..., -1] = 0.0
        if w.ndim == 2:
            # channel 0 at scale 0.5 exactly: 1.25 and -3.75 are half
            # steps (codes 2 and -8, half to even)
            w[:, 0] = np.clip(w[:, 0], -60, 60)
            w[:3, 0] = [63.5, 1.25, -3.75]
        jqv, jsv = jq.quantize_array(jnp.asarray(w, dtype))
        tqv, tsv = tq.quantize_array(torch.from_numpy(w).to(
            getattr(torch, dtype)))
        assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        assert tsv.numpy().tobytes() == np.asarray(jsv).tobytes()


def test_quantize_params_targets_and_scales(pair):
    """Only QUANT_PARAMS weights quantize, the same keys as JAX's with
    bitwise-equal codes and scales: attention projections, dense W and the
    output layer's W go int8 with f32 ``*_scale`` siblings; biases, norms
    stay as they were; the source net's params are not mutated."""
    jnet, tnet = pair
    before = {v: {k: t.clone() for k, t in p.items()}
              for v, p in tnet.params.items()}
    qparams, scales = tq.quantize_params(tnet)
    jparams, jscales = jq.quantize_params(jnet)
    assert set(scales) == set(jscales)
    assert {v: set(p) for v, p in scales.items()} == \
        {v: set(p) for v, p in jscales.items()}
    assert "output" in scales and "attn0" in scales and "ff0a" in scales
    n_int8 = 0
    for v, lp in qparams.items():
        assert set(lp) == set(jparams[v])
        for k, t in lp.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jparams[v][k]))
            if t.dtype == torch.int8:
                n_int8 += 1
                assert k + "_scale" in lp and k in scales[v]
            elif not k.endswith("_scale"):
                assert torch.equal(t, before[v][k])
    assert n_int8 == sum(len(p) for p in scales.values()) > 0
    for v, p in tnet.params.items():
        for k, t in p.items():
            assert not k.endswith("_scale") and t.dtype != torch.int8
            assert torch.equal(t, before[v][k])


def test_bad_mode_rejected(pair):
    with pytest.raises(ValueError, match="int8"):
        tq.quantize_net(pair[1], "int4")


def test_quantized_output_matches_jax(qpair):
    """The quantized nets' ``output()`` on the same probe: within 1e-5 of
    JAX's (both dequantize the same codes, f32 matmuls summed in other
    orders)."""
    jq_net, tq_net = qpair
    x = probe()
    out = tq_net.output(x).numpy()
    jout = np.asarray(jq_net.output(x))
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=0)


def test_quantized_output_differs_from_f32_and_stays_close(pair, qpair):
    """The dequant path runs (the output is not the f32 net's) and stays
    near the f32 net's softmax outputs."""
    _, tnet = pair
    _, tq_net = qpair
    x = probe()
    f32 = tnet.output(x).numpy()
    q8 = tq_net.output(x).numpy()
    assert not np.array_equal(f32, q8)
    assert np.abs(f32 - q8).max() < 0.05


def test_quantized_bf16_output_matches_jax():
    """A bf16 net quantized on both sides: codes and scales bitwise equal,
    and ``output()`` within 2^-6 of max|out| of JAX's: the bf16 product
    times the f32 scale is f32 and then cast, in both, but each framework
    rounds its bf16 matmuls, norms and softmax in its own places, so the
    two unquantized bf16 nets already differ by 0.0034 of a max|out| of
    0.29 here (1.2 %, three bf16 steps of max|out|); the quantized nets'
    gap may exceed that by at most a quarter."""
    jnet, tnet = jax_pair(dtype="bfloat16")
    jqn, tqn = jq.quantize_net(jnet), tq.quantize_net(tnet)
    for v, p in tqn.params.items():
        for k, t in p.items():
            if t.dtype == torch.int8 or k.endswith("_scale"):
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jqn.params[v][k]))
    x = probe()
    assert tqn.output(x).dtype == torch.bfloat16
    out = tqn.output(x).float().numpy()
    jout = np.asarray(jqn.output(x)).astype(np.float32)
    gap = np.abs(out - jout).max()
    base = np.abs(tnet.output(x).float().numpy()
                  - np.asarray(jnet.output(x)).astype(np.float32)).max()
    assert gap <= 2.0 ** -6 * np.abs(jout).max()
    assert gap <= 1.25 * base


def test_zoo_quantize_knob_equals_quantize_net():
    """``TransformerLM(quantize="int8").init()`` is ``quantize_net`` of the
    same initialisation: equal trees, int8 codes and f32 scales."""
    net = zoo.TransformerLM(quantize="int8", **LM).init(device="cpu")
    ref = tq.quantize_net(zoo.TransformerLM(**LM).init(device="cpu"))
    assert set(net.params) == set(ref.params)
    for v, p in ref.params.items():
        assert set(net.params[v]) == set(p)
        for k, t in p.items():
            assert net.params[v][k].dtype == t.dtype
            assert torch.equal(net.params[v][k], t)
    assert net.params["attn0"]["Wq"].dtype == torch.int8
    with pytest.raises(ValueError, match="int8"):
        zoo.TransformerLM(quantize="int4", **LM).init(device="cpu")


def _serve(srv, reqs):
    try:
        futs = [srv.submit(p, s) for p, s in reqs]
        return [f.result(timeout=180).tolist() for f in futs]
    finally:
        srv.close()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32kv", "int8kv"])
def test_quantized_server_streams_equal_jax(qpair, reqs, kv):
    """Greedy streams of the port's server on the quantized net equal the
    JAX server's on its quantized net, f32 and int8 KV pages."""
    jq_net, tq_net = qpair
    kw = dict(slots=3, page_size=8, kv_dtype=kv)
    got = _serve(GenerationServer(tq_net, V, device="cpu", **kw), reqs)
    want = _serve(JaxGenerationServer(jq_net, V, paged_attention="xla", **kw),
                  reqs)
    assert got == want
    assert tq.greedy_agreement(np.concatenate(got),
                               np.concatenate(want)) == 1.0


def test_quantized_draft_speculative_streams_equal_jax(qpair, reqs):
    """A quantized target with a quantized draft (another seed, d_model 8)
    at ``spec_k`` 4: the port's streams equal the JAX server's."""
    jq_net, tq_net = qpair
    jd, td = jax_pair(seed=99, d_model=8)
    jqd, tqd = jq.quantize_net(jd), tq.quantize_net(td)
    kw = dict(slots=3, page_size=8, spec_k=4)
    got = _serve(GenerationServer(tq_net, V, device="cpu", draft_net=tqd,
                                  **kw), reqs)
    want = _serve(JaxGenerationServer(jq_net, V, paged_attention="xla",
                                      draft_net=jqd, **kw), reqs)
    assert got == want


def test_gates_equal_jax():
    """``confusion_delta`` and ``greedy_agreement`` equal JAX's on the same
    arrays, including their refusals and edge cases."""
    a = np.array([[5, 0], [0, 5]])
    b = np.array([[4, 1], [0, 5]])
    for x, y in ((a, a.copy()), (a, b), (np.zeros((2, 2), int), a * 0)):
        assert tq.confusion_delta(x, y) == jq.confusion_delta(x, y)
    assert tq.confusion_delta(a, b) == pytest.approx(0.1)
    for bad, match in ((np.array([[9, 1], [0, 5]]), "example counts"),
                       (np.zeros((3, 3), int), "shapes")):
        with pytest.raises(ValueError, match=match):
            tq.confusion_delta(a, bad)
        with pytest.raises(ValueError, match=match):
            jq.confusion_delta(a, bad)
    rs = np.random.RandomState(2)
    pairs = [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 2, 4]),
             ([1, 2], [1, 2, 3]), ([], []),
             (rs.randint(0, 3, 50), rs.randint(0, 3, 47))]
    for x, y in pairs:
        assert tq.greedy_agreement(x, y) == jq.greedy_agreement(x, y)


def test_params_from_jax_carries_a_quantized_tree(pair, qpair):
    """A JAX quantized tree loads onto an unquantized port net as codes and
    scales (int8 and f32) and serves the port's quantized outputs; a
    quantized port net takes it as well."""
    jq_net, tq_net = qpair
    fresh = zoo.TransformerLM(max_cache=CAP, **LM).init(device="cpu")
    params_from_jax(_np(jq_net.params), fresh)
    assert fresh.params["attn0"]["Wq"].dtype == torch.int8
    assert fresh.params["attn0"]["Wq_scale"].dtype == torch.float32
    assert fresh.params["output"]["W"].dtype == torch.int8
    x = probe()
    assert torch.equal(fresh.output(x), tq_net.output(x))
    again = tq.quantize_net(zoo.TransformerLM(max_cache=CAP,
                                              **LM).init(device="cpu"))
    params_from_jax(_np(jq_net.params), again)
    assert torch.equal(again.output(x), tq_net.output(x))
    bad = _np(jq_net.params)
    bad["attn0"]["Wq"] = bad["attn0"]["Wq"].astype(np.float32)
    with pytest.raises(ValueError, match="int8"):
        params_from_jax(bad, zoo.TransformerLM(max_cache=CAP, **LM).init(
            device="cpu"))


def test_save_model_refuses_a_quantized_net(qpair, pair, tmp_path):
    """The zip's flat f32 coefficients have no place for the scales: the
    port raises where the JAX package drops them (ROADMAP §C)."""
    with pytest.raises(ValueError, match="quantize"):
        save_model(qpair[1], str(tmp_path / "q.zip"))
    assert not (tmp_path / "q.zip").exists()
    save_model(pair[1], str(tmp_path / "f32.zip"))        # the source saves
