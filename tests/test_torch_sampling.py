"""Port parity of sampled decoding (``deeplearning4j_torch/models/zoo.py``
and ``parallel/generation.py``) against the JAX package:

- ``sampled_next_token`` equals JAX's on rows mixing greedy and sampled,
  with and without ``top_k`` (ties at the k-th value kept), in f32 and
  bf16;
- ``greedy_generate`` and ``sample_generate`` (the device loop's
  ``fold_in(PRNGKey(seed), i)`` schedule, and the host loop's numpy
  ``RandomState``) equal JAX's token streams, on the committed
  ``regression_transformer_r5.zip`` and on a seeded small model;
- the ``GenerationServer`` serving greedy and sampled requests together
  equals the JAX server's streams for the same seeds (f32 and int8 KV, a
  seed of 2^32 or more included), and each sampled request equals the
  port's own ``sample_generate`` for its seed.

Token streams are compared exactly: the PRNG is bitwise JAX's
(``tests/test_torch_random.py``) and the probabilities agree to about
1e-7, so only a near-tie could move a token, and these inputs have none.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_tpu.utils import model_serializer as jms  # noqa: E402
from deeplearning4j_torch.models import zoo  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.utils import model_serializer as ms  # noqa: E402
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ZIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "regression_transformer_r5.zip")
V = 17
CAP = 32
SERVER = dict(slots=3, page_size=8, prefill_chunk=16, steps_per_dispatch=4)
# (prompt length, max_tokens, temperature, top_k, seed): greedy and
# sampled rows in one batch, a prompt over prefill_chunk, top_k 0, < V and
# = V, and a seed of 2^32 or more (two key words)
REQS = [(3, 6, 0.8, 0, 1), (20, 8, 0.0, 5, 2), (9, 5, 1.3, 3, 3),
        (21, 12, 0.7, 0, 2 ** 33 + 4), (1, 10, 0.9, V, 5), (12, 7, 0.0, 0, 6)]


def _np_params(net, seed, gain=2.0):
    rs = np.random.RandomState(seed)
    out = {}
    for v, p in net.params.items():
        out[v] = {}
        for k, t in p.items():
            shp = tuple(t.shape)
            if k.startswith("W"):
                a = rs.randn(*shp) * gain / np.sqrt(shp[0])
            elif k == "gamma":
                a = 1.0 + 0.1 * rs.randn(*shp)
            else:
                a = 0.1 * rs.randn(*shp)
            out[v][k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def nets():
    """The seeded small model in both packages (max_cache 32)."""
    kw = dict(num_labels=V, max_length=16, d_model=32, n_heads=4, n_blocks=2)
    tnet = zoo.TransformerLM(max_cache=CAP, **kw).init(device="cpu")
    params = _np_params(tnet, 7)
    params_from_jax(params, tnet)
    jnet = jzoo.TransformerLM(seed=3, **kw).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = CAP
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jnet, tnet


@pytest.fixture(scope="module")
def fixture_nets():
    return jms.load_model(ZIP), ms.load_model(ZIP, device="cpu")


def _rows(rs, B, Vv, dtype):
    logits = rs.randn(B, Vv).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return probs.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("topk", ["none", "mixed"])
def test_sampled_next_token_matches_jax(topk, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rs = np.random.RandomState(0)
    B, Vv = 8, 256
    temp = np.array([0.0, 0.5, 1.0, 1.7, 0.0, 0.8, 2.5, 0.3], np.float32)
    top = (np.zeros(B, np.int32) if topk == "none" else
           np.array([0, 1, 5, 40, 3, 0, 256, 17], np.int32))
    for trial in range(3):
        probs = _rows(rs, B, Vv, dtype)
        keys = jax.random.split(jax.random.PRNGKey(trial), B)
        want = jzoo.sampled_next_token(jnp.asarray(probs).astype(jd), keys,
                                       jnp.asarray(temp), jnp.asarray(top))
        got = zoo.sampled_next_token(
            torch.from_numpy(probs).to(td),
            torch.from_numpy(np.asarray(keys).astype(np.int64)),
            torch.from_numpy(temp), torch.from_numpy(top))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_next_token_keeps_ties_at_the_kth_value():
    """The cut is a value threshold: logits equal to the k-th largest all
    stay in, as in JAX (a top-k of indices would drop some)."""
    B, Vv = 6, 32
    probs = np.full((B, Vv), 1.0, np.float32)
    probs[:, :4] = 4.0                      # four tied at the top
    probs /= probs.sum(-1, keepdims=True)
    temp = np.full(B, 1.0, np.float32)
    top = np.full(B, 2, np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    want = np.asarray(jzoo.sampled_next_token(
        jnp.asarray(probs), keys, jnp.asarray(temp), jnp.asarray(top)))
    got = zoo.sampled_next_token(
        torch.from_numpy(probs),
        torch.from_numpy(np.asarray(keys).astype(np.int64)),
        torch.from_numpy(temp), torch.from_numpy(top)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) <= {0, 1, 2, 3}


GEN_CASES = {"greedy": dict(temperature=0.0),
             "t0.8": dict(temperature=0.8, seed=3),
             "t1.2_top3": dict(temperature=1.2, top_k=3, seed=11)}


@pytest.mark.parametrize("device_loop", [True, False], ids=["device",
                                                             "host"])
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_matches_jax_on_the_fixture(fixture_nets, case,
                                             device_loop):
    jnet, tnet = fixture_nets
    prompt = np.random.RandomState(5).randint(0, 7, (2, 5))
    kw = GEN_CASES[case]
    want = jzoo.sample_generate(jnet, prompt, 12, 7, device_loop=device_loop,
                                **kw)
    got = zoo.sample_generate(tnet, prompt, 12, 7, device_loop=device_loop,
                              **kw)
    assert got.shape == (2, 12) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_matches_jax_on_a_seeded_model(nets, case):
    jnet, tnet = nets
    prompt = np.random.RandomState(6).randint(0, V, (3, 9))
    kw = GEN_CASES[case]
    want = jzoo.sample_generate(jnet, prompt, 20, V, **kw)
    got = zoo.sample_generate(tnet, prompt, 20, V, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    if case == "greedy":
        np.testing.assert_array_equal(
            zoo.greedy_generate(tnet, prompt, 20, V),
            np.asarray(jzoo.greedy_generate(jnet, prompt, 20, V)))


def test_generate_validates_and_guards_the_cache(nets):
    _, tnet = nets
    p = np.zeros((1, 4), np.int64)
    for kw in (dict(steps=0), dict(temperature=-1.0), dict(top_k=V + 1),
               dict(top_k=-1)):
        args = dict(steps=3, temperature=1.0, top_k=0)
        args.update(kw)
        with pytest.raises(ValueError):
            zoo.sample_generate(tnet, p, args.pop("steps"), V, **args)
    with pytest.raises(ValueError, match="KV cache overflow"):
        zoo.greedy_generate(tnet, p, CAP, V)


def _serve(server, reqs):
    try:
        futs = [server.submit(p, n, temperature=t, top_k=k, seed=s)
                for p, n, t, k, s in reqs]
        return [np.asarray(f.result(timeout=120)).tolist() for f in futs]
    finally:
        server.close()


@pytest.fixture(scope="module")
def sampled_requests():
    rs = np.random.RandomState(0)
    return [(rs.randint(0, V, n), m, t, k, s) for n, m, t, k, s in REQS]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_server_sampled_streams_equal_jax_server(nets, sampled_requests,
                                                 kv_dtype):
    jnet, tnet = nets
    want = _serve(JaxGenerationServer(jnet, V, paged_attention="xla",
                                      kv_dtype=kv_dtype, **SERVER),
                  sampled_requests)
    got = _serve(GenerationServer(tnet, V, device="cpu", kv_dtype=kv_dtype,
                                  **SERVER), sampled_requests)
    assert got == want
    assert [len(t) for t in got] == [m for _, m, _, _, _ in REQS]


def test_server_sampled_streams_equal_sample_generate(nets,
                                                      sampled_requests):
    """The server's key schedule is ``sample_generate``'s: each request,
    served beside the others, equals its own ``sample_generate`` run."""
    _, tnet = nets
    got = _serve(GenerationServer(tnet, V, device="cpu", **SERVER),
                 sampled_requests)
    for (p, n, t, k, s), stream in zip(sampled_requests, got):
        alone = zoo.sample_generate(tnet, p[None], n, V, temperature=t,
                                    top_k=k, seed=s)
        assert alone[0].tolist() == stream


@pytest.mark.parametrize("kw", [dict(temperature=-0.5), dict(top_k=-1),
                                dict(top_k=V + 1)],
                         ids=["temp", "topk_neg", "topk_over"])
def test_server_rejects_bad_sampling_values(nets, kw):
    _, tnet = nets
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        with pytest.raises(ValueError):
            srv.submit(np.arange(4), 3, **kw)
    finally:
        srv.close()
