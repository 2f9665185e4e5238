"""Port parity of ``compute_dtype`` mixed precision, on the CPU.

Training (``ComputationGraph._loss``): with ``compute_dtype="bfloat16"``
every vertex but the output head computes in bf16 from f32 params (the
casts inside the autograd graph), and the loss head takes its input back in
f32. The port's bf16 loss is held to JAX's within rtol 1e-2; its gradients
to JAX's f32-compute gradients, per leaf, within twice JAX's own bf16 error
against those gradients plus 1e-3 of the leaf's max|g| (the two frameworks
round bf16 products at other places; the port's plain attention keeps its
softmax in f32 where JAX's CPU path rounds it to bf16).

Inference runs in the parameter dtype whatever ``compute_dtype`` says, as
in JAX: a JAX zip saved from ``TransformerLM(compute_dtype="bfloat16")``
loads in the port, its ``output()`` equals JAX's within 1e-5 and its greedy
``GenerationServer`` stream equals the JAX server's token for token.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.nn.graph import (  # noqa: E402
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_tpu.utils import model_serializer as jms  # noqa: E402
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_torch.optimize.fused_fit import (  # noqa: E402
    value_and_grad)
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.utils import model_serializer as ms  # noqa: E402
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 7
KW = dict(num_labels=V, max_length=16, d_model=16, n_heads=2, n_blocks=2)


def _pair(compute_dtype, seed=5):
    jconf = JaxTransformerLM(seed=seed, **KW).conf()
    tconf = TransformerLM(seed=seed, max_cache=32, **KW).conf()
    jconf.compute_dtype = tconf.compute_dtype = compute_dtype
    j = JaxGraph(jconf).init()
    t = ComputationGraph(tconf).init(device="cpu")
    params_from_jax(jax.device_get(j.params), t)
    return j, t


def _batch(seed=1, B=3):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, V, (B, KW["max_length"] + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def _jax_vg(jnet, x, y):
    def loss(p):
        return jnet._loss(p, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)],
                          None, None, train=True, rng=None)[0]
    value, grads = jax.jit(jax.value_and_grad(loss))(jnet.params)
    return float(value), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), grads)


@pytest.fixture(scope="module")
def grads():
    x, y = _batch()
    j32, _ = _pair(None)
    jbf, tbf = _pair("bfloat16")
    ref_loss, ref = _jax_vg(j32, x, y)
    jloss, jg = _jax_vg(jbf, x, y)
    tloss, tg = value_and_grad(tbf, tbf.params, tbf.state,
                               [torch.from_numpy(x)], [torch.from_numpy(y)],
                               train=True)
    return dict(ref=ref, ref_loss=ref_loss, jax=jg, jax_loss=jloss,
                port={v: {k: t.double().numpy() for k, t in p.items()}
                      for v, p in tg.items()},
                port_loss=float(tloss), port_dtypes={
                    (v, k): t.dtype for v, p in tg.items()
                    for k, t in p.items()})


def test_bf16_loss_matches_jax(grads):
    assert grads["port_loss"] == pytest.approx(grads["jax_loss"], rel=1e-2)
    # and both are near the f32-compute loss
    assert grads["port_loss"] == pytest.approx(grads["ref_loss"], rel=1e-2)


def test_bf16_gradients_within_jax_bf16_error(grads):
    ref, jg, tg = grads["ref"], grads["jax"], grads["port"]
    assert set(tg) == set(ref)
    worst = []
    for v in ref:
        for k in ref[v]:
            scale = np.abs(ref[v][k]).max()
            jerr = np.abs(jg[v][k] - ref[v][k]).max()
            terr = np.abs(tg[v][k] - ref[v][k]).max()
            assert terr <= 2 * jerr + 1e-3 * scale, (v, k, terr, jerr, scale)
            worst.append(terr / max(scale, 1e-30))
    # the gradients come back in the parameter dtype (f32), as jax.grad
    # through astype gives them
    assert set(grads["port_dtypes"].values()) == {torch.float32}
    assert max(worst) < 0.1


def test_bf16_step_trains_f32_params():
    """A ``compute_dtype`` step keeps the params and updater state f32 and
    moves the loss as JAX's step does."""
    j, t = _pair("bfloat16")
    x, y = _batch(2)
    jl = [float(j.do_step([x], [y])[0]) for _ in range(2)]
    tl = [float(t.do_step([x], [y])[0]) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert all(p.dtype == torch.float32 for lp in t.params.values()
               for p in lp.values())
    assert all(p.dtype == torch.float32 for s in t.updater_state.values()
               for lp in s.values() for p in lp.values())


@pytest.fixture(scope="module")
def bf16_zip(tmp_path_factory):
    """A JAX TransformerLM saved with ``compute_dtype="bfloat16"``, as the
    JAX package's bench trains it."""
    jnet = JaxTransformerLM(seed=11, compute_dtype="bfloat16", **KW).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = 64
    path = str(tmp_path_factory.mktemp("mp") / "bf16_compute.zip")
    jms.save_model(jnet, path)
    return path


def test_compute_dtype_zip_outputs_jax(bf16_zip):
    jnet = jms.load_model(bf16_zip)
    net = ms.load_model(bf16_zip, device="cpu")
    assert net.conf.compute_dtype == jnet.conf.compute_dtype == "bfloat16"
    x = _batch(3)[0]
    got = net.output(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x)),
                               atol=1e-5)
    net.rnn_clear_previous_state()
    step = net.rnn_time_step(x[:, :5])
    np.testing.assert_allclose(step.numpy(), got[:, :5].numpy(), atol=1e-5)


def _serve(srv, reqs):
    try:
        futs = [srv.submit(p, s) for p, s in reqs]
        return [f.result(timeout=180).tolist() for f in futs]
    finally:
        srv.close()


def test_compute_dtype_zip_serves_jax_tokens(bf16_zip):
    jnet = jms.load_model(bf16_zip)
    net = ms.load_model(bf16_zip, device="cpu")
    for _, layer in list(jnet._stream_layers()) + list(net._stream_layers()):
        if hasattr(layer, "max_cache"):
            layer.max_cache = 64
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, V, n), s) for n, s in ((3, 6), (9, 5), (5, 8))]
    kw = dict(slots=3, page_size=8)
    got = _serve(GenerationServer(net, V, device="cpu", **kw), reqs)
    want = _serve(JaxGenerationServer(jnet, V, paged_attention="xla", **kw),
                  reqs)
    assert got == want
