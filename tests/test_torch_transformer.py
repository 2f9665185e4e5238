"""Port parity: the TransformerLM graph of ``deeplearning4j_torch`` against the
JAX zoo model, on the reference's own weights loaded by ``params_from_jax``.

Tolerance: atol 2e-5 on the output probabilities. Both sides compute in
f32; XLA and PyTorch reorder the f32 sums of the matmuls, layer norms and
softmaxes, which is the only stated source of difference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    params_from_jax, params_to_numpy)

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V = 17
KW = dict(num_labels=V, max_length=16, d_model=32, n_heads=4, n_blocks=2)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxTransformerLM(seed=3, **KW).init()
    tnet = TransformerLM(seed=3, max_cache=32, **KW).init(device="cpu")
    params_from_jax(jax.device_get(jnet.params), tnet)
    return jnet, tnet


def test_same_graph_and_parameter_shapes(nets):
    jnet, tnet = nets
    assert list(tnet.conf.vertices) == list(jnet.conf.vertices)
    for name, vin in jnet.conf.vertex_inputs.items():
        assert tnet.conf.vertex_inputs[name] == list(vin), name
    for vname, p in jnet.params.items():
        for pname, a in p.items():
            assert tuple(tnet.params[vname][pname].shape) == tuple(a.shape)


def test_params_from_jax_round_trip(nets):
    jnet, tnet = nets
    ref = jax.device_get(jnet.params)
    back = params_to_numpy(tnet)
    assert set(back) == set(ref)
    for vname in ref:
        for pname in ref[vname]:
            np.testing.assert_array_equal(back[vname][pname],
                                          np.asarray(ref[vname][pname]))


def test_params_from_jax_rejects_wrong_shapes(nets):
    _, tnet = nets
    bad = params_to_numpy(tnet)
    bad["embed"]["W"] = bad["embed"]["W"][:, :-1]
    with pytest.raises(ValueError, match="embed.W"):
        params_from_jax(bad, TransformerLM(**KW).init(device="cpu"))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_output_matches_jax(nets, masked):
    jnet, tnet = nets
    rs = np.random.RandomState(11 + masked)
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (3, 16))]
    mask = None
    if masked:
        mask = np.ones((3, 16), np.float32)
        mask[1, 10:] = 0
        mask[2, 3:] = 0
    ref = np.asarray(jnet.output(x, masks=mask))
    got = tnet.output(x, masks=mask)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("helper", ["stock", "pallas"])
def test_attention_helper_knob_agrees(nets, helper):
    """"stock" and the kernel wrapper give the same output on the CPU (the
    wrapper takes the plain version there)."""
    _, tnet = nets
    rs = np.random.RandomState(13)
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (2, 9))]
    base = tnet.output(x)
    layers = [v.layer for n, v in tnet.conf.vertices.items()
              if n.startswith("attn")]
    try:
        for lyr in layers:
            lyr.helper = helper
        got = tnet.output(x)
    finally:
        for lyr in layers:
            lyr.helper = "auto"
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-6)


def test_slice_defaults_match_jax_zoo():
    """The slice's full-width model keeps the JAX zoo defaults (conf only,
    no weights drawn)."""
    ref = JaxTransformerLM()
    port = TransformerLM()
    for key in ("num_labels", "max_length", "d_model", "n_heads",
                "n_blocks"):
        assert getattr(port, key) == getattr(ref, key), key
    conf = port.conf()
    attn = conf.vertices["attn0"].layer
    assert (attn.n_in, attn.n_out, attn.n_heads, attn.max_cache) == \
        (256, 256, 8, 512)
    assert conf.vertices["ff0a"].layer.n_out == 1024
    assert conf.vertices["output"].layer.n_out == 256


@pytest.mark.parametrize("name", ["identity", "softmax", "gelu"])
def test_activations_match_jax(name):
    """The port's activations against the JAX registry's; gelu is the tanh
    approximation that ``jax.nn.gelu`` defaults to."""
    from deeplearning4j_tpu.ops.activations import get_activation as jax_act
    from deeplearning4j_torch.ops.activations import get_activation

    x = np.random.RandomState(2).randn(4, 7).astype(np.float32) * 3
    ref = np.asarray(jax_act(name)(jax.numpy.asarray(x)))
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
