"""Port parity: sequence and tensor parallelism (the port's
``parallel/{sequence,tensor}.py`` and the collectives of
``parallel/mesh.py``) against the JAX package's on the CPU — the
counterpart of ``tests/test_sequence_tensor_parallel.py``'s
``TestRingAttention``, ``TestUlyssesAttention`` and ``TestTensorParallel``.

JAX's run over eight XLA CPU devices; the port's over a host mesh naming
the CPU eight times. The inputs are drawn once with numpy and go through
both packages. Tolerances are JAX's: attention outputs atol = rtol = 2e-5
against the dense attention and against JAX's sharded result; ring
gradients 3e-5, Ulysses gradients 2e-5; the dp x tp MLP step 1e-5 (loss)
and atol = rtol = 1e-5 (params) against the dense step and JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer as JSelfAttention)
from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    scaled_dot_attention as jsdpa)
from deeplearning4j_tpu.parallel import sequence as jseq  # noqa: E402
from deeplearning4j_tpu.parallel import tensor as jtensor  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer, scaled_dot_attention)
from deeplearning4j_torch.parallel.mesh import (  # noqa: E402
    Mesh, all_to_all, ppermute, psum)
from deeplearning4j_torch.parallel.sequence import (  # noqa: E402
    ring_attention, sequence_parallel_self_attention, ulysses_attention)
from deeplearning4j_torch.parallel.tensor import (  # noqa: E402
    dp_tp_mesh, tp_mlp_block, tp_mlp_train_step, tp_specs)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seq_mesh(n=8):
    return Mesh([CPU] * n, ("seq",))


def jseq_mesh(n=8):
    return JMesh(np.asarray(jax.devices()[:n]), ("seq",))


def qkv(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# ------------------------------------------------------------ collectives
def test_collectives_move_and_differentiate():
    xs = [torch.arange(8.0).reshape(2, 4).add(10 * i).requires_grad_(True)
          for i in range(4)]
    ring = ppermute(xs)
    assert all(torch.equal(ring[i], xs[(i - 1) % 4]) for i in range(4))
    a2a = all_to_all(xs, split_dim=1, concat_dim=0)
    # entry i holds column block i of every sender, senders in order
    assert torch.equal(a2a[1], torch.cat([x[:, 1:2] for x in xs], 0))
    s = psum(xs)
    (sum((r * (i + 1)).sum() for i, r in enumerate(ring))
     + sum(o.sum() for o in s) + sum(a.sum() for a in a2a)).backward()
    # ppermute's backward rotates back (x_i went to entry i + 1, weighted
    # by its index + 1); psum's hands every entry 4 ones; all_to_all's
    # returns each piece's ones to its sender
    for i, x in enumerate(xs):
        want = ((i + 1) % 4 + 1) + 4 + 1
        assert torch.equal(x.grad, torch.full_like(x, want))
    with pytest.raises(ValueError, match="equal pieces"):
        all_to_all([torch.zeros(2, 3)] * 2, split_dim=1, concat_dim=0)


# ----------------------------------------------------------------- ring
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense_and_jax(causal):
    q, k, v = qkv((2, 3, 32, 8), 0)    # T = 32 over 8 entries: blocks of 4
    got = ring_attention(t(q), t(k), t(v), mesh=seq_mesh(), causal=causal)
    dense = scaled_dot_attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)
    want = jseq.ring_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mesh=jseq_mesh(), axis="seq",
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_gradients_flow_through_ring():
    q, k, v = qkv((1, 2, 16, 4), 1)
    a = [t(x, True) for x in (q, k, v)]
    b = [t(x, True) for x in (q, k, v)]
    (ring_attention(*a, mesh=seq_mesh(), causal=True) ** 2).sum().backward()
    (scaled_dot_attention(*b, causal=True) ** 2).sum().backward()
    jg = jax.grad(lambda *x: jnp.sum(jseq.ring_attention(
        *x, mesh=jseq_mesh(), axis="seq", causal=True) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for x, y, z in zip(a, b, jg):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(z),
                                   atol=3e-5, rtol=3e-5)


def layer_pair(n, heads, seed, **kw):
    """The JAX layer and the port's on JAX's drawn weights."""
    jl = JSelfAttention(n_in=n, n_out=n, n_heads=heads, **kw)
    jl.finalize(None)
    jp = jl.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tl = SelfAttentionLayer(n_in=n, n_out=n, n_heads=heads, **kw)
    tl.finalize(None)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jl, jp, tl, tp


@pytest.mark.parametrize("impl,heads", [("ring", 3), ("ulysses", 8)])
def test_layer_wrapper_matches_layer_forward(impl, heads):
    n = 12 if impl == "ring" else 16
    jl, jp, tl, tp = layer_pair(n, heads, 0, causal=True)
    x = np.random.RandomState(2).randn(2, 32, n).astype(np.float32)
    want, _ = tl.forward(tp, {}, t(x))
    got = sequence_parallel_self_attention(tl, tp, t(x), mesh=seq_mesh(),
                                           impl=impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    jgot = jseq.sequence_parallel_self_attention(
        jl, jp, jnp.asarray(x), mesh=jseq_mesh(), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(ValueError, match="impl"):
        sequence_parallel_self_attention(tl, tp, t(x), mesh=seq_mesh(),
                                         impl="tree")


# -------------------------------------------------------------- ulysses
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_dense_and_jax(causal):
    q, k, v = qkv((2, 8, 32, 4), 2)    # 8 heads over 8 entries
    got = ulysses_attention(t(q), t(k), t(v), mesh=seq_mesh(),
                            causal=causal)
    dense = scaled_dot_attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)
    want = jseq.ulysses_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mesh=jseq_mesh(),
                                  axis="seq", causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ulysses_gradients_match_dense():
    q, k, v = qkv((1, 8, 16, 4), 3)
    a = [t(x, True) for x in (q, k, v)]
    b = [t(x, True) for x in (q, k, v)]
    (ulysses_attention(*a, mesh=seq_mesh(), causal=True) ** 2).sum() \
        .backward()
    (scaled_dot_attention(*b, causal=True) ** 2).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   atol=2e-5, rtol=2e-5)


def test_ulysses_indivisible_heads_rejected():
    q = t(np.random.RandomState(4).randn(1, 3, 16, 4).astype(np.float32))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, mesh=seq_mesh())
    with pytest.raises(ValueError, match="axis"):
        ring_attention(q, q, q, mesh=Mesh([CPU] * 2, ("data",)))


# ------------------------------------------------------- tensor parallel
def mlp_params(seed, I, Hd, O):
    rs = np.random.RandomState(seed)
    return {"w1": rs.randn(I, Hd).astype(np.float32) * 0.3,
            "b1": np.zeros(Hd, np.float32),
            "w2": rs.randn(Hd, O).astype(np.float32) * 0.3,
            "b2": np.zeros(O, np.float32)}


def test_dp_tp_step_matches_single_device_and_jax():
    """4 entries (data=2, model=2): the sharded step equals the dense step
    on one device and JAX's sharded step."""
    B, I, Hd, O = 8, 6, 12, 4
    params = mlp_params(5, I, Hd, O)
    params["b2"] = np.random.RandomState(9).randn(O).astype(np.float32)
    rs = np.random.RandomState(5)
    x = rs.randn(B, I).astype(np.float32)
    y = rs.randn(B, O).astype(np.float32)
    step = tp_mlp_train_step(dp_tp_mesh(2, 2, devices=[CPU] * 4),
                             torch.tanh, lambda o, tt: (o - tt) ** 2, lr=0.1)
    new, loss = step({k: t(v) for k, v in params.items()}, x, y)
    p = {k: t(v, True) for k, v in params.items()}
    ref = torch.mean((torch.tanh(t(x) @ p["w1"] + p["b1"]) @ p["w2"]
                      + p["b2"] - t(y)) ** 2)
    grads = torch.autograd.grad(ref, list(p.values()))
    assert abs(float(loss) - float(ref.detach())) < 1e-5
    jstep = jtensor.tp_mlp_train_step(jtensor.dp_tp_mesh(2, 2), jax.nn.tanh,
                                      lambda o, tt: (o - tt) ** 2, lr=0.1)
    jnew, jloss = jstep({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x), jnp.asarray(y))
    assert abs(float(loss) - float(jloss)) < 1e-5
    for (k, v), g in zip(p.items(), grads):
        want = (v - 0.1 * g).detach().numpy()
        np.testing.assert_allclose(np.asarray(new[k]), want, atol=1e-5,
                                   rtol=1e-5, err_msg=f"param {k}")
        np.testing.assert_allclose(np.asarray(new[k]), np.asarray(jnew[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=f"jax {k}")
    # the weights stay sharded: w1 by columns, w2 by rows, b2 whole
    assert tuple(new["w1"].spec) == (None, "model")
    assert new["w1"].pieces[0].shape == (I, Hd // 2)
    assert new["w2"].pieces[0].shape == (Hd // 2, O)
    assert new["b2"].pieces[0].shape == (O,)


def test_tp_trains_to_lower_loss():
    rs = np.random.RandomState(6)
    x = rs.randn(16, 5).astype(np.float32)
    y = x @ rs.randn(5, 2).astype(np.float32)
    params = {k: t(v) for k, v in mlp_params(7, 5, 8, 2).items()}
    step = tp_mlp_train_step(dp_tp_mesh(4, 2, devices=[CPU] * 8),
                             torch.tanh, lambda o, tt: (o - tt) ** 2,
                             lr=0.05)
    params, first = step(params, x, y)
    for _ in range(60):
        params, loss = step(params, x, y)
    assert float(loss) < float(first) * 0.5
    with pytest.raises(ValueError, match="not divisible"):
        step(params, x[:3], y[:3])


def test_tp_mlp_block_has_one_psum_and_jax_specs():
    """The block's per-entry partial products summed once equal the dense
    block; the specs are JAX's."""
    p = mlp_params(8, 6, 12, 4)
    x = np.random.RandomState(8).randn(3, 6).astype(np.float32)
    w1, b1 = np.split(p["w1"], 2, 1), np.split(p["b1"], 2)
    w2 = np.split(p["w2"], 2, 0)
    outs = tp_mlp_block([t(x)] * 2, [t(a) for a in w1], [t(a) for a in b1],
                        [t(a) for a in w2], [t(p["b2"])] * 2, torch.relu)
    dense = np.maximum(x @ p["w1"] + p["b1"], 0) @ p["w2"] + p["b2"]
    for o in outs:
        np.testing.assert_allclose(o.numpy(), dense, atol=1e-5, rtol=1e-5)
    assert [tuple(s) for s in tp_specs()][:4] == \
        [tuple(s) for s in jtensor.tp_specs()][:4]
