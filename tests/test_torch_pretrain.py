"""Layer-wise pretraining in the port (``nn/conf/layers/{rbm,variational,
core}.py``, ``MultiLayerNetwork.pretrain``, ``ops/random.py``'s ``normal``
and array-``p`` ``bernoulli``) against the JAX package on the CPU, from the
same numpy-seeded inputs and the JAX net's parameters:

- ``normal`` bitwise ``jax.random.normal`` in f32 over many seeds and
  shapes, and within 2^13 ulps in f64 (``torch.erfinv`` for XLA's f64
  polynomial); ``bernoulli`` with an f32 or f64 array ``p`` bitwise;
- counterparts of ``tests/test_rbm.py`` (the CD-1 statistics, sparsity,
  chain length, unit variants, validation, pretraining lowering the
  reconstruction error, the gradient check through the RBM's forward,
  weight decay, serde), each also held to JAX's values: f64 gradients
  within 1e-12;
- f32 binary samples: the flips where torch's sigmoid and XLA's part on
  one draw are counted, and bounded;
- the VAE case of ``tests/test_core_fixes.py``, each reconstruction
  distribution's ``neg_log_prob`` (rtol 1e-12 in f64), the -ELBO and its
  gradients, ``reconstruct`` and ``generate``; the AutoEncoder's corrupted
  reconstruction loss;
- ``pretrain`` of a stack of every layer type against JAX's: f64 within
  1e-13, f32 within 1e-6, over two epochs;
- zips both ways with RBM, AutoEncoder and VAE layers: JAX's zip loads in
  the port and the port's in JAX, outputs equal;
- ``fit`` with ``conf.pretrain=True`` trains as JAX's does (the flag is
  stored, not read).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.conf.layers import rbm as trbm
from deeplearning4j_torch.nn.conf.layers import variational as tvar
from deeplearning4j_torch.nn.conf.layers.core import (AutoEncoder as
                                                      TAutoEncoder)
from deeplearning4j_torch.ops import random as trandom
from deeplearning4j_torch.utils.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu.nn.conf.layers import rbm as jrbm
from deeplearning4j_tpu.nn.conf.layers import variational as jvar
from deeplearning4j_tpu.nn.conf.layers.core import AutoEncoder as JAutoEncoder

pytestmark = pytest.mark.torch_port

F64_GRAD_ATOL = 1e-12
#: ulps between the port's f64 normal (torch.erfinv) and XLA's f64 erf_inv
F64_NORMAL_ULPS = 2 ** 13


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: _t(v) for k, v in tree.items()}


def _keys(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


# ------------------------------------------------------------------- PRNG
SEEDS = [0, 1, 7, 42, 123, 2 ** 31 - 1, 2 ** 32 + 5, -3]
SHAPES = [(1,), (7,), (64, 33), (3, 4, 5), (128, 30)]


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_f32_is_bitwise_jax(seed):
    jk, tk = _keys(seed)
    for shape in SHAPES:
        ref = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        got = trandom.normal(tk, shape, torch.float32).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_normal_f32_tails_and_many_keys():
    """Folded keys over a large draw reach both erf_inv branches (w >= 5
    beyond |z| ~ 2.8) and stay bitwise."""
    jk, tk = _keys(11)
    n_tail = 0
    for i in range(6):
        ref = np.asarray(jax.random.normal(jax.random.fold_in(jk, i),
                                           (200_000,), jnp.float32))
        got = trandom.normal(trandom.fold_in(tk, i), (200_000,)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        n_tail += int((np.abs(ref) > 2.9).sum())
    assert n_tail > 1000


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_f64_within_stated_ulps(seed):
    jk, tk = _keys(seed)
    for shape in SHAPES:
        ref = np.asarray(jax.random.normal(jk, shape, jnp.float64))
        got = trandom.normal(tk, shape, torch.float64).numpy()
        assert np.abs(_bits(got) - _bits(ref)).max() <= F64_NORMAL_ULPS


def test_normal_refuses_other_dtypes():
    with pytest.raises(TypeError, match="f32 or f64"):
        trandom.normal(trandom.PRNGKey(0, device="cpu"), (2,),
                       torch.bfloat16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_bernoulli_array_p_is_bitwise_jax(seed, dtype):
    jk, tk = _keys(seed)
    rs = np.random.RandomState(seed % 97)
    for shape in SHAPES:
        p = rs.rand(*shape).astype(dtype)
        ref = np.asarray(jax.random.bernoulli(jk, jnp.asarray(p)))
        got = trandom.bernoulli(tk, _t(p)).numpy()
        np.testing.assert_array_equal(got, ref)
    # a Python-float p keeps its f64 draw
    ref = np.asarray(jax.random.bernoulli(jk, 0.3, (40, 9)))
    np.testing.assert_array_equal(trandom.bernoulli(tk, 0.3, (40, 9)).numpy(),
                                  ref)


# -------------------------------------------------------------------- RBM
def _rbm_pair(n_in=6, n_out=4, seed=0, dtype=jnp.float64, **kw):
    jl = jrbm.RBM(n_in=n_in, n_out=n_out, bias_init=0.0, **kw)
    tl = trbm.RBM(n_in=n_in, n_out=n_out, bias_init=0.0, **kw)
    params = _np_tree(jl.init_params(jax.random.PRNGKey(seed), dtype=dtype))
    return jl, tl, params


def _grads_both(jl, tl, params, x, seed):
    jk, tk = _keys(seed)
    jg = jax.grad(lambda p: jnp.mean(jl.pretrain_loss_per_example(
        p, jnp.asarray(x), jk)))(_jtree(params))
    leaves = {k: v.requires_grad_(True) for k, v in _ttree(params).items()}
    loss = tl.pretrain_loss_per_example(leaves, _t(x), tk).mean()
    gs = torch.autograd.grad(loss, list(leaves.values()))
    return _np_tree(jg), {k: g.numpy() for k, g in zip(leaves, gs)}


class TestCdStatistics:
    def test_cd1_gradient_matches_hinton_statistics(self):
        """The surrogate's autograd gradient is -(pos - neg) computed by
        hand from the port's own chain, and JAX's gradient."""
        jl, tl, params = _rbm_pair()
        x = (np.random.RandomState(3).rand(8, 6) > 0.5).astype(np.float64)
        jg, tg = _grads_both(jl, tl, params, x, 7)
        h0, vk, hk = (a.numpy() for a in tl._gibbs_chain(
            _ttree(params), _t(x), trandom.PRNGKey(7, device="cpu")))
        B = x.shape[0]
        expect = {"W": -(x.T @ h0 - vk.T @ hk) / B,
                  "b": -np.mean(h0 - hk, axis=0),
                  "vb": -np.mean(x - vk, axis=0)}
        for k in expect:
            np.testing.assert_allclose(tg[k], expect[k], atol=1e-12,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(tg[k], jg[k], atol=F64_GRAD_ATOL,
                                       rtol=0, err_msg=k)

    def test_sparsity_replaces_hidden_bias_phase(self):
        jl, tl, params = _rbm_pair(sparsity=0.1)
        _, plain, _ = _rbm_pair()
        x = (np.random.RandomState(4).rand(5, 6) > 0.5).astype(np.float64)
        jg, tg = _grads_both(jl, tl, params, x, 1)
        _, tg_plain = _grads_both(jrbm.RBM(n_in=6, n_out=4, bias_init=0.0),
                                  plain, params, x, 1)
        h0 = tl._gibbs_chain(_ttree(params), _t(x),
                             trandom.PRNGKey(1, device="cpu"))[0].numpy()
        np.testing.assert_allclose(tg["b"], -np.mean(0.1 - h0, axis=0),
                                   atol=1e-12, rtol=0)
        for k in ("W", "vb"):
            np.testing.assert_allclose(tg[k], tg_plain[k], atol=1e-12,
                                       rtol=0)
        for k in tg:
            np.testing.assert_allclose(tg[k], jg[k], atol=F64_GRAD_ATOL,
                                       rtol=0)

    def test_cdk_chain_length(self):
        jl, tl, params = _rbm_pair(k=3)
        _, t1, _ = _rbm_pair()
        x = (np.random.RandomState(5).rand(4, 6) > 0.5).astype(np.float64)
        jg, g3 = _grads_both(jl, tl, params, x, 2)
        _, g1 = _grads_both(jrbm.RBM(n_in=6, n_out=4, bias_init=0.0), t1,
                            params, x, 2)
        assert all(np.isfinite(g3[k]).all() for k in g3)
        assert not np.allclose(g1["W"], g3["W"])
        for k in g3:
            np.testing.assert_allclose(g3[k], jg[k], atol=F64_GRAD_ATOL,
                                       rtol=0)

    @pytest.mark.parametrize("hidden,visible", [
        ("rectified", "gaussian"), ("gaussian", "linear"),
        ("identity", "identity"), ("binary", "binary")])
    def test_unit_variants_match_jax(self, hidden, visible):
        """Rectified and Gaussian hidden units draw ``normal`` in f64
        (within 2^13 ulps of JAX's), so their gradients agree to 1e-10."""
        jl, tl, params = _rbm_pair(hidden_unit=hidden, visible_unit=visible)
        x = np.random.RandomState(6).randn(4, 6) * 0.5
        jg, tg = _grads_both(jl, tl, params, x, 3)
        for k in tg:
            assert np.isfinite(tg[k]).all()
            np.testing.assert_allclose(tg[k], jg[k], atol=1e-10, rtol=0,
                                       err_msg=k)

    def test_validate_rejects_bad_units(self):
        with pytest.raises(ValueError, match="hidden_unit"):
            trbm.RBM(n_in=2, n_out=2, hidden_unit="softmax").validate()
        with pytest.raises(ValueError, match="visible_unit"):
            trbm.RBM(n_in=2, n_out=2, visible_unit="softmax").validate()
        with pytest.raises(ValueError, match="k must be"):
            trbm.RBM(n_in=2, n_out=2, k=0).validate()

    def test_f32_binary_sample_flips_are_counted(self):
        """In f32 a binary hidden unit is JAX's sample except where the
        uniform falls between torch's and XLA's sigmoid of it: count those
        flips over 1.3M units and bound them (at most 1 in 10^4; the
        sigmoids part by an ulp on a few values in a hundred)."""
        rs = np.random.RandomState(8)
        jl, tl, _ = _rbm_pair()
        flips = total = 0
        for i in range(5):
            pre = rs.randn(512, 512).astype(np.float32) * 3
            jk, tk = _keys(100 + i)
            ref = np.asarray(jl._hidden_sample(
                jk, jnp.asarray(pre), jax.nn.sigmoid(jnp.asarray(pre))))
            got = tl._hidden_sample(tk, _t(pre),
                                    torch.sigmoid(_t(pre))).numpy()
            flips += int((got != ref).sum())
            total += ref.size
        assert flips <= total // 10_000, (flips, total)


class TestRbmPretraining:
    @staticmethod
    def _patterned(n=128, seed=0):
        rs = np.random.RandomState(seed)
        protos = np.array([[1, 1, 1, 0, 0, 0, 1, 0],
                           [0, 0, 0, 1, 1, 1, 0, 1]], np.float64)
        x = protos[rs.randint(0, 2, n)]
        return np.where(rs.rand(n, 8) < 0.05, 1 - x, x)

    def test_pretrain_reduces_reconstruction_error(self):
        """60 epochs of CD-1 halve the reconstruction error, and end on
        JAX's parameters (f64, 1e-10)."""
        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

        x = self._patterned()

        def conf(pkg):
            m = _modules(pkg)
            return (m.b.NeuralNetConfiguration.builder().seed(12)
                    .updater(m.u.Sgd(learning_rate=0.5)).dtype("float64")
                    .list(m.L.RBM(n_out=4),
                          m.L.OutputLayer(n_out=2, activation="softmax",
                                          loss="mcxent"))
                    .set_input_type(m.i.InputType.feed_forward(8)).build())

        j, t = _pair(conf)
        lyr = t.layers[0]

        def recon_err(params):
            v = lyr.prop_down(params["0"], lyr.prop_up(params["0"], _t(x)))
            return float(((_t(x) - v) ** 2).mean())

        before = recon_err(t.params)
        assert t.pretrain(DataSet(x, None), epochs=60) is t
        assert recon_err(t.params) < before * 0.5
        j.pretrain(JDataSet(x, None), epochs=60)
        _assert_params(t, j, 1e-10)
        assert t.iteration == 0

    def test_supervised_gradcheck_through_rbm_forward(self):
        from deeplearning4j_torch.gradientcheck import check_gradients

        m = _modules("deeplearning4j_torch")
        conf = (m.b.NeuralNetConfiguration.builder().seed(42)
                .updater(m.u.Sgd(learning_rate=0.1)).weight_init("xavier")
                .dtype("float64")
                .list(m.L.RBM(n_out=5),
                      m.L.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(m.i.InputType.feed_forward(4)).build())
        net = m.M(conf).init(device="cpu")
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, (5, 4))
        y = np.eye(3)[rng.integers(0, 3, 5)]
        assert check_gradients(net, x, y)

    def test_pretrain_applies_weight_decay(self):
        """L2 acts on the pretrain gradient (smaller weights than without
        it), on the weights only, and as JAX's does (f32, 1e-6)."""
        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

        x = (np.random.RandomState(0).rand(64, 12) > 0.5).astype(np.float32)

        def norm_after(l2):
            def conf(pkg):
                m = _modules(pkg)
                return (m.b.NeuralNetConfiguration.builder().seed(1)
                        .updater(m.u.Sgd(learning_rate=0.05)).l2(l2)
                        .list(m.L.RBM(n_out=8),
                              m.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"))
                        .set_input_type(m.i.InputType.feed_forward(12))
                        .build())

            j, t = _pair(conf)
            t._pretrain_layer(0, [DataSet(x, None)] * 30, 1)
            j._pretrain_layer(0, [JDataSet(x, None)] * 30, 1)
            _assert_params(t, j, 1e-6)
            return float(np.linalg.norm(params_to_numpy(t)["0"]["W"]))

        assert norm_after(0.5) < norm_after(0.0)

    def test_moe_regularization_grad_tolerates_partial_params(self):
        from deeplearning4j_torch.nn.conf.layers import MixtureOfExpertsLayer

        moe = MixtureOfExpertsLayer(n_in=6, n_out=8, n_experts=2, top_k=1,
                                    expert_hidden=4, load_balance_coef=0.1)
        assert moe.regularization_grad({}) == {}

    def test_json_round_trip_and_jax_json(self):
        from deeplearning4j_torch.utils.serde import from_json, to_json
        from deeplearning4j_tpu.utils import serde as jserde

        kw = dict(n_in=6, n_out=4, hidden_unit="rectified",
                  visible_unit="gaussian", k=3, sparsity=0.05)
        lyr = trbm.RBM(**kw)
        assert from_json(to_json(lyr)) == lyr
        assert to_json(lyr) == jserde.to_json(jrbm.RBM(**kw))
        assert from_json(jserde.to_json(jrbm.RBM(**kw))) == lyr


# -------------------------------------------------------------------- VAE
def test_vae_bias_params_excluded_from_weight_decay():
    vae = tvar.VariationalAutoencoder(n_in=4, n_out=2,
                                      encoder_layer_sizes=(3,),
                                      decoder_layer_sizes=(3,), l2=0.5)
    vae.finalize(None)
    biases = vae.bias_param_names()
    assert {"eb0", "db0", "mb", "lb", "rb"} <= set(biases)
    params = vae.init_params(torch.Generator().manual_seed(0))
    reg = float(vae.regularization(params))
    expected = sum(0.5 * 0.5 * float((v * v).sum())
                   for k, v in params.items() if k not in biases)
    assert np.isclose(reg, expected, rtol=1e-6)
    jv = jvar.VariationalAutoencoder(n_in=4, n_out=2,
                                     encoder_layer_sizes=(3,),
                                     decoder_layer_sizes=(3,), l2=0.5)
    assert jv.bias_param_names() == biases
    assert jv.param_order() == vae.param_order()


DISTS = {
    "gaussian": lambda m: m.GaussianReconstructionDistribution(),
    "gaussian_tanh": lambda m: m.GaussianReconstructionDistribution(
        activation="tanh"),
    "bernoulli": lambda m: m.BernoulliReconstructionDistribution(),
    "bernoulli_hardsigmoid": lambda m: m.BernoulliReconstructionDistribution(
        activation="hardsigmoid"),
    "exponential": lambda m: m.ExponentialReconstructionDistribution(),
    "loss_wrapper": lambda m: m.LossFunctionWrapper(loss="mse",
                                                    activation="sigmoid"),
    "composite": lambda m: m.CompositeReconstructionDistribution(
        sizes=[3, 4], distributions=[m.GaussianReconstructionDistribution(),
                                     m.BernoulliReconstructionDistribution()]),
}


def _dist_inputs(name, n=7, seed=0):
    rs = np.random.RandomState(seed)
    head = {"gaussian": 2 * n, "gaussian_tanh": 2 * n,
            "composite": 2 * 3 + 4}.get(name, n)
    x = rs.rand(5, n)
    if "bernoulli" in name or name == "composite":
        x = (x > 0.5).astype(np.float64)
    return x, rs.randn(5, head) * 2.0


@pytest.mark.parametrize("name", sorted(DISTS))
def test_reconstruction_distribution_matches_jax(name):
    """``neg_log_prob``, ``sample_mean`` and ``head_size`` of each
    distribution equal JAX's in f64 (rtol 1e-12); the JSON is JAX's."""
    from deeplearning4j_torch.utils.serde import from_json, to_json
    from deeplearning4j_tpu.utils import serde as jserde

    jd, td = DISTS[name](jvar), DISTS[name](tvar)
    x, head = _dist_inputs(name)
    assert td.head_size(7) == jd.head_size(7) == head.shape[1]
    np.testing.assert_allclose(
        td.neg_log_prob(_t(x), _t(head)).numpy(),
        np.asarray(jd.neg_log_prob(jnp.asarray(x), jnp.asarray(head))),
        rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        td.sample_mean(_t(head), 7).numpy(),
        np.asarray(jd.sample_mean(jnp.asarray(head), 7)), rtol=1e-12,
        atol=0)
    assert to_json(td) == jserde.to_json(jd)
    assert from_json(jserde.to_json(jd)) == td


def _vae_pair(dist="bernoulli", n_samples=2, dtype=jnp.float64, **kw):
    args = dict(n_in=7, n_out=3, encoder_layer_sizes=(5, 4),
                decoder_layer_sizes=(4,), n_samples=n_samples, **kw)
    jl = jvar.VariationalAutoencoder(
        reconstruction_distribution=DISTS[dist](jvar), **args)
    tl = tvar.VariationalAutoencoder(
        reconstruction_distribution=DISTS[dist](tvar), **args)
    for lyr in (jl, tl):
        lyr.finalize(None)
    params = _np_tree(jl.init_params(jax.random.PRNGKey(4), dtype=dtype))
    return jl, tl, params


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "composite"])
def test_vae_elbo_and_gradients_match_jax(dist):
    """The -ELBO per example (``n_samples`` = 2 draws of ε) and its
    gradients equal JAX's in f64 (rtol 1e-9: ε within 2^13 ulps, amplified
    by ``exp(logvar / 2)``)."""
    jl, tl, params = _vae_pair(dist)
    x, _ = _dist_inputs(dist, seed=2)
    jk, tk = _keys(9)
    jloss, jg = jax.value_and_grad(lambda p: jnp.mean(
        jl.pretrain_loss_per_example(p, jnp.asarray(x), jk)))(_jtree(params))
    per = jl.pretrain_loss_per_example(_jtree(params), jnp.asarray(x), jk)
    leaves = {k: v.requires_grad_(True) for k, v in _ttree(params).items()}
    tper = tl.pretrain_loss_per_example(leaves, _t(x), tk)
    np.testing.assert_allclose(tper.detach().numpy(), np.asarray(per),
                               rtol=1e-9, atol=0)
    gs = torch.autograd.grad(tper.mean(), list(leaves.values()))
    for k, g in zip(leaves, gs):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def test_vae_forward_reconstruct_generate_match_jax():
    jl, tl, params = _vae_pair("gaussian")
    x, _ = _dist_inputs("gaussian", seed=3)
    z = np.random.RandomState(5).randn(4, 3)
    jp, tp = _jtree(params), _ttree(params)
    np.testing.assert_allclose(
        tl.forward(tp, {}, _t(x))[0].numpy(),
        np.asarray(jl.forward(jp, {}, jnp.asarray(x))[0]), rtol=1e-12)
    np.testing.assert_allclose(tl.reconstruct(tp, _t(x)).numpy(),
                               np.asarray(jl.reconstruct(jp, jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(tl.generate(tp, _t(z)).numpy(),
                               np.asarray(jl.generate(jp, jnp.asarray(z))),
                               rtol=1e-12)


# ------------------------------------------------------------ AutoEncoder
@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_loss_and_gradients_match_jax(corruption):
    """The corruption mask is JAX's bit for bit, so the reconstruction
    loss and its gradients agree to f64 rounding (rtol 1e-12)."""
    kw = dict(n_in=9, n_out=5, corruption_level=corruption,
              activation="sigmoid", loss="mse", bias_init=0.1)
    jl, tl = JAutoEncoder(**kw), TAutoEncoder(**kw)
    params = _np_tree(jl.init_params(jax.random.PRNGKey(2),
                                     dtype=jnp.float64))
    assert set(params) == {"W", "b", "vb"}
    x = np.random.RandomState(1).rand(6, 9)
    jk, tk = _keys(5)
    jloss, jg = jax.value_and_grad(lambda p: jnp.mean(
        jl.reconstruction_loss_per_example(p, jnp.asarray(x), jk)))(
            _jtree(params))
    leaves = {k: v.requires_grad_(True) for k, v in _ttree(params).items()}
    loss = tl.reconstruction_loss_per_example(leaves, _t(x), tk).mean()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-12)
    for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-10,
                                   atol=1e-14, err_msg=k)
    np.testing.assert_allclose(
        tl.forward(_ttree(params), {}, _t(x))[0].numpy(),
        np.asarray(jl.forward(_jtree(params), {}, jnp.asarray(x))[0]),
        rtol=1e-12)


# ------------------------------------------------------------- the stack
class _M:
    pass


def _modules(pkg):
    m = _M()
    m.b = importlib.import_module(f"{pkg}.nn.conf.builders")
    m.L = importlib.import_module(f"{pkg}.nn.conf.layers")
    m.i = importlib.import_module(f"{pkg}.nn.conf.inputs")
    m.u = importlib.import_module(f"{pkg}.nn.updater")
    m.M = importlib.import_module(f"{pkg}.nn.multilayer").MultiLayerNetwork
    m.D = importlib.import_module(f"{pkg}.datasets.dataset").DataSet
    return m


def _pair(conf_of):
    """A JAX net and a port net from the same configuration factory, the
    port on the JAX net's parameters."""
    jm, tm = _modules("deeplearning4j_tpu"), _modules("deeplearning4j_torch")
    j = jm.M(conf_of("deeplearning4j_tpu")).init()
    t = tm.M(conf_of("deeplearning4j_torch")).init(device="cpu")
    params_from_jax(jax.device_get(j.params), t)
    return j, t


def _assert_params(t, j, atol):
    ref = jax.device_get(j.params)
    got = params_to_numpy(t)
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], np.asarray(ref[v][k]),
                                       atol=atol, rtol=0,
                                       err_msg=f"{v}.{k}")


def _stack_conf(dtype, pretrain=False):
    def conf(pkg):
        m = _modules(pkg)
        L = m.L
        return (m.b.NeuralNetConfiguration.builder().seed(3)
                .updater(m.u.Adam(learning_rate=0.01)).dtype(dtype).l2(1e-3)
                .list(L.RBM(n_out=12),
                      L.AutoEncoder(n_out=10, corruption_level=0.3),
                      L.VariationalAutoencoder(
                          n_out=4, encoder_layer_sizes=(8,),
                          decoder_layer_sizes=(8,), n_samples=2,
                          reconstruction_distribution=(
                              L.BernoulliReconstructionDistribution())),
                      L.RBM(n_out=6, hidden_unit="rectified",
                            visible_unit="gaussian", k=2),
                      L.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
                .pretrain(pretrain)
                .set_input_type(m.i.InputType.feed_forward(16)).build())
    return conf


def _stack_batches(dtype, n=3):
    rs = np.random.RandomState(0)
    return [(rs.rand(8, 16) > 0.5).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-13),
                                        ("float32", 1e-6)])
def test_pretrain_stack_matches_jax(dtype, atol):
    """``pretrain`` over RBM, AutoEncoder, VAE and a rectified/Gaussian
    CD-2 RBM, two epochs over three batches under Adam and L2: every
    layer ends on JAX's parameters; the output layer is untouched and
    ``iteration`` stays 0."""
    j, t = _pair(_stack_conf(dtype))
    head = params_to_numpy(t)["4"]
    xs = _stack_batches(dtype)
    jm, tm = _modules("deeplearning4j_tpu"), _modules("deeplearning4j_torch")
    j.pretrain([jm.D(x, None) for x in xs], epochs=2)
    t.pretrain([tm.D(x, None) for x in xs], epochs=2)
    _assert_params(t, j, atol)
    for k, v in head.items():
        np.testing.assert_array_equal(params_to_numpy(t)["4"][k], v)
    assert t.iteration == j.iteration == 0


@pytest.mark.parametrize("layer", ["rbm", "autoencoder", "vae"])
def test_one_pretrain_step_per_layer_type_matches_jax(layer):
    """One ``_pretrain_layer`` step of each layer type above a Dense layer
    (so the lower forward runs) from JAX's parameters, f32: within 1e-6,
    and the per-step loss within rtol 1e-5."""
    def conf(pkg):
        m = _modules(pkg)
        L = m.L
        lyr = {"rbm": lambda: L.RBM(n_out=7),
               "autoencoder": lambda: L.AutoEncoder(n_out=7),
               "vae": lambda: L.VariationalAutoencoder(
                   n_out=3, encoder_layer_sizes=(6,),
                   decoder_layer_sizes=(6,))}[layer]()
        return (m.b.NeuralNetConfiguration.builder().seed(5)
                .updater(m.u.Sgd(learning_rate=0.1))
                .list(L.DenseLayer(n_out=9, activation="tanh"), lyr,
                      L.OutputLayer(n_out=2, activation="softmax",
                                    loss="mcxent"))
                .set_input_type(m.i.InputType.feed_forward(11)).build())

    j, t = _pair(conf)
    x = np.random.RandomState(7).rand(10, 11).astype(np.float32)
    jm, tm = _modules("deeplearning4j_tpu"), _modules("deeplearning4j_torch")
    j._pretrain_layer(1, jm.D(x, None), 1)
    losses = t._pretrain_layer(1, tm.D(x, None), 1)
    assert len(losses) == 1 and np.isfinite(float(losses[0]))
    _assert_params(t, j, 1e-6)


def test_fit_with_pretrain_flag_trains_as_jax():
    """C13: JAX's ``fit`` does not read ``conf.pretrain``; the port's
    trains the same supervised steps with the flag set (f64, 1e-12), and
    the flag survives in the configuration."""
    j, t = _pair(_stack_conf("float64", pretrain=True))
    rs = np.random.RandomState(2)
    x = (rs.rand(8, 16) > 0.5).astype(np.float64)
    y = np.eye(3)[rs.randint(0, 3, 8)]
    j.fit(x, y, epochs=2)
    t.fit(x, y, epochs=2)
    assert t.conf.pretrain and j.conf.pretrain
    assert t.iteration == j.iteration == 2
    _assert_params(t, j, 1e-12)


def test_zips_both_ways(tmp_path):
    """A JAX MultiLayerNetwork with RBM, AutoEncoder and VAE layers saved
    by JAX loads in the port with equal outputs (f32, 1e-6) and equal
    configuration JSON; the port's zip of it loads in JAX with equal
    parameters and outputs."""
    from deeplearning4j_torch.utils import model_serializer as tms
    from deeplearning4j_tpu.utils import model_serializer as jms

    j, t = _pair(_stack_conf("float32"))
    x = _stack_batches("float32", 1)[0]
    jm = _modules("deeplearning4j_tpu")
    j.pretrain([jm.D(x, None)])          # weights that are not the draw
    jpath = str(tmp_path / "jax.zip")
    jms.save_model(j, jpath)
    loaded = tms.load_model(jpath, device="cpu")
    ref = np.asarray(j.output(x))
    np.testing.assert_allclose(loaded.output(x).numpy(), ref, atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(loaded.params_flat(),
                                  np.asarray(j.params_flat()))
    tpath = str(tmp_path / "port.zip")
    tms.save_model(loaded, tpath)
    back = jms.load_model(tpath)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  np.asarray(j.params_flat()))
    np.testing.assert_allclose(np.asarray(back.output(x)), ref, atol=1e-6,
                               rtol=0)
    assert type(back.layers[2].reconstruction_distribution).__name__ == \
        "BernoulliReconstructionDistribution"
    assert math.isclose(back.layers[1].corruption_level, 0.3)
