"""The variational autoencoder layer and its reconstruction distributions
(port of ``deeplearning4j_tpu/nn/conf/layers/variational.py``).

The whole -ELBO (a reparameterised sample, the reconstruction negative
log-likelihood and the analytic KL(q(z|x) || N(0, I))) is one
differentiable expression; layer-wise pretraining takes autograd of it.
The noise ε is ``ops/random.normal`` on the keys ``split(rng,
n_samples)``, JAX's draws (bitwise in f32). As a layer inside a network
the VAE outputs the latent mean.

The distributions are registered for serde under JAX's class names, so a
configuration holding them loads in either package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.ops.activations import get_activation
from deeplearning4j_torch.ops.losses import get_loss
from deeplearning4j_torch.utils.serde import register_serializable

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@register_serializable
@dataclass
class GaussianReconstructionDistribution:
    """p(x|z) = N(mean(z), exp(logvar(z))); the head is ``2 · n_visible``
    wide (means, then log-variances)."""

    activation: str = "identity"

    def head_size(self, n_visible: int) -> int:
        return 2 * n_visible

    def neg_log_prob(self, x, head_pre):
        n = x.shape[-1]
        mean = get_activation(self.activation)(head_pre[..., :n])
        logvar = head_pre[..., n:]
        var = torch.exp(logvar)
        return (_HALF_LOG_2PI + 0.5 * logvar
                + 0.5 * (x - mean) ** 2 / var).sum(dim=-1)

    def sample_mean(self, head_pre, n_visible):
        return get_activation(self.activation)(head_pre[..., :n_visible])


@register_serializable
@dataclass
class BernoulliReconstructionDistribution:
    """p(x|z) = Bernoulli(activation(head)); under a sigmoid the
    cross-entropy takes the stable form ``max(z, 0) - z·x +
    log1p(exp(-|z|))`` of the logits."""

    activation: str = "sigmoid"

    def head_size(self, n_visible: int) -> int:
        return n_visible

    def neg_log_prob(self, x, head_pre):
        if self.activation == "sigmoid":
            z = head_pre
            per = (torch.clamp(z, min=0.0) - z * x
                   + torch.log1p(torch.exp(-z.abs())))
        else:
            p = torch.clamp(get_activation(self.activation)(head_pre),
                            1e-7, 1.0 - 1e-7)
            per = -(x * torch.log(p) + (1 - x) * torch.log(1 - p))
        return per.sum(dim=-1)

    def sample_mean(self, head_pre, n_visible):
        return get_activation(self.activation)(head_pre)


@register_serializable
@dataclass
class ExponentialReconstructionDistribution:
    """p(x|z) = Exp(λ = exp(activation(head)))."""

    activation: str = "identity"

    def head_size(self, n_visible: int) -> int:
        return n_visible

    def neg_log_prob(self, x, head_pre):
        log_lambda = get_activation(self.activation)(head_pre)
        return (torch.exp(log_lambda) * x - log_lambda).sum(dim=-1)

    def sample_mean(self, head_pre, n_visible):
        return 1.0 / torch.exp(get_activation(self.activation)(head_pre))


@register_serializable
@dataclass
class LossFunctionWrapper:
    """A standard loss used as the reconstruction 'distribution'."""

    loss: str = "mse"
    activation: str = "identity"

    def head_size(self, n_visible: int) -> int:
        return n_visible

    def neg_log_prob(self, x, head_pre):
        return get_loss(self.loss).per_example(
            x, head_pre, get_activation(self.activation))

    def sample_mean(self, head_pre, n_visible):
        return get_activation(self.activation)(head_pre)


@register_serializable
@dataclass
class CompositeReconstructionDistribution:
    """Different distributions over consecutive slices of the visible
    vector (``sizes[i]`` units under ``distributions[i]``)."""

    sizes: list = field(default_factory=list)
    distributions: list = field(default_factory=list)

    def head_size(self, n_visible: int) -> int:
        return sum(d.head_size(s) for d, s in zip(self.distributions,
                                                  self.sizes))

    def neg_log_prob(self, x, head_pre):
        total = 0.0
        xi = hi = 0
        for d, s in zip(self.distributions, self.sizes):
            hs = d.head_size(s)
            total = total + d.neg_log_prob(x[..., xi:xi + s],
                                           head_pre[..., hi:hi + hs])
            xi += s
            hi += hs
        return total

    def sample_mean(self, head_pre, n_visible):
        outs = []
        hi = 0
        for d, s in zip(self.distributions, self.sizes):
            hs = d.head_size(s)
            outs.append(d.sample_mean(head_pre[..., hi:hi + hs], s))
            hi += hs
        return torch.cat(outs, dim=-1)


@register_serializable
@dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """VAE pretrain layer: ``n_in`` visible units, ``n_out`` latent units,
    hidden encoder and decoder layers of ``encoder_layer_sizes`` and
    ``decoder_layer_sizes`` under ``activation``, the q(z|x) mean head
    under ``pzx_activation``, and ``n_samples`` draws of z per example in
    the loss."""

    encoder_layer_sizes: tuple = (100,)
    decoder_layer_sizes: tuple = (100,)
    reconstruction_distribution: object = None
    pzx_activation: str = "identity"
    n_samples: int = 1

    DEFAULT_ACTIVATION = "tanh"

    def __post_init__(self):
        if self.reconstruction_distribution is None:
            self.reconstruction_distribution = (
                GaussianReconstructionDistribution())
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_order(self):
        order = []
        for i in range(len(self.encoder_layer_sizes)):
            order += [f"eW{i}", f"eb{i}"]
        order += ["mW", "mb", "lW", "lb"]
        for i in range(len(self.decoder_layer_sizes)):
            order += [f"dW{i}", f"db{i}"]
        return order + ["rW", "rb"]

    def bias_param_names(self):
        names = {f"eb{i}" for i in range(len(self.encoder_layer_sizes))}
        names |= {f"db{i}" for i in range(len(self.decoder_layer_sizes))}
        return frozenset(names | {"mb", "lb", "rb"})

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        params = {}

        def dense(wname, bname, n_in, n_out):
            params[wname] = self._init_w(gen, (n_in, n_out), n_in, n_out,
                                         dtype, device)
            params[bname] = torch.zeros(n_out, dtype=dtype, device=device)

        prev = self.n_in
        for i, size in enumerate(self.encoder_layer_sizes):
            dense(f"eW{i}", f"eb{i}", prev, size)
            prev = size
        dense("mW", "mb", prev, self.n_out)
        dense("lW", "lb", prev, self.n_out)
        prev = self.n_out
        for i, size in enumerate(self.decoder_layer_sizes):
            dense(f"dW{i}", f"db{i}", prev, size)
            prev = size
        dense("rW", "rb", prev,
              self.reconstruction_distribution.head_size(self.n_in))
        return params

    def _encode(self, params, x):
        act = self.act()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"eW{i}"]) + params[f"eb{i}"])
        mean = get_activation(self.pzx_activation)(
            torch.matmul(h, params["mW"]) + params["mb"])
        logvar = torch.matmul(h, params["lW"]) + params["lb"]
        return mean, logvar

    def _decode(self, params, z):
        act = self.act()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"dW{i}"]) + params[f"db{i}"])
        return torch.matmul(h, params["rW"]) + params["rb"]

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        mean, _ = self._encode(params, x)
        return mean, state

    def pretrain_loss_per_example(self, params, x, rng):
        """-ELBO per example: the mean reconstruction NLL over
        ``n_samples`` draws ``z = mean + exp(logvar / 2)·ε`` plus the
        analytic KL to N(0, I)."""
        mean, logvar = self._encode(params, x)
        kl = 0.5 * (torch.exp(logvar) + mean ** 2 - 1.0 - logvar).sum(dim=-1)
        total_recon = 0.0
        keys = random.split(rng, self.n_samples)
        for i in range(self.n_samples):
            eps = random.normal(keys[i], mean.shape, mean.dtype)
            z = mean + torch.exp(0.5 * logvar) * eps
            total_recon = total_recon + \
                self.reconstruction_distribution.neg_log_prob(
                    x, self._decode(params, z))
        return total_recon / self.n_samples + kl

    def reconstruct(self, params, x):
        """Encode to the latent mean, decode, return the reconstruction
        distribution's mean."""
        mean, _ = self._encode(params, x)
        return self.reconstruction_distribution.sample_mean(
            self._decode(params, mean), self.n_in)

    def generate(self, params, z):
        return self.reconstruction_distribution.sample_mean(
            self._decode(params, z), self.n_in)
