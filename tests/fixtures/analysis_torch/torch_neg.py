"""Must-NOT-flag cases for the torch rules (graftcheck fixture — never
imported, only parsed)."""
import random as stdlib_random

import numpy as np
import torch

from deeplearning4j_torch.ops import random


def keyed_draws(key, shape):
    # the port's keyed RNG (jax.random bit for bit), imported under the
    # bare name ``random``: resolved through the import, not the stdlib
    k1, k2 = random.split(key)
    u = random.uniform(k1, shape, torch.float32)
    n = random.normal(k2, shape, torch.float32)
    b = random.bernoulli(key, 0.5, shape)
    return u, n, b, random.fold_in(key, 3)


def seeded_draws(seed, shape, t):
    # explicit generators and seeded constructors
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand(shape, generator=g)
    y = torch.randn(shape, generator=g)
    p = torch.randperm(8, generator=g)
    t.uniform_(generator=g)
    t.normal_(0.0, 1.0, generator=g)
    rng = np.random.default_rng(seed)
    rs = np.random.RandomState(seed)
    r = stdlib_random.Random(seed)
    return x, y, p, rng.normal(size=3), rs.randn(3), r.random()


def cold_path(x):
    # not a hot-loop name: host copies are fine here
    return x.cpu().numpy().tolist(), float(x.sum()), x.item()


def _decode_once(toks, parts):
    # hot-loop name, but nothing here syncs: literals, str.join, a
    # non-blocking copy TO the card, a device-side reduction
    k = int(3)
    z = np.asarray(0)
    label = ",".join(parts)
    dev = toks.to("cuda", non_blocking=True)
    return k, z, label, dev.sum(dim=-1)
