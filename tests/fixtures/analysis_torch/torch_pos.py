"""Must-flag cases for every torch rule (graftcheck fixture — never
imported, only parsed)."""
import random

import numpy as np
import torch
from torch.cuda import synchronize


def _decode_once(state, logits):
    # hot-loop function name: every one of these is a per-iteration
    # device->host sync
    a = logits.argmax(-1).cpu()           # POSITIVE .cpu()
    b = logits[0].tolist()                # POSITIVE .tolist()
    c = logits.detach().numpy()           # POSITIVE .numpy()
    torch.cuda.synchronize()              # POSITIVE torch.cuda.synchronize()
    d = state.val.item()                  # POSITIVE .item()
    e = float(state.loss)                 # POSITIVE float()
    f = np.asarray(state.rows)            # POSITIVE np.asarray
    return a, b, c, d, e, f


def _run_block(losses):
    # the second .cpu() in one hot function gets its own occurrence index
    first = losses[0].cpu()               # POSITIVE .cpu() (1)
    rest = losses[1:].cpu()               # POSITIVE .cpu() (2)
    synchronize()                         # POSITIVE via the import alias
    return first, rest


def global_torch_draws(shape, probs, t):
    # POSITIVE torch-global-randomness: the global torch generator
    x = torch.rand(shape)
    y = torch.randn(shape)
    z = torch.randint(0, 5, shape)
    p = torch.randperm(8)
    m = torch.multinomial(probs, 1)
    b = torch.bernoulli(probs)
    n = torch.normal(0.0, 1.0, size=shape)
    t.uniform_()
    t.normal_(0.0, 1.0)
    t.bernoulli_(0.5)
    t.random_(0, 10)
    torch.nn.init.normal_(t)
    return x, y, z, p, m, b, n


def global_host_draws(n):
    # POSITIVE torch-global-randomness: numpy's and the stdlib's global
    # states, and generators built without a seed
    a = np.random.randn(n)
    np.random.shuffle(a)
    b = random.random()
    c = random.choice([1, 2, 3])
    rng = np.random.default_rng()
    rs = random.Random()
    return a, b, c, rng, rs
