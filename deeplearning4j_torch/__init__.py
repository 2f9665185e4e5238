"""deeplearning4j_torch: the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package stays the reference; this package keeps its module paths,
names and public layouts (Dense ``W`` is ``[n_in, n_out]`` applied as
``x @ W``; attention tensors are ``[B, H, T, d]``; KV pools are
``[P, H, ps, d]``) so each module's counterpart is easy to find.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit device they raise instead of quietly running on
the host. The hand-written Hopper kernels live in ``kernels/`` and build at
first use.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the host only
    when the caller asks for it. Never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deeplearning4j_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the host")
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        # "cuda" and "cuda:<current>" name one card: compare them equal
        d = torch.device("cuda", torch.cuda.current_device())
    return d
