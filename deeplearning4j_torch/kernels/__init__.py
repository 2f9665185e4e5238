"""Hand-written Hopper kernels of the port and their loader.

Sources (all in this directory):

- ``flash_fwd.cuh``: flash-attention forward, the port of
  ``deeplearning4j_tpu/ops/pallas_attention.py::_attn_fwd_kernel``,
  instantiated at the widths up to 128 by ``flash_fwd.cu`` (with the C
  entry points) and past 128 by ``flash_fwd_wide.cu``;
- ``paged_attn.cuh``: paged-KV attention read, the port of
  ``deeplearning4j_tpu/nn/conf/layers/paged_attention.py::_paged_attn_kernel``,
  instantiated at the exact head dims up to 128 by ``paged_attn.cu`` (with
  the C entry points), at the padded ones up to 128 by
  ``paged_attn_pad.cu`` (decode route) and ``paged_attn_pad_chunk.cu``
  (chunk route; ``paged_attn_pad_chunk_int8.cu`` over int8 pages) and past
  128 by ``paged_attn_wide.cu``;
- ``flash_bwd.cuh``: flash-attention backward, dQ and dK/dV, the ports of
  ``deeplearning4j_tpu/ops/pallas_attention.py::_attn_dq_kernel`` and
  ``::_attn_dkv_kernel``, instantiated by ``flash_bwd.cu`` (K3),
  ``flash_bwd_dkv.cu`` (K4) and ``flash_bwd_wide.cu`` (both past 128);
- ``bindings.cpp``: the one small file that includes PyTorch's headers. It
  checks each launch with ``C10_CUDA_KERNEL_LAUNCH_CHECK()``;
- headers: ``common.cuh`` (the masked-score constants and the head-dim
  padding rule, ``kernel_width`` below), ``mma.cuh``
  (``mma.sync`` TF32/bf16/f16, the TF32 hi/lo split, ``ldmatrix``,
  ``cp.async``) and ``attn_tile.cuh`` (the tensor-core tile products,
  A-fragment loads, ``cp.async`` ring staging and epilogue stores that K1,
  K3, K4 and K2's chunk route share).

``load()`` builds all of them in one ``torch.utils.cpp_extension.load`` call
for ``sm_90a`` into ``kernels/build/`` (listed in ``.gitignore``) at first
use, each translation unit in a compiler of its own (ninja runs them in
parallel); nothing is built at import. The wrappers in ``ops/flash_attention.py``
and ``nn/conf/layers/paged_attention.py`` add one to ``LAUNCHES`` per launch,
so a run can show which kernels its main path went through (K2's chunk
route and its merge pass also count under their own names), and to
``LAUNCHES_BY_D`` under ``(name, head dim)``.

Head dims: every kernel is instantiated at 8, 16, 32, 64, 128 and 256 for a
head dim of exactly that width, and takes any other ``d`` with
``1 <= d <= 256`` in a padded instantiation (``kernel_width``; K2's decode
route at ``decode_width``): zero columns past ``d`` in its tiles, rows of
``d`` elements in device memory, the scale ``1/√d``. Rows that are not a
multiple of 4 bytes (16-bit rows of odd ``d``, int8 rows of ``d % 4 != 0``)
are staged by element loads. Past a width of 128 each tile's output
columns are split over two CTAs (``kernels/common.cuh``). A head dim over
256, or an f64 tensor, raises before a launch.
"""

from __future__ import annotations

import os
import threading

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
SOURCES = ("bindings.cpp", "flash_fwd.cu", "flash_fwd_wide.cu",
           "paged_attn.cu", "paged_attn_pad.cu", "paged_attn_pad_chunk.cu",
           "paged_attn_pad_chunk_int8.cu", "paged_attn_wide.cu",
           "flash_bwd.cu", "flash_bwd_dkv.cu", "flash_bwd_wide.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-lineinfo")

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"flash_fwd": 0, "paged_attn": 0, "paged_attn_chunk": 0,
            "paged_attn_merge": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
#: the same by ``(kernel, head dim)``
LAUNCHES_BY_D: dict = {}

#: the widths the kernels are instantiated at (``common.cuh``): a head dim
#: d runs at the first width >= d, which is below d + 32
KERNEL_WIDTHS = (8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 224, 256)
#: head dims with an instantiation of their own width, unpadded
EXACT_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: the largest head dim the kernels take
MAX_HEAD_DIM = 256
#: what the kernels take, for error messages
HEAD_DIM_RULE = "head dims 1..256"

_ext = None
_lock = threading.Lock()
#: guards ``LAUNCHES`` and ``LAUNCHES_BY_D``: fleet replicas count launches
#: from their own loop threads at once
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LAUNCHES_BY_D.clear()


def count_launch(name: str, d: int) -> None:
    """One launch of kernel ``name`` at head dim ``d``."""
    with _count_lock:
        LAUNCHES[name] += 1
        LAUNCHES_BY_D[(name, d)] = LAUNCHES_BY_D.get((name, d), 0) + 1


def kernel_width(d: int):
    """The width a head dim ``d`` runs at in K1, K3, K4 and K2's chunk
    route (``d`` itself at the widths of ``KERNEL_WIDTHS``, else the next
    of them; 8 for d = 1..3), or None where no kernel takes ``d``."""
    if not 1 <= d <= MAX_HEAD_DIM:
        return None
    return next(w for w in KERNEL_WIDTHS if w >= d)


def decode_width(d: int):
    """The width K2's decode route runs a head dim ``d`` at: the next
    power of two (its lanes split a key row in a power-of-two group), or
    None where no kernel takes ``d``."""
    if kernel_width(d) is None:
        return None
    return next(w for w in EXACT_HEAD_DIMS if w >= d)


def load(verbose: bool = False):
    """Build (once per process) and return the kernel extension. Raises on
    a host without CUDA: the kernels never run anywhere else."""
    global _ext
    if _ext is not None:
        return _ext
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the Hopper kernels need a CUDA device; tensors on the CPU take "
            "the plain PyTorch path instead")
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load as cpp_load

            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = cpp_load(
                name="dl4j_torch_kernels",
                sources=[os.path.join(_DIR, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=verbose)
    return _ext
