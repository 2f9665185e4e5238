"""Hand-written Hopper kernels of the port and their loader.

Sources (all in this directory):

- ``flash_fwd.cu``: flash-attention forward, the port of
  ``deeplearning4j_tpu/ops/pallas_attention.py::_attn_fwd_kernel``;
- ``paged_attn.cu``: paged-KV attention read, the port of
  ``deeplearning4j_tpu/nn/conf/layers/paged_attention.py::_paged_attn_kernel``;
- ``flash_bwd.cu``: flash-attention backward, dQ and dK/dV, the ports of
  ``deeplearning4j_tpu/ops/pallas_attention.py::_attn_dq_kernel`` and
  ``::_attn_dkv_kernel``;
- ``bindings.cpp``: the one small file that includes PyTorch's headers. It
  checks each launch with ``C10_CUDA_KERNEL_LAUNCH_CHECK()``;
- headers: ``common.cuh`` (tile geometry, conversions, warp reductions and
  the CUDA-core tile helpers of the paged chunk route), ``mma.cuh``
  (``mma.sync`` TF32/bf16, the TF32 hi/lo split, ``ldmatrix``,
  ``cp.async``) and ``attn_tile.cuh`` (the tensor-core tile products,
  A-fragment loads, ``cp.async`` ring staging and epilogue stores that K1,
  K3 and K4 share).

``load()`` builds all of them in one ``torch.utils.cpp_extension.load`` call
for ``sm_90a`` into ``kernels/build/`` (listed in ``.gitignore``) at first
use; nothing is built at import. The wrappers in ``ops/flash_attention.py``
and ``nn/conf/layers/paged_attention.py`` add one to ``LAUNCHES`` per launch,
so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import os
import threading

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
SOURCES = ("bindings.cpp", "flash_fwd.cu", "paged_attn.cu", "flash_bwd.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-lineinfo")

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"flash_fwd": 0, "paged_attn": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
