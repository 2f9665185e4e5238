"""Rules the PyTorch port keeps:

- no file of ``deeplearning4j_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or ``deeplearning4j_tpu``;
- entry points called with ``device=None`` raise on a host without CUDA
  instead of quietly running on the CPU;
- a kernel wrapper handed CUDA tensors on a host without CUDA raises, and
  never computes the plain version on the CPU instead; so does a CUDA case
  the kernels do not take (head dim 48, f16 flash, f64 paged); a bf16 or
  f16 paged query (K2 takes them) reaches the kernel's build;
- ``fit`` refuses what the port does not have yet (the fused K-step driver,
  the health guard, regularization) instead of training without it.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.conf.layers import (  # noqa: E402
    attention as patt, paged_attention as ppa)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_torch.ops import random as prandom  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")
TINY = dict(num_labels=11, max_length=8, d_model=32, n_heads=1, n_blocks=1,
            max_cache=32)


def _port_files():
    files = sorted((ROOT / "deeplearning4j_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT / "deeplearning4j_torch"))
             for p in files if "deeplearning4j_torch" in p.parts}
    # the training slice's modules are covered too
    assert {"ops/losses.py", "nn/updater.py", "datasets/dataset.py",
            "optimize/fused_fit.py", "utils/convert.py"} <= names
    bad = [(str(p.relative_to(ROOT)), mod) for p in files
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**TINY).init()
    net = TransformerLM(**TINY).init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationServer(net, 11)


def test_prng_key_lands_on_the_card(no_cuda):
    """``PRNGKey`` is an entry point: its key is made on the card, so with
    no CUDA device it raises unless the caller asks for the host."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prandom.PRNGKey(0)
    assert prandom.PRNGKey(0, device="cpu").device.type == "cpu"


def test_server_refuses_a_net_on_another_device():
    net = TransformerLM(**TINY).init(device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        GenerationServer(net, 11, device="meta")


def _no_plain(*_a, **_k):
    raise AssertionError("a CUDA request computed the plain version")


def test_flash_wrapper_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                           monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_forward(q, q, q, causal=True)


def test_flash_backward_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                            monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="cuda")
        lse = torch.empty(2, 16, 1, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_backward(q, q, q, q, lse, q, causal=True)


@pytest.mark.parametrize("case", ["d48", "f16"])
def test_flash_backward_refuses_unsupported_cases(case, monkeypatch):
    """The backward wrapper checks the case before any build: a CUDA
    request the kernels cannot take raises instead of taking the plain
    version."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    d, dtype, err, match = {"d48": (48, torch.float32, ValueError,
                                    "head dims"),
                            "f16": (32, torch.float16, TypeError,
                                    "f32 or bf16")}[case]
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, d, device="cuda", dtype=dtype)
        lse = torch.empty(2, 16, 1, device="cuda")
        with pytest.raises(err, match=match):
            fa.flash_attention_backward(q, q, q, q, lse, q)


@pytest.mark.parametrize("kw", [dict(fused_steps=2),
                                dict(health_guard=True),
                                dict(health_guard=object())],
                         ids=["fused2", "guard_on", "guard_policy"])
def test_fit_refuses_what_is_not_ported(kw):
    net = TransformerLM(**TINY).init(device="cpu")
    x = np.eye(11, dtype=np.float32)[np.arange(8) % 11][None]
    with pytest.raises(NotImplementedError, match="ROADMAP §A5"):
        net.fit(x, x, **kw)
    assert net.iteration == 0


def test_step_refuses_regularization():
    net = TransformerLM(**TINY).init(device="cpu")
    net.conf.vertices["ff0a"].layer.l2 = 1e-4
    x = np.eye(11, dtype=np.float32)[np.arange(8) % 11][None]
    with pytest.raises(NotImplementedError, match="ROADMAP §A6"):
        net.do_step(x, x)


def test_paged_wrapper_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                           monkeypatch):
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(2, 2, 1, 32, device="cuda")
        pool = torch.empty(5, 2, 8, 32, device="cuda")
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos)


def test_cuda_wrappers_refuse_unsupported_shapes():
    """Shape and type checks come before any build: a CUDA request the
    kernel cannot take raises instead of taking the plain version."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 48, device="cuda")           # d = 48
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention_forward(q, q, q)
        q64 = torch.empty(1, 2, 16, 32, device="cuda", dtype=torch.float64)
        with pytest.raises(TypeError, match="f32 or bf16"):
            fa.flash_attention_forward(q64, q64, q64)
        qd = torch.empty(1, 2, 1, 32, device="cuda", dtype=torch.float64)
        with pytest.raises(TypeError, match="paged kernel takes a query"):
            ppa.paged_attention(qd, qd, qd, qd, qd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_16bit_paged_query_on_cuda_reaches_the_kernel(dtype, no_cuda,
                                                      monkeypatch):
    """A bf16 (or f16) model's paged read on CUDA tensors goes to K2's
    build, through the backend the layer's ``auto`` knob resolves to as
    through the wrapper, and never to the plain version: on a host
    without CUDA the build raises."""
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    layer = patt.SelfAttentionLayer(n_in=64, n_out=64, n_heads=2,
                                    causal=True)
    assert ppa.resolve_paged_backend(layer.paged_attention,
                                     "cuda") == "pallas"
    with FakeTensorMode():
        q = torch.empty(2, 2, 1, 32, device="cuda", dtype=dtype)
        pool = torch.empty(5, 2, 8, 32, device="cuda", dtype=dtype)
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos)
        backend = ppa.resolve_paged_backend(layer.paged_attention, q.device)
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attend(backend, q, pool, pool, bt, pos)


@pytest.mark.parametrize("helper", ["auto", "pallas"])
@pytest.mark.parametrize("case", ["d48", "f16", "mask3d"])
def test_attention_layer_on_cuda_never_takes_the_plain_path(
        case, helper, monkeypatch):
    """The layer's kernel-routed helpers hand CUDA tensors to K1's wrapper
    whatever their shape or type, so a case the kernel cannot take raises
    instead of computing ``scaled_dot_attention`` on the card."""
    monkeypatch.setattr(patt, "scaled_dot_attention", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    d, dtype, mask_shape = {"d48": (48, torch.float32, (1, 16)),
                            "f16": (32, torch.float16, (1, 16)),
                            "mask3d": (32, torch.float32, (1, 2, 16))}[case]
    layer = patt.SelfAttentionLayer(n_in=2 * d, n_out=2 * d, n_heads=2,
                                    causal=True, helper=helper)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, d, device="cuda", dtype=dtype)
        mask = torch.ones(mask_shape, device="cuda")
        with pytest.raises((ValueError, TypeError)):
            layer._attend(q, q, q, mask)


def test_output_stays_on_the_requested_device():
    net = TransformerLM(**TINY).init(device="cpu")
    x = np.eye(11, dtype=np.float32)[np.arange(8) % 11][None]
    out = net.output(x)
    assert out.device.type == "cpu" and out.shape == (1, 8, 11)
