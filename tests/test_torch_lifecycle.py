"""Port parity: the shared lifecycle spec of ``tests/test_lifecycle.py`` run
against the port's runtime-hosted servers (``ParallelInference``,
``GenerationServer``, ``ReplicaFleet``), on the CPU: drain twice, close
twice, close from four threads at once, drain after close, submit after
close fails typed. The spec's ``StreamingBroker`` case waits for the
port of ``streaming/`` (ROADMAP A12).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.parallel.fleet import ReplicaFleet  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.inference import (  # noqa: E402
    ParallelInference)
from tests.test_torch_inference import features, mln_pair  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17

_cache = {}


def _lm():
    if "lm" not in _cache:
        _cache["lm"] = TransformerLM(num_labels=V, max_length=16, d_model=16,
                                     n_heads=2, n_blocks=1,
                                     seed=3).init(device="cpu")
    return _cache["lm"]


def _mln():
    if "mln" not in _cache:
        _cache["mln"] = mln_pair()[1]
    return _cache["mln"]


class _Spec:
    name = ""

    def make(self):
        raise NotImplementedError

    def submit(self, srv):
        return None

    def drain(self, srv, timeout=5.0):
        return srv.drain(timeout)

    def close(self, srv, timeout=10.0):
        srv.close(timeout)


class _PISpec(_Spec):
    name = "parallel-inference"

    def make(self):
        return ParallelInference(_mln(), max_wait_ms=5, device="cpu")

    def submit(self, srv):
        return srv.submit(features(1))


class _GenSpec(_Spec):
    name = "generation-server"

    def make(self):
        return GenerationServer(_lm(), V, slots=2, device="cpu")

    def submit(self, srv):
        return srv.submit(np.array([3, 1, 4]), 3)


class _FleetSpec(_Spec):
    name = "replica-fleet"

    def make(self):
        return ReplicaFleet(lambda rid: GenerationServer(
            _lm(), V, slots=2, device="cpu"), replicas=1)

    def submit(self, srv):
        return srv.submit(np.array([3, 1, 4]), 3)


SPECS = [_PISpec(), _GenSpec(), _FleetSpec()]


@pytest.fixture(params=SPECS, ids=[s.name for s in SPECS])
def spec(request):
    return request.param


def test_drain_twice_then_close_twice(spec):
    srv = spec.make()
    try:
        f = spec.submit(srv)
        assert spec.drain(srv) is True
        assert spec.drain(srv) is True
        if f is not None:
            f.result(timeout=5)
    finally:
        spec.close(srv)
    spec.close(srv)


def test_concurrent_close_from_four_threads(spec):
    srv = spec.make()
    errs = []
    try:
        spec.submit(srv)

        def closer():
            try:
                spec.close(srv)
            except Exception as e:  # noqa: BLE001 - the assertion target
                errs.append(e)

        ts = [threading.Thread(target=closer) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert errs == []
    finally:
        spec.close(srv)


def test_drain_after_close_is_trivially_true(spec):
    srv = spec.make()
    spec.close(srv)
    assert spec.drain(srv, timeout=1.0) is True
    spec.close(srv)


def test_submit_after_close_fails_typed(spec):
    srv = spec.make()
    spec.close(srv)
    f = None
    try:
        f = spec.submit(srv)
    except RuntimeError as e:
        assert "closed" in str(e).lower()
    if f is not None:
        with pytest.raises(Exception, match="(?i)closed"):
            f.result(timeout=5)
