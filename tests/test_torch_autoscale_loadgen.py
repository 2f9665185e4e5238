"""Port parity: the queue-driven autoscaler and the seeded load generator
(the port's ``metrics/autoscale.py`` and ``metrics/loadgen.py``) against the
JAX package's, on the CPU.

- ``Autoscaler``: the scenarios of ``tests/test_metrics.py::TestAutoscaler``
  driven by the same fake clock and observation script on both packages:
  every decision's ``as_dict()``, the target's level history and the
  registry's rendered families must be equal.
- ``poisson_arrivals``, ``ramp_profile`` and ``spike_profile``: equal for
  each seed, bit for bit.
- ``LoadGenerator``: the same request indices and an equal ``LoadResult``
  (counts, errors, lost) over instant futures, open and closed loop.
- The three targets read and move the port's real servers:
  ``GenerationSlotsTarget`` a ``GenerationServer``, ``CoalescerTarget`` a
  ``ParallelInference``, ``FleetTierTarget`` a tiered ``ReplicaFleet``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.metrics import autoscale as jauto  # noqa: E402
from deeplearning4j_tpu.metrics import loadgen as jload  # noqa: E402
from deeplearning4j_tpu.metrics.exposition import (  # noqa: E402
    render_text as jax_render)
from deeplearning4j_tpu.metrics.registry import (  # noqa: E402
    MetricsRegistry as JaxRegistry)
from deeplearning4j_torch import metrics as tmetrics  # noqa: E402
from deeplearning4j_torch.metrics import autoscale as tauto  # noqa: E402
from deeplearning4j_torch.metrics import loadgen as tload  # noqa: E402
from deeplearning4j_torch.metrics.exposition import render_text  # noqa
from deeplearning4j_torch.metrics.registry import MetricsRegistry  # noqa
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.parallel.fleet import ReplicaFleet  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.inference import (  # noqa: E402
    ParallelInference)
from tests.test_torch_inference import features, mln_pair  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17


class _FakeTarget:
    """Scriptable target: the script sets depth/miss before each tick."""

    name = "fake"
    min_level = 1
    max_level = 4

    def __init__(self, level=2):
        self.level = level
        self.depth = 0
        self.miss = 0.0
        self.set_calls = []

    def observe(self):
        return self.depth, self.miss

    def get(self):
        return self.level

    def set(self, n):
        self.level = n
        self.set_calls.append(n)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: each scenario: (start level, Autoscaler kwargs, [(dt, depth, miss)])
SCENARIOS = {
    "sustained_breach": (2, {}, [(0, 20, 0.0), (1, 20, 0.0)]),
    "cooldown": (1, {}, [(0, 20, 0.0), (1, 20, 0.0)]
                 + [(1, 20, 0.0)] * 4 + [(5, 20, 0.0)]),
    "oscillation": (2, {}, [(1, 20 if i % 2 == 0 else 4, 0.0)
                            for i in range(40)]),
    "idle_floor": (2, {}, [(1, 0, 0.0)] * 3 + [(10, 0, 0.0)]
                   + [(1, 0, 0.0)] * 6),
    "ceiling": (4, {}, [(1, 100, 0.0)] * 6),
    "miss_rate": (1, {"high_miss_rate": 0.05}, [(0, 0, 0.5), (1, 0, 0.5)]),
    "registry": (1, {"up_ticks": 1, "cooldown_s": 0.0}, [(0, 100, 0.0)]),
    "mixed": (2, {"down_ticks": 2, "cooldown_s": 2.0},
              [(1, d, m) for d, m in ((20, 0.0), (20, 0.0), (0, 0.0),
                                      (0, 0.0), (0, 0.0), (9, 0.1),
                                      (9, 0.1), (0, 0.0), (0, 0.0),
                                      (0, 0.0), (30, 0.0), (30, 0.0))]),
}


def _run_scenario(auto, registry, render, name):
    level, kw, script = SCENARIOS[name]
    tgt = _FakeTarget(level)
    clock = _FakeClock()
    reg = registry()
    kw = dict(dict(high_depth=8, low_depth=1, up_ticks=2, down_ticks=3,
                   cooldown_s=5.0), **kw)
    sc = auto.Autoscaler([tgt], clock=clock, registry=reg, **kw)
    made = []
    for dt, depth, miss in script:
        clock.t += dt
        tgt.depth, tgt.miss = depth, miss
        made.append([d.as_dict() for d in sc.tick()])
    return (made, [d.as_dict() for d in sc.decisions], tgt.set_calls,
            tgt.level, sc.stats(), render([({}, reg)]))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_decisions_equal_jax(name):
    """The same fake clock and observation script give JAX's decisions,
    level history, ``stats()`` and rendered families."""
    got = _run_scenario(tauto, MetricsRegistry, render_text, name)
    assert got == _run_scenario(jauto, JaxRegistry, jax_render, name)
    made, decisions, calls, level, _, text = got
    if name == "sustained_breach":
        assert [d["action"] for d in decisions] == ["scale_up"]
        assert (decisions[0]["level_from"], decisions[0]["level_to"]) == (2,
                                                                          3)
        assert made[0] == []
    elif name == "cooldown":
        assert calls == [2, 3]
    elif name == "oscillation":
        assert calls == [] and decisions == []
    elif name == "idle_floor":
        assert calls == [1] and level == 1
    elif name == "ceiling":
        assert calls == [] and level == 4
    elif name == "miss_rate":
        assert level == 2
    elif name == "registry":
        assert ('autoscale_decisions_total{target="fake",'
                'action="scale_up"} 1') in text
        assert 'autoscale_level{target="fake"} 2' in text


def test_scale_decision_repr_and_keys_equal_jax():
    args = dict(t=1.5, target="x", action="scale_up", level_from=1,
                level_to=2, queue_depth=9, miss_rate=0.25, reason="r")
    t, j = tauto.ScaleDecision(**args), jauto.ScaleDecision(**args)
    assert t.as_dict() == j.as_dict() and repr(t) == repr(j)
    assert list(t.as_dict()) == list(tauto.ScaleDecision.__slots__)
    assert tauto.__all__ == jauto.__all__ and tload.__all__ == jload.__all__


# -------------------------------------------------------------- arrivals
@pytest.mark.parametrize("seed", [0, 5, 11, 12, 2024])
def test_poisson_arrivals_equal_jax(seed):
    for prof in ("ramp", "spike", "flat"):
        if prof == "ramp":
            args = (50.0, 200.0, 1.0)
            rate_t, rate_j = (tload.ramp_profile(*args),
                              jload.ramp_profile(*args))
        elif prof == "spike":
            args = (100.0, 900.0, 0.5, 0.3)
            rate_t, rate_j = (tload.spike_profile(*args),
                              jload.spike_profile(*args))
        else:
            rate_t = rate_j = (lambda t: 300.0)
        a = tload.poisson_arrivals(rate_t, 2.0, 900.0, seed=seed)
        b = jload.poisson_arrivals(rate_j, 2.0, 900.0, seed=seed)
        assert a == b and len(a) > 0
        assert a == sorted(a) and all(0.0 <= t < 2.0 for t in a)
    assert tload.poisson_arrivals(rate_t, 2.0, 900.0, seed=seed) != \
        tload.poisson_arrivals(rate_t, 2.0, 900.0, seed=seed + 1)


def test_profiles_equal_jax():
    grid = np.linspace(-1.0, 5.0, 121).tolist() + [1.0, 1.49, 1.5, 2.0]
    r_t, r_j = (tload.ramp_profile(100.0, 300.0, 2.0),
                jload.ramp_profile(100.0, 300.0, 2.0))
    s_t, s_j = (tload.spike_profile(100.0, 900.0, at_s=1.0, dur_s=0.5),
                jload.spike_profile(100.0, 900.0, at_s=1.0, dur_s=0.5))
    assert [r_t(t) for t in grid] == [r_j(t) for t in grid]
    assert [s_t(t) for t in grid] == [s_j(t) for t in grid]
    assert r_t(1.0) == 200.0 and s_t(1.49) == 900.0 and s_t(1.5) == 100.0


# ------------------------------------------------------------- generator
class _InstantFuture:
    def __init__(self, err=None):
        self._err = err

    def add_done_callback(self, cb):
        cb(self)

    def exception(self):
        return self._err


def _load_run(mod, registry, mode):
    issued = []

    def submit(i):
        issued.append(i)
        if i % 5 == 0:
            raise ValueError("shed")
        if i % 7 == 0:
            return _InstantFuture(KeyError("typed"))
        return _InstantFuture()

    reg = registry()
    lg = mod.LoadGenerator(submit, seed=5, registry=reg)
    if mode == "open":
        res = lg.run_open(lambda t: 400.0, 0.3, 400.0, timeout_s=30)
    else:
        res = lg.run_closed(workers=3, requests_per_worker=5, timeout_s=30)
    d = res.as_dict()
    snap = reg.snapshot()
    return (sorted(issued), d["submitted"], d["completed"], d["failed"],
            d["lost"], d["errors"], snap["soak_submitted_total"],
            snap["soak_completed_total"], snap["soak_failed_total"],
            sorted(d))


@pytest.mark.parametrize("mode", ["open", "closed"])
def test_load_generator_equals_jax(mode):
    """Over instant futures the same seed issues the same requests and
    both packages' ``LoadResult`` agree: counts, the error taxonomy
    (synchronous sheds count as typed failures) and ``lost == 0``."""
    got = _load_run(tload, MetricsRegistry, mode)
    assert got == _load_run(jload, JaxRegistry, mode)
    issued, submitted, completed, failed, lost, errors = got[:6]
    assert lost == 0 and submitted == len(issued) > 0
    assert completed + failed == submitted
    assert errors.get("ValueError", 0) > 0
    if mode == "closed":
        assert submitted == 15


def test_load_result_quantiles():
    reg = MetricsRegistry()
    h = reg.histogram("lat", "latency")
    for v in range(1, 101):
        h.observe(float(v))
    res = tload.LoadResult(h, 100, 98, 2, {"X": 2}, 2.0)
    assert res.lost == 0 and res.achieved_req_s == 49.0
    assert res.quantile(0.5) == 50.0 and res.as_dict()["p99_ms"] == 99.0


def test_metrics_package_exports_equal_jax():
    import deeplearning4j_tpu.metrics as jmetrics

    assert tmetrics.__all__ == jmetrics.__all__
    for name in tmetrics.__all__:
        assert hasattr(tmetrics, name), name


# ---------------------------------------------------------------- targets
@pytest.fixture(scope="module")
def lm():
    return TransformerLM(num_labels=V, max_length=16, d_model=16, n_heads=2,
                         n_blocks=1, seed=3).init(device="cpu")


def test_generation_slots_target_moves_the_cap(lm):
    srv = GenerationServer(lm, V, slots=4, device="cpu")
    try:
        tgt = tauto.GenerationSlotsTarget(srv)
        assert (tgt.min_level, tgt.max_level, tgt.get()) == (1, 4, 4)
        sc = tauto.Autoscaler([tgt], up_ticks=1, down_ticks=1,
                              cooldown_s=0.0, clock=lambda: 0.0)
        made = sc.tick()                     # idle: one step down
        assert [d.action for d in made] == ["scale_down"]
        assert srv.active_slot_cap == 3 and tgt.get() == 3
        out = srv.submit(np.array([1, 2, 3]), 4).result(timeout=60)
        assert len(out) == 4
        assert tgt.observe() == (0, 0.0)
    finally:
        srv.close()


def test_coalescer_target_moves_the_pool():
    inf = ParallelInference(mln_pair()[1], max_wait_ms=1, max_coalescers=3,
                            device="cpu")
    try:
        tgt = tauto.CoalescerTarget(inf)
        assert (tgt.max_level, tgt.get()) == (3, 1)
        inf.submit(features(1)).result(timeout=30)
        assert tgt.observe() == (0, 0.0)
        tgt.set(2)
        assert tgt.get() == 2 and inf.coalescer_workers == 2
    finally:
        inf.close()


def test_fleet_tier_target_over_a_tiered_fleet(lm):
    roles = ("prefill", "decode")
    fl = ReplicaFleet(lambda rid: GenerationServer(
        lm, V, slots=2, page_size=4, role=roles[rid], device="cpu"),
        replicas=2, roles=roles)
    try:
        with pytest.raises(ValueError, match="unknown tier role"):
            tauto.FleetTierTarget(fl, "bogus")
        tgt = tauto.FleetTierTarget(fl, "decode")
        assert tgt.name == "fleet_decode_slots"
        assert (tgt.max_level, tgt.get()) == (2, 2)
        out = fl.submit(np.array([1, 2, 3]), 5).result(timeout=60)
        assert len(out) == 5
        depth, miss = tgt.observe()
        assert (depth, miss) == (0, 0.0)
        tgt.set(1)
        assert tgt.get() == 1 and fl.tier_stats("decode")["active_slots"] == 1
        assert fl.tier_stats("prefill")["active_slots"] == 2
    finally:
        fl.close()
