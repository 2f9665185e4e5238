"""Port parity: the metrics registry, its Prometheus exposition and the
server's ``stats()`` / ``/metrics`` surface against the JAX package's, on
the CPU.

The port keeps its own copies of ``metrics/registry.py`` and
``metrics/exposition.py``: the same operations must render the same text
and snapshot. The port's ``GenerationServer`` reads every counter off a
``MetricsRegistry`` under the JAX server's metric names, so after the same
traffic (served one request at a time, so the schedule is the same) its
``stats()`` has the JAX server's keys in the same order with equal values
for every count that does not depend on time, and its registry renders
the same families.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu import metrics as jmetrics  # noqa: E402
from deeplearning4j_torch import metrics as tmetrics  # noqa: E402
from tests.test_torch_speculative import V, jax_pair, make_server  # noqa

pytestmark = pytest.mark.torch_port

SERVER = dict(slots=3, page_size=8, prefill_chunk=16, steps_per_dispatch=3)
#: time-dependent values, left out of the equality
TIMED = {"tokens_per_s", "generation_busy_seconds_total"}


def _exercise(mod, seed):
    """One scripted round of registry operations; returns the registry."""
    rs = np.random.RandomState(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", "served requests", labels=("code",))
    for code in rs.choice(["200", "429", "504"], 40):
        c.labels(code=code).inc()
    reg.counter("tokens_total", "tokens").inc(1234.0)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2.5)
    level = [3]
    reg.gauge("pages_free", "free pages", fn=lambda: level[0])
    h = reg.histogram("latency_ms", "latency\nin ms", labels=("kind",))
    for v in rs.exponential(40.0, 3000):
        h.labels(kind="decode").observe(v)
    for v in rs.exponential(400.0, 50):
        h.labels(kind='pre"fill').observe(v)
    reg.histogram("empty_ms", "no observations")
    assert reg.counter("tokens_total") is reg.counter("tokens_total")
    with pytest.raises(ValueError):
        reg.gauge("tokens_total")
    return reg


@pytest.mark.parametrize("seed", [0, 5])
def test_registry_and_exposition_render_jax_text(seed):
    """Counters with labels, settable and callback gauges, histograms past
    the reservoir (seeded quantiles), escaping and injected labels: the
    same text, the same JSON snapshot, the same quantiles."""
    jreg, treg = _exercise(jmetrics, seed), _exercise(tmetrics, seed)
    extra_j, extra_t = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    for reg in (extra_j, extra_t):
        reg.counter("requests_total", "served requests",
                    labels=("code",)).labels(code="200").inc(3)
    want = jmetrics.render_text([({"model": "m0"}, jreg), ({}, extra_j)])
    got = tmetrics.render_text([({"model": "m0"}, treg), ({}, extra_t)])
    assert got == want and "# TYPE latency_ms histogram" in got
    # repr: an empty histogram's quantiles are NaN, equal only as text
    assert repr(treg.snapshot()) == repr(jreg.snapshot())
    assert tmetrics.CONTENT_TYPE == jmetrics.CONTENT_TYPE
    hj = jreg.histogram("latency_ms", labels=("kind",)).labels(kind="decode")
    ht = treg.histogram("latency_ms", labels=("kind",)).labels(kind="decode")
    assert ht.quantiles() == hj.quantiles()
    # pre-collected families (a remote host's report) render the same too
    fams = treg._snapshot_families()
    assert tmetrics.render_text([({}, fams)]) == \
        jmetrics.render_text([({}, jreg._snapshot_families())])


def test_null_registry_and_nearest_rank():
    for mod in (jmetrics, tmetrics):
        null = mod.NullRegistry()
        null.counter("x").inc(5)
        assert null.snapshot() == {} and mod.render_text([({}, null)]) == ""
    xs = sorted(np.random.RandomState(1).rand(101).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert tmetrics.nearest_rank(xs, q) == jmetrics.nearest_rank(xs, q)


def _traffic(srv):
    """The same traffic for both packages, one request at a time: greedy and
    sampled requests sharing a two-page prefix; returns the stats and the
    registry's families."""
    rs = np.random.RandomState(9)
    system = rs.randint(0, V, 16)
    try:
        for i, n in enumerate((3, 9, 1, 12, 5)):
            p = np.concatenate([system, rs.randint(0, V, n)])
            kw = dict(temperature=0.7, top_k=5, seed=i) if i % 2 else {}
            srv.submit(p, 7, **kw).result(timeout=120)
        assert srv.drain(timeout=30)
    finally:
        srv.close()
    # after close: the loop thread is joined, every counter published
    return srv.stats(), srv.metrics._snapshot_families()


def _untimed(d):
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items() if k not in TIMED}
    return d


@pytest.mark.parametrize("extra", [{}, dict(kv_dtype="int8"),
                                   dict(draft_net="lm", spec_k=3)],
                         ids=["f32", "int8", "speculative"])
def test_server_stats_and_families_equal_jax(extra):
    """``stats()``: JAX's keys in JAX's order (nested blocks included) and
    equal values for every count; ``/metrics``: the same families (name,
    type, help, order) with equal samples."""
    lm = jax_pair(3, 16)
    kw = dict(SERVER, **{k: (lm if v == "lm" else v)
                         for k, v in extra.items()})
    jst, jfam = _traffic(make_server("jax", lm, **kw))
    st, fam = _traffic(make_server("port", lm, **kw))
    assert list(st) == list(jst)
    for block in ("pages", "handoff"):
        assert list(st[block]) == list(jst[block])
    assert _untimed(st) == _untimed(jst)
    assert isinstance(st["completed"], int) and st["completed"] == 5
    assert isinstance(st["tokens_per_s"], float) and st["tokens_per_s"] > 0
    assert [(f["name"], f["kind"], f["help"]) for f in fam] == \
        [(f["name"], f["kind"], f["help"]) for f in jfam]
    assert {f["name"]: f["samples"] for f in fam
            if f["name"] not in TIMED} == \
        {f["name"]: f["samples"] for f in jfam if f["name"] not in TIMED}


def test_shared_registry_and_scrape():
    """A caller's registry receives the server's families, and the
    exposition renders them as one scrape page; the autoscaler levers move
    the active-slot cap gauge."""
    lm = jax_pair(3, 16)
    reg = tmetrics.MetricsRegistry()
    srv = make_server("port", lm, registry=reg, **SERVER)
    try:
        assert srv.metrics is reg
        assert srv.submit(np.arange(5), 4).result(timeout=60).size == 4
        assert srv.set_active_slots(99) == SERVER["slots"]
        assert srv.set_active_slots(1) == 1 and srv.active_slot_cap == 1
        assert srv.queue_depth() == 0
        text = tmetrics.render_text([({"model": "lm"}, reg)])
    finally:
        srv.close()
    assert 'generation_completed_total{model="lm"} 1' in text
    assert 'generation_active_slot_cap{model="lm"} 1' in text
    assert 'generation_tokens_total{model="lm"} 4' in text


def test_active_slot_cap_bounds_admission():
    """With the cap at 1 the server decodes one request at a time: the
    tokens are unchanged and no two slots are ever active together."""
    lm = jax_pair(3, 16)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, V, n) for n in (4, 6, 3)]
    ref_srv = make_server("port", lm, **SERVER)
    try:
        ref = [f.result(timeout=60).tolist()
               for f in [ref_srv.submit(p, 6) for p in prompts]]
    finally:
        ref_srv.close()
    srv = make_server("port", lm, **SERVER)
    peak = [0]
    try:
        srv.set_active_slots(1)
        futs = [srv.submit(p, 6) for p in prompts]
        while not all(f.done() for f in futs):
            peak[0] = max(peak[0], srv.stats()["active_slots"])
            time.sleep(0.001)
        assert [f.result().tolist() for f in futs] == ref
    finally:
        srv.close()
    assert peak[0] <= 1
