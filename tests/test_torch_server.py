"""Port parity: ``KerasBackendServer`` (the port's
``modelimport/server.py``) against the JAX package's, over real HTTP on
127.0.0.1, on the CPU: the cases of ``tests/test_resilience.py``
(``TestHttpErrorContract``, ``TestHttpResilienceMapping``,
``TestServerStatsLockDiscipline``), ``tests/test_metrics.py``
(``TestMetricsEndpoint``) and ``tests/test_fleet.py``
(``TestKerasBackendServerFleet``).

- The same bad requests get the same status codes and JSON ``type``s from
  both servers (400, 404, 413 with the body drained, 429/503/504 through
  ``_STATUS``, a structured 500).
- ``/generate`` through a two-replica fleet returns the JAX server's tokens
  (greedy and sampled); ``/predict`` rows are within 1e-5 of the JAX
  server's; ``/fit`` losses within 1e-5 of JAX's over two Adam steps and
  bit for bit the port's own ``fit`` on the same batches; ``/evaluate``
  JAX's accuracy; ``/stats`` has JAX's keys and a scrape JAX's families.
- ``/import`` and ``/rag`` return the structured 500 naming ROADMAP A12
  and A9.

Every server is stopped in a ``finally``; every HTTP call has a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.client import HTTPConnection

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.modelimport import server as jserver  # noqa: E402
from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.parallel import resilience as jres  # noqa: E402
from deeplearning4j_torch.modelimport import server as tserver  # noqa: E402
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.parallel import resilience as tres  # noqa: E402
from deeplearning4j_torch.parallel.fleet import READY  # noqa: E402
from tests.test_torch_inference import features, mln_pair  # noqa: E402
from tests.test_torch_speculative import V, jax_pair  # noqa: E402

pytestmark = pytest.mark.torch_port

TIMEOUT = 120


class _FakeNet:
    """Stands in for an imported model: deterministic output, optional
    injected latency."""

    def __init__(self, latency_s=0.0):
        self.latency_s = latency_s

    def output(self, x):
        if self.latency_s:
            time.sleep(self.latency_s)
        return np.asarray(x, np.float32) * 2.0


class _Http:
    def __init__(self, port):
        self.port = port
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path, payload, raw=None):
        body = raw if raw is not None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base + path, body, {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        try:
            with urllib.request.urlopen(self.base + path,
                                        timeout=TIMEOUT) as resp:
                return resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers


@pytest.fixture
def servers():
    """``make(pkg, **kw)``: a started server of ``pkg`` ("jax" or "port")
    with a ``_FakeNet`` at ``m0``; every one is stopped afterwards."""
    made = []

    def make(pkg, fake=True, **kw):
        mod = jserver if pkg == "jax" else tserver
        res = jres if pkg == "jax" else tres
        for k, cls in (("chaos", "ChaosPolicy"), ("retry", "RetryPolicy"),
                       ("breaker", "CircuitBreaker")):
            if isinstance(kw.get(k), dict):
                kw[k] = getattr(res, cls)(**kw[k])
        srv = mod.KerasBackendServer(**kw)
        made.append(srv)
        if fake:
            srv._models["m0"] = _FakeNet()
        return srv, _Http(srv.start())

    try:
        yield make
    finally:
        for s in made:
            s.stop()


def _both(servers, call, **kw):
    """``call(srv, http)`` on a JAX and a port server built alike."""
    return [call(*servers(pkg, **kw)) for pkg in ("jax", "port")]


def _raw_post(client, path, headers):
    conn = HTTPConnection("127.0.0.1", client.port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


ERROR_CASES = {
    "malformed_json": lambda h: h.post("/predict", None, raw=b"{not json]"),
    "non_object_json": lambda h: h.post("/predict", None, raw=b"[1, 2, 3]"),
    "unknown_model": lambda h: h.post("/predict", {"model": "nope",
                                                   "features": [[1.0]]}),
    "unknown_generation_model": lambda h: h.post(
        "/generate", {"model": "nope", "prompt_ids": [1], "max_tokens": 1}),
    "missing_field": lambda h: h.post("/predict", {"model": "m0"}),
    "bad_max_tokens": lambda h: h.post(
        "/generate", {"model": "m0", "prompt_ids": [1], "max_tokens": "x"}),
    "unknown_route": lambda h: h.post("/nope", {}),
    "happy_predict": lambda h: h.post("/predict", {"model": "m0",
                                                   "features": [[1.0,
                                                                 2.0]]}),
    "deadline": lambda h: h.post("/predict", {"model": "m0",
                                              "features": [[1.0]],
                                              "deadline_s": 0.0}),
    "bad_content_length": lambda h: _raw_post(
        h, "/predict", {"Content-Length": "abc"}),
    "fit_unreadable_batch": lambda h: h.post(
        "/fit", {"model": "m0", "batches": ["/nonexistent/b.npz"]}),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_http_error_contract_equals_jax(servers, case):
    """``TestHttpErrorContract``: for the same request both servers answer
    the same status and JSON ``type`` (and, on success, the same body)."""
    got = _both(servers, lambda srv, http: ERROR_CASES[case](http))
    (js, jb), (ts, tb) = got
    assert ts == js, (case, got)
    assert tb.get("type") == jb.get("type"), (case, got)
    if js == 200:
        assert tb == jb
    if case == "unknown_model":
        assert ts == 404 and "nope" in tb["error"]


@pytest.mark.parametrize("max_body", [128, 1 << 20])
def test_oversized_body_is_413_without_buffering(servers, max_body):
    """A body past ``max_body_bytes`` (small, and multi-megabyte with the
    client still sending) gets its 413 from both servers."""
    rows = [[0.0] * 1000] if max_body == 128 else [[0.0] * 784] * 400
    got = _both(servers, lambda srv, http: http.post(
        "/predict", {"model": "m0", "features": rows}),
        max_body_bytes=max_body)
    assert got[0] == got[1]
    assert got[1][0] == 413 and got[1][1]["type"] == "BodyTooLarge"


def test_get_routes_and_stats_equal_jax(servers):
    def call(srv, http):
        http.post("/predict", {"model": "m0", "features": [[1.0, 2.0]]})
        models = json.loads(http.get("/models")[1])
        status, body, _ = http.get("/stats")
        st = json.loads(body)
        nf = http.get("/nope")
        return models, status, st, nf[0], json.loads(nf[1])["type"]

    jgot, tgot = _both(servers, call)
    assert tgot == jgot
    assert tgot[2]["completed"] == 1 and tgot[2]["accepted"] == 1
    assert tgot[2]["breaker_state"] == "closed" and tgot[3] == 404


def test_overload_maps_to_429(servers):
    for pkg in ("jax", "port"):
        srv, http = servers(pkg, max_pending=1)
        srv._models["m0"].latency_s = 0.5
        results = []

        def hit():
            results.append(http.post("/predict", {"model": "m0",
                                                  "features": [[1.0]]}))

        threads = [threading.Thread(target=hit) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        codes = sorted(s for s, _ in results)
        assert 429 in codes and 200 in codes, (pkg, codes)
        assert all(b["type"] == "ServerOverloaded"
                   for s, b in results if s == 429)
        assert srv.stats()["rejected"] == codes.count(429)


def test_open_breaker_maps_to_503(servers):
    def call(srv, http):
        codes = [http.post("/predict", {"model": "m0",
                                        "features": [[1.0]]})[0]
                 for _ in range(3)]
        last = http.post("/predict", {"model": "m0", "features": [[1.0]]})
        return codes, last[0], last[1]["type"], srv.stats()["breaker_state"]

    got = _both(servers, call, chaos=dict(seed=0, hard_rate=1.0),
                breaker=dict(failure_threshold=0.5, window=4, min_calls=2,
                             reset_timeout_s=60.0),
                retry=dict(max_attempts=1))
    assert got[1] == got[0]
    assert got[1][1:] == (503, "CircuitOpen", "open")


def test_transient_faults_retried_transparently(servers):
    def call(srv, http):
        outs = [http.post("/predict", {"model": "m0", "features": [[3.0]]})
                for _ in range(10)]
        return outs, srv.stats()["retried"]

    got = _both(servers, call, chaos=dict(seed=1, transient_rate=0.4),
                retry=dict(max_attempts=6, base_s=1e-4, cap_s=1e-3, seed=0))
    assert got[1] == got[0]
    assert all(o == (200, {"output": [[6.0]]}) for o in got[1][0])
    assert got[1][1] >= 1


def test_concurrent_predicts_count_exactly():
    """``TestServerStatsLockDiscipline``: 8 threads x 25 predicts while a
    reader spins on ``stats()``; the final count is exact and no snapshot
    exceeds it."""
    srv = tserver.KerasBackendServer(max_pending=64)
    srv._models["m0"] = _FakeNet()
    per, n, errs, snaps = 25, 8, [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            snaps.append(srv.stats()["completed"])

    def hammer():
        try:
            for _ in range(per):
                assert srv.predict("m0", [[1.0, 2.0]]) == [[2.0, 4.0]]
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    r = threading.Thread(target=reader, daemon=True)
    r.start()
    ts = [threading.Thread(target=hammer) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    stop.set()
    r.join(10)
    assert not any(t.is_alive() for t in ts) and errs == []
    st = srv.stats()
    assert st["completed"] == n * per and st["failed"] == 0
    assert all(0 <= s <= n * per for s in snaps)


def test_import_and_rag_are_structured_500s_naming_their_items(servers):
    srv, http = servers("port")
    status, body = http.post("/import", {"path": "model.h5"})
    assert status == 500 and body["type"] == "InternalError"
    assert "NotImplementedError" in body["error"] and "A12" in body["error"]
    status, body = http.post("/rag", {"model": "m0", "prompt_ids": [1],
                                      "max_tokens": 2})
    assert status == 500 and body["type"] == "InternalError"
    assert "A9" in body["error"]
    with pytest.raises(NotImplementedError, match="A9"):
        srv.attach_rag(None, vocab=V, passages=[], doc_vectors=[])


# -------------------------------------------------------- real models
@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


def test_fleet_generate_predict_stats_and_metrics_equal_jax(lm):
    """``TestKerasBackendServerFleet`` + ``TestMetricsEndpoint``:
    ``/generate`` through a two-replica fleet returns the JAX server's
    greedy and sampled tokens, ``/predict`` through a coalescing server
    JAX's rows, ``/stats`` JAX's keys (per-replica blocks included) and one
    ``/metrics`` scrape JAX's families."""
    jnet, tnet = lm
    jmln, tmln = mln_pair()
    x = features(4, seed=12)
    reqs = [{"prompt_ids": [1, 2, 3], "max_tokens": 4},
            {"prompt_ids": [4, 5, 6, 7], "max_tokens": 6,
             "temperature": 0.9, "top_k": 5, "seed": 21}]
    got = {}
    for pkg in ("jax", "port"):
        mod = jserver if pkg == "jax" else tserver
        srv = mod.KerasBackendServer()
        try:
            if pkg == "jax":
                gmid = srv.attach_generation(jnet, vocab=V, slots=4,
                                             replicas=2, mid="gen0",
                                             paged_attention="xla")
                pmid = srv.attach_inference(jmln, mid="inf0", workers=1,
                                            max_batch=8, max_wait_ms=1.0)
            else:
                gmid = srv.attach_generation(tnet, vocab=V, slots=4,
                                             replicas=2, mid="gen0",
                                             device="cpu")
                pmid = srv.attach_inference(tmln, mid="inf0", max_batch=8,
                                            max_wait_ms=1.0, device="cpu")
            http = _Http(srv.start())
            toks = [http.post("/generate", dict(r, model=gmid))
                    for r in reqs]
            pred = http.post("/predict", {"model": pmid,
                                          "features": x.tolist()})
            st = json.loads(http.get("/stats")[1])
            _, text, headers = http.get("/metrics")
        finally:
            srv.stop()
        text = text.decode()
        got[pkg] = dict(
            toks=toks, pred=pred, keys=list(st),
            gen_keys=list(st["generation"][gmid]),
            rep_keys=list(st["generation"][gmid]["replicas"][0]),
            inf_keys=list(st["inference"][pmid]),
            families=sorted({ln.split()[2] for ln in text.splitlines()
                             if ln.startswith("# TYPE")}),
            ctype=headers["Content-Type"],
            lines=[ln for ln in text.splitlines()
                   if ln.startswith(("server_completed_total",
                                     'inference_completed_total{model="inf0"}',
                                     'generation_slots{model="gen0"}',
                                     'fleet_completed_total{model="gen0"}'))])
    j, t = got["jax"], got["port"]
    assert [s for s, _ in t["toks"]] == [200, 200]
    assert t["toks"] == j["toks"]
    assert t["pred"][0] == j["pred"][0] == 200
    np.testing.assert_allclose(np.asarray(t["pred"][1]["output"]),
                               np.asarray(j["pred"][1]["output"]), rtol=0,
                               atol=1e-5)
    for k in ("keys", "gen_keys", "rep_keys", "inf_keys", "ctype", "lines"):
        assert t[k] == j[k], k
    # every family the port's surfaces publish is JAX's; JAX's process
    # registry also carries its own training telemetry
    assert set(t["families"]) <= set(j["families"])
    assert {"fleet_completed_total", "fleet_ttft_ms", "server_completed_total",
            "inference_dispatches_total"} <= set(t["families"])


def test_all_replicas_down_maps_to_503(lm):
    srv = tserver.KerasBackendServer()
    try:
        gmid = srv.attach_generation(lm[1], vocab=V, slots=4, replicas=2,
                                     fleet_kw={"restart": False},
                                     device="cpu")
        http = _Http(srv.start())
        gen = srv._generators[gmid]
        gen.kill_replica(0)
        gen.kill_replica(1)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and any(
                r["state"] == READY for r in gen.stats()["replicas"]):
            time.sleep(0.01)
        status, body = http.post("/generate", {"model": gmid,
                                               "prompt_ids": [1, 2],
                                               "max_tokens": 2})
    finally:
        srv.stop()
    assert status == 503
    assert body["type"] in ("ReplicaUnavailable", "CircuitOpen")


def test_generation_roles_through_attach(lm):
    """``attach_generation(roles=...)`` serves through the tier pipeline
    and returns JAX's serial stream; ``roles`` without replicas refuses."""
    jnet, tnet = lm
    ref = np.asarray(jzoo.greedy_generate(
        jnet, np.array([[1, 2, 3, 4]]), 8, V)[0]).tolist()
    srv = tserver.KerasBackendServer()
    try:
        with pytest.raises(ValueError, match="replicas"):
            srv.attach_generation(tnet, vocab=V, roles=("prefill",),
                                  device="cpu")
        gmid = srv.attach_generation(tnet, vocab=V, slots=2, replicas=2,
                                     roles=("prefill", "decode"),
                                     page_size=4, device="cpu")
        assert srv.generate(gmid, [1, 2, 3, 4], 8) == ref
        st = srv.stats()["generation"][gmid]
        assert st["tier_handoffs"] == 1 and "tiers" in st
    finally:
        srv.stop()


def _write_batches(tmp_path, n=2, rows=16, seed=0):
    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        x = rs.randn(rows, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, rows)]
        p = tmp_path / f"b{i}.npz"
        np.savez(p, features=x, labels=y)
        paths.append(str(p))
    return paths


def test_fit_and_evaluate_equal_jax(tmp_path):
    """``/fit`` over two ``.npz`` batches, one request each: the losses are
    within 1e-5 of the JAX server's (Adam 0.02) and bit for bit the
    port's own ``fit`` on the same batches from the same start;
    ``/evaluate`` gives JAX's accuracy and F1."""
    paths = _write_batches(tmp_path)
    jnet, tnet = mln_pair()
    direct = tnet.clone()
    out = {}
    for pkg, net in (("jax", jnet), ("port", tnet)):
        mod = jserver if pkg == "jax" else tserver
        srv = mod.KerasBackendServer()
        srv._models["fit0"] = net
        try:
            http = _Http(srv.start())
            fits = [http.post("/fit", {"model": "fit0", "batches": [p]})
                    for p in paths]
            ev = http.post("/evaluate", {"model": "fit0", "batches": paths})
        finally:
            srv.stop()
        out[pkg] = (fits, ev)
    (jfits, jev), (tfits, tev) = out["jax"], out["port"]
    assert [s for s, _ in tfits] == [200, 200] and tev[0] == 200
    for (_, jb), (_, tb) in zip(jfits, tfits):
        assert tb["iterations"] == jb["iterations"]
        assert abs(tb["score"] - jb["score"]) <= 1e-5 * max(1.0,
                                                           abs(jb["score"]))
    assert tev[1] == pytest.approx(jev[1], abs=1e-12)
    scores = []
    for p in paths:
        with np.load(p) as z:
            direct.fit(DataSet(z["features"], z["labels"]))
        scores.append(float(direct.score_value))
    assert [b["score"] for _, b in tfits] == scores
    for k, leaves in direct.params.items():
        for name, t in leaves.items():
            assert torch.equal(t, tnet.params[k][name]), (k, name)
    for k, leaves in tnet.params.items():
        for name, t in leaves.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jax.device_get(jnet.params[k][name])),
                rtol=1e-5, atol=1e-5)
