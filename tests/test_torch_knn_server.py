"""Port parity: ``NearestNeighborsServer`` (the port's
``nearestneighbors/server.py``) against the JAX package's, over real HTTP on
127.0.0.1, on the CPU — the cases of ``tests/test_knn_serve.py``
(``TestServerHardening``) on all three backends (``vptree``, ``device``,
``index``).

- The same requests get the same status codes, the same ``error`` labels
  and JSON of the same shape and types from both servers (400 for every
  malformed payload, 404, 413 with the body drained, 504 for an expired
  deadline on the index backend, 400 for ``/encode`` off it).
- Answers agree under ``tests/test_torch_knn.py``'s tie rule (squared
  distances within 2^-20 of the norms, ids equal where the exact distances
  are apart); the index backend's ``/knn`` answers as ``search_batch_arrays``
  does, bit for bit.
- ``/encode`` with ``"add": true`` grows the store; ``/status``,
  ``/stats`` (keys) and the ``/metrics`` families are JAX's.
- ``mesh=`` serves a store sharded over a host mesh; every backend resolves CUDA by
  default.

Every server is stopped by its ``with``; every HTTP call has a timeout.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.nearestneighbors.server import (  # noqa: E402
    NearestNeighborsServer as JServer)
from deeplearning4j_torch.nearestneighbors.server import (  # noqa: E402
    NearestNeighborsServer)
from tests.test_torch_knn import assert_knn_close, corpus  # noqa: E402

pytestmark = pytest.mark.torch_port

TIMEOUT = 60
BACKENDS = ["vptree", "device", "index"]


def post(base, path, obj, raw=None):
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(
        base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as res:
            return res.status, json.loads(res.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as res:
        body = res.read()
    return body.decode() if path == "/metrics" else json.loads(body)


def shape(obj):
    """The JSON's structure and leaf types (lists by their first item)."""
    if isinstance(obj, dict):
        return {k: shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [shape(obj[0])] if obj else []
    return type(obj).__name__


def answer(res):
    """A /knn or /knnVector body as (distances [Q, k], ids [Q, k])."""
    rows = res["results"]
    if rows and isinstance(rows[0], dict):      # a single "point"
        rows = [rows]
    return (np.array([[r["distance"] for r in row] for row in rows]),
            np.array([[r["index"] for r in row] for row in rows]))


def pair(backend, pts, **kw):
    """The JAX server and the port's, same points and options."""
    return (JServer(pts, port=0, backend=backend, **kw),
            NearestNeighborsServer(pts, port=0, backend=backend,
                                   device="cpu", **kw))


def both(servers, fn):
    out = []
    for srv in servers:
        with srv:
            out.append(fn(f"http://127.0.0.1:{srv.port}", srv))
    return out


MALFORMED = [
    {"k": 2},                                   # missing point
    {"k": 2, "point": "zzz"},                   # non-numeric
    {"k": 2, "points": [[1, 2, 3], [1, 2]]},    # ragged
    {"k": "x", "point": [1, 2, 3]},             # bad k
    {"k": 0, "point": [1, 2, 3]},               # k < 1
    {"k": 2.5, "point": [1, 2, 3]},             # fractional k
    {"k": 2, "point": [1, 2]},                  # dims mismatch
    {"k": 2, "points": [1, 2, 3]},              # wrong ndim
]


@pytest.mark.parametrize("backend", BACKENDS)
def test_error_contract_equals_jax(backend):
    pts = corpus(20, 3, seed=30)

    def drive(base, _srv):
        got = [post(base, "/knn", body) for body in MALFORMED]
        got.append(post(base, "/knn", None, raw=b"this is not json"))
        got.append(post(base, "/knn", [1, 2, 3]))
        got.append(post(base, "/nope", {"k": 1}))
        got.append(post(base, "/knnVector", {"k": 1}))
        got.append(post(base, "/encode", {"docs": [[1, 2, 3]]}))
        try:
            urllib.request.urlopen(base + "/nope", timeout=TIMEOUT)
            got.append((200, {}))
        except urllib.error.HTTPError as e:
            got.append((e.code, json.loads(e.read())))
        return got

    jgot, tgot = both(pair(backend, pts), drive)
    for (js, jb), (ts, tb) in zip(jgot, tgot):
        assert ts == js
        assert tb.get("error") == jb.get("error")
        assert shape(tb) == shape(jb)
    assert [s for s, _ in tgot][:11] == [400] * 10 + [404]


@pytest.mark.parametrize("backend", BACKENDS)
def test_oversized_body_answers_413_as_jax(backend):
    pts = corpus(20, 3)
    big = {"k": 1, "points": [[1.0, 2.0, 3.0]] * 5000}

    def drive(base, _srv):
        return post(base, "/knn", big)

    jgot, tgot = both(pair(backend, pts, max_body_bytes=1024), drive)
    assert tgot[0] == jgot[0] == 413
    assert tgot[1]["error"] == jgot[1]["error"] == "BodyTooLarge"


@pytest.mark.parametrize("backend", BACKENDS)
def test_answers_status_stats_and_metrics_equal_jax(backend):
    pts = corpus(50, 3, seed=31)
    qs = pts[[7, 3, 9]] + 0.01

    def drive(base, srv):
        out = [get(base, "/status")]
        out.append(post(base, "/knn", {"k": 2, "point": qs[0].tolist()}))
        out.append(post(base, "/knn", {"k": 3, "points": qs.tolist()}))
        out.append(post(base, "/knnVector", {"k": 60,
                                             "points": qs[1:].tolist()}))
        out.append(get(base, "/stats"))
        out.append([ln for ln in get(base, "/metrics").splitlines()
                    if ln.startswith("# ")])
        return out

    jgot, tgot = both(pair(backend, pts), drive)
    assert tgot[0] == jgot[0] == {"points": 50, "dims": 3}
    for (js, jb), (ts, tb), q in zip(jgot[1:4], tgot[1:4],
                                     (qs[:1], qs, qs[1:])):
        assert ts == js == 200 and shape(tb) == shape(jb)
        assert_knn_close(answer(tb), answer(jb), pts, q, "euclidean")
    assert list(tgot[4]) == list(jgot[4])
    if backend == "index":
        assert list(tgot[4]["index"]) == list(jgot[4]["index"])
    assert tgot[5] == jgot[5]


def test_index_backend_answers_as_search_batch_and_encodes():
    pts = corpus(50, 3, seed=31)
    with NearestNeighborsServer(pts, port=0, backend="index", store="int8",
                                device="cpu") as server:
        base = f"http://127.0.0.1:{server.port}"
        q = pts[[7, 3]] + 0.001
        status, res = post(base, "/knn", {"k": 2, "points": q.tolist()})
        assert status == 200
        d, idx = server.index.search_batch_arrays(q, 2)
        assert [[r["index"] for r in row] for row in res["results"]] == \
            idx.tolist()
        assert [[r["distance"] for r in row] for row in res["results"]] == \
            d.astype(float).tolist()
        assert res["results"][0][0]["index"] == 7
        status, res = post(base, "/encode",
                           {"docs": [[9.0, 9.0, 9.0]], "add": True})
        assert status == 200 and res["added"] == 1
        assert get(base, "/status") == {"points": 51, "dims": 3}
        status, res = post(base, "/knn", {"k": 1, "point": [9.0, 9.0, 9.0]})
        assert res["results"][0]["index"] == 50


def test_expired_deadline_maps_to_504_as_jax():
    pts = corpus(50, 3)

    def drive(base, _srv):
        return post(base, "/knn", {"k": 1, "point": pts[0].tolist(),
                                   "deadline_s": 1e-6})

    jgot, tgot = both(pair("index", pts, max_wait_ms=1.0), drive)
    assert tgot[0] == jgot[0] == 504
    assert tgot[1]["error"] == jgot[1]["error"] == "DeadlineExceeded"


def test_mesh_refused_and_cuda_by_default(monkeypatch):
    """A mesh of another type is refused (``mesh=`` named ROADMAP A9
    before it was ported); a host mesh serves a sharded store whose
    answers equal the unsharded server's."""
    from deeplearning4j_torch.parallel.mesh import Mesh

    pts = corpus(10, 3)
    with pytest.raises(TypeError, match="Mesh"):
        NearestNeighborsServer(pts, backend="index", mesh=object(),
                               device="cpu")
    mesh = Mesh([torch.device("cpu")] * 2, ("data",))
    q = {"k": 3, "points": (pts[[1, 4]] + 0.01).tolist()}
    with NearestNeighborsServer(pts, port=0, backend="index",
                                mesh=mesh) as sharded, \
            NearestNeighborsServer(pts, port=0, backend="index",
                                   device="cpu") as plain:
        got = post(f"http://127.0.0.1:{sharded.port}", "/knn", q)
        want = post(f"http://127.0.0.1:{plain.port}", "/knn", q)
        assert sharded.index.stats()["variant"] == "aux"
    assert got[0] == want[0] == 200
    dg, ig = answer(got[1])
    dw, iw = answer(want[1])
    assert np.array_equal(ig, iw)
    np.testing.assert_allclose(dg, dw, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in BACKENDS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NearestNeighborsServer(pts, backend=backend)
