"""The port's ``ui/`` (components, storage, StatsListener, remote router,
UIServer, legacy listeners) against the JAX package's on the CPU:

- every component's JSON and ``render_html``'s page are JAX's byte for
  byte, and each package reads the other's component JSON;
- a port ``fit`` and a JAX ``fit`` of the same net, weights and batches
  under ``StatsListener`` report at the same iterations with scores within
  atol 1e-5 (Sgd; ``test_torch_training``'s ``fit`` tolerance) and
  ``param_norms`` within 1e-5 relative; handed the same parameter arrays,
  both listeners count the same histograms; the static record has JAX's
  keys but ``jax_backend``, which is ``torch_backend``; a report fetches
  the norms in one transfer;
- a ``FileStatsStorage`` the port writes, read by JAX's ``UIServer``, gives
  the port's overview, model, system and histogram views, and the reverse;
- ``RemoteUIStatsStorageRouter`` posts from each package to the other's
  ``/remoteReceive``;
- every HTTP route answers as JAX's server answers over the same storage
  (the pages, the JSON views, t-SNE upload with its bounds, 404s);
- the legacy listeners write JAX's reports: the histogram and flow pages'
  components equal, the convolutional maps within 1e-5 (NHWC probe), on a
  MultiLayerNetwork and a ComputationGraph.
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_torch import ui as tui
from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.ui import stats as tstats

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- components
def _components(m):
    line = m.ChartLine(title="loss").add_series("train", [0, 1, 2],
                                                [1.0, 0.5, 0.3])
    line.add_series("val", [0, 1, 2], [1.2, 0.7, 0.5])
    scatter = m.ChartScatter(title="emb").add_series("pts", [0.1, 0.5],
                                                     [0.2, 0.9])
    hist = m.ChartHistogram(title="weights").add_bin(-1, 0, 5).add_bin(
        0, 1, 12)
    bars = m.ChartHorizontalBar(title="acc", labels=["a", "b"],
                                values=[0.9, 0.7])
    area = m.ChartStackedArea(title="mem", x=[0, 1, 2],
                              y=[[1, 2, 3], [2, 2, 2]],
                              labels=["heap", "dev"])
    matrix = m.ChartMatrix(title="map", values=[[0.1, 0.2], [0.3, 0.4]],
                           row_labels=["r0", "r1"], col_labels=["c0", "c1"])
    table = m.ComponentTable(header=["k", "v"],
                             content=[["lr", "0.01"], ["bs", "128"]])
    text = m.ComponentText(text="report </script><b>x</b>",
                           style=m.StyleText(font_size=18))
    div = m.ComponentDiv().add(text, table)
    return [line, scatter, hist, bars, area, matrix, table, text, div]


def test_component_json_and_page_bytes_equal_jax():
    from deeplearning4j_tpu.ui import components as jc
    from deeplearning4j_torch.ui import components as tc

    ours, ref = _components(tc), _components(jc)
    for a, b in zip(ours, ref):
        assert a.to_json() == b.to_json()
        assert tc.Component.from_json(b.to_json()).to_json() == b.to_json()
        assert jc.Component.from_json(a.to_json()).to_json() == a.to_json()
    assert tc.render_html(ours) == jc.render_html(ref)
    assert tc.render_html(ours, title="a <t>") == jc.render_html(
        ref, title="a <t>")
    with pytest.raises(ValueError, match="Unknown componentType"):
        tc.Component.from_json('{"componentType": "Nope"}')


# ------------------------------------------------------------ the listener
def _pair(lr=0.1):
    from tests.test_torch_streaming import _mln_pair
    return _mln_pair(lr)


def _stream(n=12, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = rs.randint(0, 2, 16)
        out.append(((rs.randn(16, 4) + lab[:, None]).astype(np.float32),
                    np.eye(2, dtype=np.float32)[lab]))
    return out


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """One port fit and one JAX fit of the same net, weights and batches,
    each under a ``StatsListener`` writing to a ``FileStatsStorage``."""
    d = tmp_path_factory.mktemp("stats")
    jnet, tnet = _pair()
    data = _stream()
    tpath, jpath = str(d / "port.jsonl"), str(d / "jax.jsonl")
    tstore, jstore = tui.FileStatsStorage(tpath), jui.FileStatsStorage(jpath)
    tl = tui.StatsListener(tstore, session_id="s", reporting_frequency=3,
                           collect_histograms=True)
    jl = jui.StatsListener(jstore, session_id="s", reporting_frequency=3,
                           collect_histograms=True)
    tnet.set_listeners(tl)
    jnet.set_listeners(jl)
    tnet.fit([DataSet(x, y) for x, y in data])
    jnet.fit([JDataSet(x, y) for x, y in data])
    tstore.close()
    jstore.close()
    return dict(tnet=tnet, jnet=jnet, tpath=tpath, jpath=jpath)


def _updates(path, mod):
    store = mod.FileStatsStorage(path)
    try:
        return (store.get_all_updates_after("s", tstats.TYPE_ID),
                store.get_static_info("s", tstats.TYPE_ID))
    finally:
        store.close()


def test_listener_records_match_jax(fits):
    tu, tstatic = _updates(fits["tpath"], tui)
    ju, jstatic = _updates(fits["jpath"], jui)
    assert [r["data"]["iteration"] for r in tu] == \
        [r["data"]["iteration"] for r in ju] == [3, 6, 9, 12]
    np.testing.assert_allclose([r["data"]["score"] for r in tu],
                               [r["data"]["score"] for r in ju],
                               atol=1e-5, rtol=0)
    for a, b in zip(tu, ju):
        assert sorted(a["data"]) == sorted(b["data"])
        assert sorted(a) == sorted(b)
        na, nb = a["data"]["param_norms"], b["data"]["param_norms"]
        assert list(na) == list(nb) == ["0/W", "0/b", "1/W", "1/b"]
        for k in nb:
            assert abs(na[k] - nb[k]) <= 1e-5 * abs(nb[k]), k
        for k, h in a["data"]["param_histograms"].items():
            assert sum(h["counts"]) == \
                sum(b["data"]["param_histograms"][k]["counts"])
    # the static record: JAX's keys, torch's backend in place of JAX's
    ts_, js_ = tstatic["data"], jstatic["data"]
    assert sorted(set(ts_) - {"torch_backend"}) == \
        sorted(set(js_) - {"jax_backend"})
    assert ts_["torch_backend"] == "cpu" and ts_["devices"] == ["cpu"]
    for k in ("model_class", "num_params", "num_layers", "updater"):
        assert ts_[k] == js_[k], k


def test_last_norms_against_f64_host_norms(fits):
    tnet = fits["tnet"]
    last = _updates(fits["tpath"], tui)[0][-1]["data"]["param_norms"]
    for v in tnet.params:
        for k, t in tnet.params[v].items():
            want = float(np.linalg.norm(t.cpu().numpy().astype(np.float64)))
            assert abs(last[f"{v}/{k}"] - want) <= 1e-5 * want


def test_histograms_equal_for_the_same_arrays():
    rs = np.random.RandomState(5)
    params = {"0": {"W": rs.randn(7, 5).astype(np.float32),
                    "b": rs.rand(5).astype(np.float32)},
              "1": {"W": (rs.randn(5, 3) * 1e3).astype(np.float32)}}
    tens = {v: {k: torch.from_numpy(a) for k, a in p.items()}
            for v, p in params.items()}
    for bins in (20, 7):
        ours = tui.StatsListener(tui.InMemoryStatsStorage(),
                                 histogram_bins=bins)._histograms(tens)
        ref = jui.StatsListener(jui.InMemoryStatsStorage(),
                                histogram_bins=bins)._histograms(params)
        assert ours == ref
    assert tstats._flat_norms(tens).keys() == {"0/W", "0/b", "1/W"}


def test_one_transfer_per_report(monkeypatch):
    """The norms come back in one device-to-host copy, and the histograms
    in one more."""
    rs = np.random.RandomState(6)
    params = {str(i): {"W": torch.from_numpy(
        rs.randn(4, 4).astype(np.float32))} for i in range(5)}
    calls = []
    real = torch.Tensor.cpu

    def counted(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    tstats._flat_norms(params)
    assert calls == [(5,)]
    calls.clear()
    tstats._host_arrays(params)
    assert calls == [(80,)]


def test_phase_timings_ride_on_the_next_update():
    store = tui.InMemoryStatsStorage()
    net = _pair()[1]
    lis = tui.StatsListener(store, session_id="p", reporting_frequency=1)
    net.set_listeners(lis)
    x, y = _stream(1)[0]
    net.fit(DataSet(x, y))
    lis.on_phase_timings(net, {"host_prep_ms": 1.5,
                               "device_round_ms": 4.0})
    net.fit(DataSet(x, y))
    srv = tui.UIServer()
    srv.attach(store)
    sysinfo = srv.system_info("p")
    assert sysinfo["iterations"] == [1, 2]
    assert sysinfo["host_prep_ms"] == [None, 1.5]
    assert sysinfo["device_round_ms"] == [None, 4.0]


# ----------------------------------------------- storage and views across
def _views(server, sid="s"):
    return dict(sessions=server.list_sessions(),
                overview=server.overview(sid),
                model=server.model_info(sid),
                system=server.system_info(sid),
                histograms=server.histograms(sid))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_storage_read_by_the_other_package(fits, writer):
    path = fits["tpath"] if writer == "port" else fits["jpath"]
    views = []
    for mod in (tui, jui):
        store = mod.FileStatsStorage(path)
        srv = mod.UIServer()
        srv.attach(store)
        views.append(_views(srv))
        store.close()
    ours, ref = views
    for k in ("memory_mb", "iterations_per_second"):
        assert ours["system"][k] == ref["system"][k]
    assert ours == ref
    assert ours["overview"]["iterations"] == [3, 6, 9, 12]


def test_file_storage_appends_and_reloads(tmp_path):
    path = str(tmp_path / "s.jsonl")
    a = tui.FileStatsStorage(path)
    a.put_static_info(tui.storage.make_record("x", "T", "w", {"k": 1}, 1.0))
    a.put_update(tui.storage.make_record("x", "T", "w", {"i": 1}, 2.0))
    a.put_storage_metadata(tui.storage.make_record("x", "T", "w", {}, 3.0))
    a.close()
    b = tui.FileStatsStorage(path)
    b.put_update(tui.storage.make_record("x", "T", "w", {"i": 2}, 4.0))
    b.close()
    lines = open(path).read().splitlines()
    assert [json.loads(line)[0] for line in lines] == \
        ["static", "update", "meta", "update"]
    j = jui.FileStatsStorage(path)
    assert [r["data"]["i"] for r in j.get_all_updates_after("x", "T")] \
        == [1, 2]
    assert j.get_all_updates_after("x", "T", 2.0)[0]["data"]["i"] == 2
    j.close()


# ------------------------------------------------------------------ HTTP
def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_routes_answer_as_jax_routes(fits):
    store = tui.FileStatsStorage(fits["tpath"])
    servers = [tui.UIServer(), jui.UIServer()]
    for s in servers:
        s.attach(store)
        s.start()
    try:
        routes = ["/", "/model", "/system", "/histograms", "/tsne",
                  "/train/sessions", "/train/overview?sid=s",
                  "/train/model?sid=s", "/train/system?sid=s",
                  "/train/histograms?sid=s", "/train/overview?sid=none",
                  "/tsne/sessions", "/nope"]
        for path in routes:
            got, ref = (_get(s.port, path) for s in servers)
            assert got == ref, path
        st, body = _get(servers[0].port, "/train/overview?sid=s")
        assert st == 200 and json.loads(body)["iterations"] == [3, 6, 9, 12]
        assert _get(servers[0].port, "/nope")[0] == 404
        pts = [[0.5, 1.0], [2.0, -1.0]]
        for s in servers:
            assert _post(s.port, "/tsne/upload?sid=e", {
                "points": pts, "labels": ["a", "b"]}) == (200,
                                                          {"status": "ok"})
            code, msg = _post(s.port, "/tsne/upload?sid=e",
                              {"points": pts, "labels": ["a"]})
            assert code == 400 and "labels length" in msg["error"]
            assert _post(s.port, "/nope", {})[0] == 404
        got, ref = (_get(s.port, "/tsne/coords?sid=e") for s in servers)
        assert got == ref and json.loads(got[1])["labels"] == ["a", "b"]
    finally:
        for s in servers:
            s.stop()
        store.close()


def test_tsne_bounds_as_jax():
    for mod in (tui, jui):
        srv = mod.UIServer()
        with pytest.raises(ValueError, match="too many points"):
            srv.upload_tsne("x", [[0, 0]] * (srv.TSNE_MAX_POINTS + 1))
        for i in range(srv.TSNE_MAX_SESSIONS + 2):
            srv.upload_tsne(f"s{i}", [[i, i]])
        srv.upload_tsne("s3", [[0, 1]])
        assert len(srv._tsne) == srv.TSNE_MAX_SESSIONS
        assert "s0" not in srv._tsne and list(srv._tsne)[-1] == "s3"


@pytest.mark.parametrize("sender,receiver", [(tui, jui), (jui, tui)])
def test_remote_router_across_packages(sender, receiver):
    srv = receiver.UIServer()
    srv.enable_remote_listener()
    srv.start()
    try:
        router = sender.RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{srv.port}", max_retries=1)
        mk = sender.storage.make_record
        router.put_static_info(mk("r", tstats.TYPE_ID, "w",
                                  {"model_class": "X"}, 1.0))
        for i in (1, 2):
            router.put_update(mk("r", tstats.TYPE_ID, "w",
                                 {"iteration": i, "score": 1.0 / i}, 1.0 + i))
        router.put_storage_metadata(mk("r", tstats.TYPE_ID, "w", {}, 9.0))
        assert srv.list_sessions() == ["r"]
        assert srv.overview("r")["scores"] == [1.0, 0.5]
        assert srv.model_info("r") == {"model_class": "X"}
    finally:
        srv.stop()


def test_remote_router_gives_up_after_retries():
    router = tui.RemoteUIStatsStorageRouter("http://127.0.0.1:9",
                                            max_retries=1,
                                            retry_backoff=0.0, timeout=1.0)
    assert router._post("update", {"a": 1}) is False


# -------------------------------------------------------- legacy listeners
def _components_of(page):
    m = re.search(r"const COMPONENTS = (\[.*?\]);\n", page, re.S)
    return json.loads(m.group(1).replace("<\\/", "</"))


def _conv_pair(graph):
    import jax

    from deeplearning4j_tpu.nn.conf import builders as jb
    from deeplearning4j_tpu.nn.conf import inputs as ji
    from deeplearning4j_tpu.nn.conf.layers import (
        ConvolutionLayer as JConv, OutputLayer as JOut)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updater import Sgd as JSgd
    from deeplearning4j_torch.nn.conf import builders as tb
    from deeplearning4j_torch.nn.conf import inputs as ti
    from deeplearning4j_torch.nn.conf.layers import (
        ConvolutionLayer as TConv, OutputLayer as TOut)
    from deeplearning4j_torch.nn.graph import ComputationGraph as TCG
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork as TMLN
    from deeplearning4j_torch.nn.updater import Sgd as TSgd
    from deeplearning4j_torch.utils.convert import params_from_jax

    nets = []
    for b, i, Conv, Out, Sgd, MLN, CG in (
            (jb, ji, JConv, JOut, JSgd, JMLN, JCG),
            (tb, ti, TConv, TOut, TSgd, TMLN, TCG)):
        g = b.NeuralNetConfiguration.builder().seed(2).updater(
            Sgd(learning_rate=0.1))
        conv = Conv(n_out=4, kernel_size=(3, 3), activation="relu")
        out = Out(n_out=2, activation="softmax", loss="mcxent")
        if graph:
            conf = (g.graph_builder().add_inputs("in")
                    .add_layer("conv", conv, "in")
                    .add_layer("out", out, "conv").set_outputs("out")
                    .set_input_types(i.InputType.convolutional(8, 8, 1))
                    .build())
            nets.append(CG(conf))
        else:
            conf = (g.list(conv, out)
                    .set_input_type(i.InputType.convolutional(8, 8, 1))
                    .build())
            nets.append(MLN(conf))
    jnet = nets[0].init()
    tnet = nets[1].init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_legacy_listeners_write_jax_reports(tmp_path, graph):
    jnet, tnet = _conv_pair(graph)
    probe = np.random.RandomState(1).randn(1, 8, 8, 1).astype(np.float32)
    pages = []
    for mod, net in ((tui, tnet), (jui, jnet)):
        out = tmp_path / mod.__name__.split(".")[0]
        net.score_value = 0.75
        lis = [mod.HistogramIterationListener(str(out), frequency=2),
               mod.FlowIterationListener(str(out), frequency=2),
               mod.ConvolutionalIterationListener(
                   str(out), torch.from_numpy(probe) if mod is tui
                   else probe, frequency=2, max_maps=3)]
        for it in (1, 2):
            for listener in lis:
                listener.iteration_done(net, it)
        pages.append({f: _components_of((out / f).read_text())
                      for f in ("histograms.html", "flow.html",
                                "activations.html")})
    ours, ref = pages
    # the same weights: the flow table and every histogram are JAX's
    assert ours["flow.html"] == ref["flow.html"]
    assert ours["histograms.html"] == ref["histograms.html"]
    maps_t = [c for c in ours["activations.html"]
              if c["componentType"] == "ChartMatrix"]
    maps_j = [c for c in ref["activations.html"]
              if c["componentType"] == "ChartMatrix"]
    assert [c["title"] for c in maps_t] == [c["title"] for c in maps_j]
    # the graph's activations include its (4-D) input, as in JAX
    assert len(maps_t) == (4 if graph else 3)
    for a, b in zip(maps_t, maps_j):
        np.testing.assert_allclose(a["values"], b["values"], atol=1e-5,
                                   rtol=0)
