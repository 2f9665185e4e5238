"""The port's ``streaming/`` (serde, broker, clients, route) against the JAX
package's on the CPU:

- ``dataset_to_bytes`` gives JAX's bytes for the same arrays (numpy or
  CPU tensors, with and without masks), and each package decodes the
  other's;
- the wire frames are JAX's byte for byte, so a JAX publisher feeds the
  port's broker and consumer, and a port publisher feeds JAX's broker and
  consumer, bit for bit;
- a frame whose length prefix exceeds the bound raises ``FrameTooLarge``
  before its payload is read, and the broker drops such a connection;
- a subscriber whose queue stays full past ``publish_patience_s`` loses
  frames counted as JAX's broker counts them (``stats()``), and is evicted
  after ``drop_limit`` drops in a row, while a healthy one sees every
  frame;
- a consumer with an idle timeout raises ``StreamStalled`` on a silent
  topic and when its producer stops without END (wide margins: the
  timing-flaky JAX test of ROADMAP C6 is not copied);
- ``fit`` on ``NDArrayRoute(...).iterator()`` equals JAX's ``fit`` on the
  same stream, from JAX's weights carried by ``utils/convert.py``
  (Sgd: scores and parameters within atol 1e-5, ``test_torch_training``'s
  ``fit`` tolerance); ``fit`` from the route is bit for bit ``fit`` from
  the same batches in memory;
- a producer thread (and, marked slow, a producer process and the
  standalone ``python -m deeplearning4j_torch.streaming.broker``) trains a
  net through the route.
"""

import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu import streaming as js
from deeplearning4j_tpu.streaming import broker as jbroker
from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch import streaming as ts
from deeplearning4j_torch.streaming import broker as tbroker

pytestmark = pytest.mark.torch_port

HOST = "127.0.0.1"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, masks=True, B=3, T=5):
    rs = np.random.RandomState(seed)
    out = dict(features=rs.randn(B, T, 7).astype(np.float32),
               labels=rs.randn(B, T, 2).astype(np.float32))
    if masks:
        out["features_mask"] = (rs.rand(B, T) > 0.3).astype(np.float32)
        out["labels_mask"] = (rs.rand(B, T) > 0.3).astype(np.float32)
    return out


def _batches(n, seed=3, rows=16):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(rows, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, rows)]
        out.append((x, y))
    return out


def _same(ds, arrays):
    for name in ("features", "labels", "features_mask", "labels_mask"):
        got = getattr(ds, name)
        want = arrays.get(name)
        assert (got is None) == (want is None), name
        if want is not None:
            got = got.cpu().numpy() if torch.is_tensor(got) else got
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def _registered(broker, n, timeout=10.0):
    """Wait until ``broker`` holds ``n`` subscribers: the JAX broker can
    ack a subscription before registering it (ROADMAP C14)."""
    deadline = time.monotonic() + timeout
    while broker.stats()["subscribers"] < n:
        assert time.monotonic() < deadline, "subscriber never registered"
        time.sleep(0.001)


def _drain(consumer, out):
    t = threading.Thread(target=lambda: out.extend(consumer), daemon=True)
    t.start()
    return t


class TestSerde:
    @pytest.mark.parametrize("masks", [True, False])
    def test_bytes_equal_both_ways(self, masks):
        a = _arrays(0, masks)
        kw = {k: v for k, v in a.items() if k.endswith("mask")}
        port = ts.dataset_to_bytes(DataSet(a["features"], a["labels"], **kw))
        ref = js.dataset_to_bytes(JDataSet(a["features"], a["labels"], **kw))
        assert port == ref
        # tensors (on the CPU here; on the card ``.cpu()`` first) encode
        # to the same bytes
        tens = DataSet(torch.from_numpy(a["features"]),
                       torch.from_numpy(a["labels"]),
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert ts.dataset_to_bytes(tens) == ref
        _same(ts.dataset_from_bytes(ref), a)
        _same(js.dataset_from_bytes(port), a)

    def test_no_pickle(self):
        import io

        buf = io.BytesIO()
        np.savez(buf, features=np.array([{"a": 1}], dtype=object))
        with pytest.raises(ValueError):
            ts.dataset_from_bytes(buf.getvalue())


class TestFrames:
    @pytest.mark.parametrize("op,topic,payload", [
        (b"P", "train", b"\x00\x01payload"), (b"E", "té", b""),
        (b"S", "x" * 300, b""), (b"K", "", b"")])
    def test_frame_bytes_equal_jax(self, op, topic, payload):
        got = []
        for mod in (tbroker, jbroker):
            a, b = socket.socketpair()
            with a, b:
                mod.write_frame(a, op, topic, payload)
                a.shutdown(socket.SHUT_WR)
                raw = b""
                while True:
                    chunk = b.recv(65536)
                    if not chunk:
                        break
                    raw += chunk
            got.append(raw)
        assert got[0] == got[1]
        a, b = socket.socketpair()
        with a, b:
            b.sendall(got[1])
            assert tbroker.read_frame(a) == (op, topic, payload)

    def test_frame_too_large_before_any_read_of_the_payload(self):
        a, b = socket.socketpair()
        with a, b:
            # a header declaring 2^31 payload bytes, and no payload at all
            b.sendall(struct.pack(">cH", b"P", 1) + b"t"
                      + struct.pack(">I", 1 << 31))
            a.settimeout(5)
            with pytest.raises(tbroker.FrameTooLarge, match="2147483648"):
                tbroker.read_frame(a)
            assert issubclass(tbroker.FrameTooLarge, ValueError)
        a, b = socket.socketpair()
        with a, b:
            b.sendall(struct.pack(">cH", b"P", 1) + b"t"
                      + struct.pack(">I", 65))
            with pytest.raises(tbroker.FrameTooLarge):
                tbroker.read_frame(a, max_frame_bytes=64)

    def test_broker_drops_a_poisoned_connection(self):
        broker = ts.StreamingBroker(port=0).start()
        try:
            s = socket.create_connection((HOST, broker.port), timeout=10)
            with s:
                s.sendall(struct.pack(">cH", b"P", 1) + b"t"
                          + struct.pack(">I", 0xFFFFFFFF))
                assert s.recv(1) == b""        # closed by the broker
            # ... which goes on serving
            with ts.NDArrayConsumer(HOST, broker.port, "ok") as c, \
                    ts.NDArrayPublisher(HOST, broker.port, "ok") as p:
                p.publish_arrays(np.ones((1, 2), np.float32),
                                 np.ones((1, 1), np.float32))
                p.end()
                assert len(list(c)) == 1
        finally:
            broker.stop()


class TestAcrossPackages:
    def _round(self, broker, pub_mod, con_mod, topic):
        sent = [_arrays(s, masks=bool(s % 2)) for s in range(5)]
        out = []
        cons = con_mod.NDArrayConsumer(HOST, broker.port, topic,
                                       idle_timeout_s=30)
        t = _drain(cons, out)
        _registered(broker, 1)
        DS = DataSet if pub_mod is ts else JDataSet
        with pub_mod.NDArrayPublisher(HOST, broker.port, topic) as pub:
            for a in sent:
                pub.publish(DS(a["features"], a["labels"],
                               **{k: v for k, v in a.items()
                                  if k.endswith("mask")}))
            pub.end()
        t.join(30)
        cons.close()
        assert len(out) == len(sent)
        for ds, a in zip(out, sent):
            _same(ds, a)

    def test_jax_publisher_port_broker_port_consumer(self):
        broker = ts.StreamingBroker(port=0).start()
        try:
            self._round(broker, js, ts, "j2t")
        finally:
            broker.stop()

    def test_port_publisher_jax_broker_jax_consumer(self):
        broker = js.StreamingBroker(port=0).start()
        try:
            self._round(broker, ts, js, "t2j")
        finally:
            broker.stop()

    def test_fan_out_and_isolated_topics(self):
        broker = ts.StreamingBroker(port=0).start()
        try:
            outs = [[], [], []]
            cons = [ts.NDArrayConsumer(HOST, broker.port, "a"),
                    js.NDArrayConsumer(HOST, broker.port, "a"),
                    ts.NDArrayConsumer(HOST, broker.port, "b")]
            ts_ = [_drain(c, o) for c, o in zip(cons, outs)]
            with ts.NDArrayPublisher(HOST, broker.port, "a") as pa, \
                    ts.NDArrayPublisher(HOST, broker.port, "b") as pb:
                for i in range(4):
                    pa.publish_arrays(np.full((1, 2), i, np.float32),
                                      np.ones((1, 1), np.float32))
                pb.publish_arrays(np.full((1, 2), 9, np.float32),
                                  np.ones((1, 1), np.float32))
                pa.end()
                pb.end()
            for t in ts_:
                t.join(30)
            assert [len(o) for o in outs] == [4, 4, 1]
            assert [float(d.features[0, 0]) for d in outs[0]] == [0, 1, 2, 3]
            assert float(outs[2][0].features[0, 0]) == 9
        finally:
            broker.stop()


class _Sink:
    """A socket stand-in for a subscriber that is never written to."""

    def close(self):
        pass


class TestPatienceDrop:
    def _drops(self, mod, frames, drop_limit):
        """``frames`` offers to a subscriber whose one-frame queue is full:
        every frame waits out the patience window and is dropped, and the
        subscriber is evicted at ``drop_limit`` drops in a row."""
        broker = mod.StreamingBroker(port=0, subscriber_buffer=1,
                                     drop_limit=drop_limit,
                                     publish_patience_s=0.01)
        sub = mod._Subscriber(_Sink(), "lag", 1)
        sub.q.put((mod.OP_PUBLISH, b"x"))
        broker._subs["lag"] = [sub]
        for _ in range(frames):
            broker._fan_out(mod.OP_PUBLISH, "lag", b"y")
        return broker.stats(), sub.dropped, sub.alive

    @pytest.mark.parametrize("frames,limit", [(2, 3), (5, 3), (4, 8)])
    def test_counted_as_jax_counts(self, frames, limit):
        got = self._drops(tbroker, frames, limit)
        assert got == self._drops(jbroker, frames, limit)
        st, dropped, alive = got
        assert dropped == st["frames_dropped"] == min(frames, limit)
        assert st["dropped_by_topic"] == {"lag": min(frames, limit)}
        assert st["subscribers_disconnected"] == int(frames >= limit)
        assert alive == (frames < limit)

    def test_delivered_frame_resets_the_run(self):
        broker = ts.StreamingBroker(port=0, subscriber_buffer=1,
                                    drop_limit=2, publish_patience_s=0.01)
        sub = tbroker._Subscriber(_Sink(), "t", 1)
        broker._subs["t"] = [sub]
        sub.q.put((tbroker.OP_PUBLISH, b"a"))
        broker._fan_out(tbroker.OP_PUBLISH, "t", b"b")   # dropped
        sub.q.get_nowait()
        broker._fan_out(tbroker.OP_PUBLISH, "t", b"c")   # delivered
        broker._fan_out(tbroker.OP_PUBLISH, "t", b"d")   # dropped
        assert sub.dropped == 2 and sub.consecutive_drops == 1 and sub.alive
        assert broker.stats()["subscribers_disconnected"] == 0

    def test_live_laggard_evicted_healthy_subscriber_complete(self):
        n_frames = 20
        broker = ts.StreamingBroker(port=0, subscriber_buffer=2,
                                    drop_limit=3,
                                    publish_patience_s=0.05).start()
        try:
            slow = ts.NDArrayConsumer(HOST, broker.port, "lag")
            out = []
            fast = ts.NDArrayConsumer(HOST, broker.port, "lag")
            t = _drain(fast, out)
            big = np.zeros((64, 1024), np.float32)   # ~256 KB a frame
            with ts.NDArrayPublisher(HOST, broker.port, "lag") as pub:
                for _ in range(n_frames):
                    pub.publish_arrays(big, np.ones((64, 1), np.float32))
                pub.end()
            t.join(30)
            st = broker.stats()
            assert st["frames_dropped"] > 0
            assert st["dropped_by_topic"]["lag"] == st["frames_dropped"]
            assert st["subscribers_disconnected"] == 1
            assert len(out) == n_frames
            slow.close()
        finally:
            broker.stop()


class TestStreamStalled:
    def test_silent_topic(self):
        broker = ts.StreamingBroker(port=0).start()
        try:
            with ts.NDArrayConsumer(HOST, broker.port, "dead",
                                    idle_timeout_s=0.3) as cons:
                t0 = time.monotonic()
                with pytest.raises(ts.StreamStalled, match="dead"):
                    list(cons)
                assert time.monotonic() - t0 < 20.0
        finally:
            broker.stop()

    def test_producer_stops_without_end(self):
        """Frames that arrive are handed out; once the producer goes away
        without END the consumer fails typed within its idle budget."""
        from deeplearning4j_torch.parallel.resilience import StreamStalled

        assert StreamStalled is ts.StreamStalled
        broker = ts.StreamingBroker(port=0).start()
        try:
            cons = ts.NDArrayConsumer(HOST, broker.port, "cut",
                                      idle_timeout_s=2.0)
            got = []
            with ts.NDArrayPublisher(HOST, broker.port, "cut") as pub:
                for i in range(3):
                    pub.publish_arrays(np.full((1, 2), i, np.float32),
                                       np.ones((1, 1), np.float32))
            t0 = time.monotonic()
            with pytest.raises(StreamStalled, match="cut"):
                for ds in cons:
                    got.append(ds)
            assert time.monotonic() - t0 < 30.0
            assert [float(d.features[0, 0]) for d in got] == [0, 1, 2]
            cons.close()
        finally:
            broker.stop()


def _mln_pair(lr=0.1):
    """JAX's MultiLayerNetwork with Sgd and the port's on its weights."""
    import jax

    from deeplearning4j_tpu.nn.conf.builders import (
        NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIn
    from deeplearning4j_tpu.nn.conf.layers.core import (
        DenseLayer as JDense, OutputLayer as JOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updater import Sgd as JSgd
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_torch.utils.convert import params_from_jax

    jconf = (JConf.builder().seed(7).updater(JSgd(learning_rate=lr))
             .list(JDense(n_out=8, activation="relu"),
                   JOut(n_out=2, activation="softmax", loss="mcxent"))
             .set_input_type(JIn.feed_forward(4)).build())
    jnet = JMLN(jconf).init()
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Sgd(learning_rate=lr))
            .list(DenseLayer(n_out=8, activation="relu"),
                  OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    tnet = MultiLayerNetwork(conf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def _port_net(seed=7):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=1e-2))
            .list(DenseLayer(n_out=8, activation="relu"),
                  OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _publish(port, batches, topic, mod=ts):
    with mod.NDArrayPublisher(HOST, port, topic) as pub:
        for x, y in batches:
            pub.publish_arrays(x, y)
        pub.end()


def test_fit_on_route_matches_jax_fit_on_the_same_stream():
    from deeplearning4j_torch.optimize.listeners import (
        CollectScoresIterationListener)
    from deeplearning4j_tpu.optimize.listeners import (
        CollectScoresIterationListener as JCollect)
    from deeplearning4j_torch.utils.convert import params_to_numpy

    jnet, tnet = _mln_pair()
    batches = _batches(7)
    broker = ts.StreamingBroker(port=0).start()
    try:
        troute = ts.NDArrayRoute(HOST, broker.port, "fit", buffer_batches=8)
        jroute = js.NDArrayRoute(HOST, broker.port, "fit", buffer_batches=8)
        _publish(broker.port, batches, "fit")
        tsc, jsc = CollectScoresIterationListener(), JCollect()
        tnet.set_listeners(tsc)
        jnet.set_listeners(jsc)
        tnet.fit(troute.iterator())
        jnet.fit(jroute.iterator())
        troute.join(10)
        jroute.join(10)
    finally:
        broker.stop()
    assert tnet.iteration == jnet.iteration == len(batches)
    assert [i for i, _ in tsc.scores] == [i for i, _ in jsc.scores]
    np.testing.assert_allclose([float(s) for _, s in tsc.scores],
                               [float(s) for _, s in jsc.scores],
                               atol=1e-5, rtol=0)
    got = params_to_numpy(tnet)
    for v in got:
        for k in got[v]:
            np.testing.assert_allclose(
                got[v][k], np.asarray(jnet.params[v][k]), atol=1e-5, rtol=0,
                err_msg=f"{v}.{k}")


def test_producer_thread_route_fit_equals_memory_fit():
    """The in-process sibling of the producer-process test: a producer
    thread publishes while ``fit`` trains on the route; the result is bit
    for bit ``fit`` on the same batches in memory."""
    batches = _batches(9, seed=4)
    broker = ts.StreamingBroker(port=0).start()
    try:
        route = ts.NDArrayRoute(HOST, broker.port, "live", buffer_batches=4)
        producer = threading.Thread(
            target=_publish, args=(broker.port, batches, "live"))
        producer.start()
        streamed = _port_net()
        streamed.fit(route.iterator())
        producer.join(30)
        route.join(10)
        assert broker.stats()["frames_dropped"] == 0
    finally:
        broker.stop()
    memory = _port_net()
    memory.fit([DataSet(x, y) for x, y in batches])
    assert streamed.iteration == memory.iteration == len(batches)
    for v in memory.params:
        for k in memory.params[v]:
            assert torch.equal(streamed.params[v][k], memory.params[v][k])


_PRODUCER = r"""
import sys
import numpy as np
from deeplearning4j_torch.streaming import NDArrayPublisher

port, n = int(sys.argv[1]), int(sys.argv[2])
rs = np.random.RandomState(3)
with NDArrayPublisher("127.0.0.1", port, "train") as pub:
    for i in range(n):
        x = rs.randn(16, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 16)]
        pub.publish_arrays(x, y)
    pub.end()
print("published", n, flush=True)
"""


@pytest.mark.slow
def test_fit_from_producer_process_through_standalone_broker():
    """A broker started as ``python -m deeplearning4j_torch.streaming.
    broker`` and a producer process; this process trains on the route."""
    import os

    with socket.socket() as s:
        s.bind((HOST, 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    broker = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_torch.streaming.broker",
         "--port", str(port)], stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert "listening" in broker.stdout.readline()
        route = ts.NDArrayRoute(HOST, port, "train")
        producer = subprocess.Popen(
            [sys.executable, "-c", _PRODUCER, str(port), "12"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        net = _port_net()
        net.fit(route.iterator())
        out, err = producer.communicate(timeout=120)
        assert producer.returncode == 0, err
        assert "published 12" in out
        assert net.iteration == 12 and np.isfinite(net.score())
    finally:
        broker.kill()
        broker.wait()


class TestSubscribeAck:
    """The ack is written only once the subscription is registered, so a
    consumer that has read it misses no frame published after. The JAX
    broker's writer can send the ack before registering the subscriber
    (ROADMAP C14): widening that window with a slow ``_track`` loses the
    frames published right after the ack there, and none here."""

    def _slow_registration(self, broker):
        real = broker._track

        def slow(t):
            real(t)
            if t.name.startswith("broker-writer"):
                time.sleep(0.3)

        broker._track = slow

    def _frames_after_ack(self, mod):
        broker = mod.StreamingBroker(port=0).start()
        try:
            self._slow_registration(broker)
            cons = mod.NDArrayConsumer(HOST, broker.port, "ack",
                                       idle_timeout_s=2.0)
            got = []
            with mod.NDArrayPublisher(HOST, broker.port, "ack") as pub:
                for i in range(3):
                    pub.publish_arrays(np.full((1, 2), i, np.float32),
                                       np.ones((1, 1), np.float32))
                pub.end()
            try:
                got.extend(cons)
            except mod.StreamStalled:
                pass
            cons.close()
            return [float(d.features[0, 0]) for d in got]
        finally:
            broker.stop()

    def test_no_frame_after_the_ack_is_missed(self):
        assert self._frames_after_ack(ts) == [0.0, 1.0, 2.0]

    def test_jax_broker_misses_them(self):
        assert self._frames_after_ack(js) == []
