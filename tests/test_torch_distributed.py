"""Port parity: process groups (``deeplearning4j_torch/parallel/
distributed.py`` and the meshes, collectives and data-parallel step that
span processes), the counterpart of ``tests/test_multiprocess.py``.

Two OS processes join a gloo group on the CPU (one CPU entry each, as a
JAX CPU process counts one local device), build the global ``data`` mesh,
and train the same ``[16, 6]`` Sgd(0.1) MLP on their rows of the global
batch through ``do_step`` on ``make_array_from_process_local_data``
arrays. The ranks must end bitwise equal (the gradients are summed by one
all-reduce, which hands every rank the same bits), and within JAX's 1e-6
of one process's run on the whole batch: the port's and JAX's, from JAX's
weights. The children import no JAX. The TransformerLM leg (slow) runs
``shard_network`` over a global ``data`` mesh and a global ``(data,
model)`` mesh against JAX's ``ShardedTrainer`` on its XLA CPU devices at
rtol 1e-4 / atol 1e-5.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.parallel import distributed  # noqa: E402
from deeplearning4j_torch.parallel.mesh import (  # noqa: E402
    DataSharding, Mesh, MeshGeometryError, ShardedArray,
    make_array_from_process_local_data)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

MLP_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, port, outdir, how = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])

    from deeplearning4j_torch.parallel import distributed as dist
    if how == "address":
        dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                        num_processes=2, process_id=pid, device="cpu",
                        timeout=60)
    elif how == "environment":      # what torchrun sets
        import os
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          RANK=str(pid), WORLD_SIZE="2", LOCAL_RANK="0")
        dist.initialize(device="cpu", timeout=60)
    else:                           # a store the caller holds
        import datetime
        import torch.distributed as tdist
        store = tdist.PrefixStore("mlp", tdist.TCPStore(
            "127.0.0.1", int(port), world_size=2, is_master=pid == 0,
            timeout=datetime.timedelta(seconds=60)))
        dist.initialize(num_processes=2, process_id=pid, device="cpu",
                        store=store, timeout=60)
    report = dict(backend=dist.group_backend(),global_devices=dist.global_device_count(),
                  local_devices=dist.local_device_count(),
                  process_index=dist.process_index(),
                  coordinator=dist.is_coordinator())

    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_torch.parallel import mesh as M
    from deeplearning4j_torch.utils.convert import params_from_jax

    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Sgd(learning_rate=0.1))
            .list(DenseLayer(n_out=16, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    weights = np.load(f"{outdir}/weights.npz")
    params_from_jax({k: {n: weights[f"{k}/{n}"] for n in ("W", "b")}
                     for k in ("0", "1")}, net)

    # each process owns rows [pid*8, (pid+1)*8) of the global [16, 6] batch
    rs = np.random.RandomState(0)
    x = rs.randn(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    mesh = M.data_mesh()
    sh = M.DataSharding(mesh)
    losses = []
    for step in range(4):
        xg = M.make_array_from_process_local_data(
            sh, x[pid * 8:(pid + 1) * 8], global_shape=x.shape)
        yg = M.make_array_from_process_local_data(
            sh, y[pid * 8:(pid + 1) * 8], global_shape=y.shape)
        losses.append(float(net.do_step(xg, yg)[0]))
    np.save(f"{outdir}/params_{pid}.npy", net.params_flat())
    report.update(losses=losses, mesh_ranks=mesh.ranks.tolist(),
                  output=net.output(x).numpy().tolist())

    # the collectives across the two processes
    mine = torch.arange(4, dtype=torch.float32) + 10 * pid
    shards = [mine if r == pid else None for r in (0, 1)]
    report["psum"] = M.psum(shards)[pid].tolist()
    report["all_gather"] = M.all_gather(shards, "cpu", ranks=[0, 1]).tolist()
    report["pmean"] = M.pmean([{"a": mine} if r == pid else None
                               for r in (0, 1)], ["cpu", "cpu"])[pid][
        "a"].tolist()
    errors = {}
    for name, build in (("data_model_1x2", lambda: M.data_model_mesh(1, 2)),
                        ("model_mesh_2", lambda: M.model_mesh(2))):
        try:
            build()
        except M.MeshGeometryError as e:
            errors[name] = str(e)
    report["model_axis_errors"] = errors
    report["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                                 for m in sys.modules)
    dist.shutdown()
    print("WORKER " + json.dumps(report), flush=True)
""")

LM_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, port, outdir, layout = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4])
    local = 2 if layout == "data_model" else 1
    masked = layout == "data_masked"

    from deeplearning4j_torch.parallel import distributed as dist
    dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=2, process_id=pid,
                    device=["cpu"] * local, timeout=60)
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.parallel import mesh as M
    from deeplearning4j_torch.parallel.model_sharding import shard_network
    from deeplearning4j_torch.utils.convert import params_from_jax

    cfg = json.load(open(f"{outdir}/config.json"))
    net = TransformerLM(**cfg).init(device="cpu")
    w = np.load(f"{outdir}/weights.npz")
    tree = {k: {} for k in net.params}
    for k in w.files:
        v, n = k.split("/")
        tree.setdefault(v, {})[n] = w[k]
    params_from_jax(tree, net)
    net.updater_state = net.conf.updater.init(net.params)
    mesh = (M.data_model_mesh(2, 2) if layout == "data_model"
            else M.data_mesh())
    shard_network(net, mesh)
    heads = []
    orig = fa.flash_attention

    def spy(q, k, v, **kw):
        heads.append(int(q.shape[1]))
        return orig(q, k, v, **kw)

    fa.flash_attention = spy
    data = np.load(f"{outdir}/data.npz")
    sh = M.DataSharding(mesh)
    B = data["x"].shape[1]
    rows = slice(pid * B // 2, (pid + 1) * B // 2)
    for i, (x, y) in enumerate(zip(data["x"], data["y"])):
        lm = (M.make_array_from_process_local_data(sh, data["m"][i][rows])
              if masked else None)
        net.do_step(M.make_array_from_process_local_data(sh, x[rows]),
                    M.make_array_from_process_local_data(sh, y[rows]),
                    label_mask=lm)
    np.save(f"{outdir}/params_{pid}.npy", net.params_flat())
    print("WORKER " + json.dumps(dict(heads=sorted(set(heads)),
                                      calls=len(heads))), flush=True)
    dist.shutdown()
""")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(tmp_path, source, *extra, n=2, timeout=240):
    """Start ``n`` rank processes of ``source`` against one rendezvous and
    return each one's ``WORKER`` report; any failure kills the others."""
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(port), str(tmp_path),
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
        lines = [ln for ln in out.splitlines() if ln.startswith("WORKER ")]
        assert lines, f"rank {pid} printed no report:\n{out}"
        reports.append(json.loads(lines[-1][len("WORKER "):]))
    return reports


# ---------------------------------------------------------- one process
class TestSingleProcess:
    def test_num_processes_one_is_a_no_op(self):
        distributed.initialize(num_processes=1)
        assert not distributed.is_initialized()
        assert distributed.process_index() == 0
        assert distributed.is_coordinator()

    def test_queries_answer_for_one_process(self):
        n = max(torch.cuda.device_count(), 1)
        assert distributed.global_device_count() == n
        assert distributed.local_device_count() == n
        assert distributed.device_layout() is None
        distributed.shutdown()           # no group: a no-op

    def test_no_arguments_and_no_torchrun_environment_raises(self,
                                                             monkeypatch):
        for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                     "MASTER_PORT"):
            monkeypatch.delenv(name, raising=False)
        with pytest.raises(ValueError, match="WORLD_SIZE"):
            distributed.initialize()
        with pytest.raises(ValueError, match="coordinator_address"):
            distributed.initialize(num_processes=2, process_id=0,
                                   device="cpu")
        assert not distributed.is_initialized()

    def test_nccl_needs_cards_and_cards_need_a_device(self, monkeypatch):
        with pytest.raises(ValueError, match="NCCL"):
            distributed.initialize("127.0.0.1:1", 2, 0, device="cpu",
                                   backend="nccl")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.initialize("127.0.0.1:1", 2, 0)
        assert not distributed.is_initialized()


class TestMeshAcrossProcesses:
    """A mesh with entry ranks, built in one process: what this process
    holds of it (rank 0 outside a group)."""

    def test_model_axis_across_processes_raises(self):
        with pytest.raises(MeshGeometryError, match="A11d"):
            Mesh([CPU] * 2, ("model",), ranks=[0, 1])
        with pytest.raises(MeshGeometryError, match="'model' axis"):
            Mesh(np.array([[CPU, CPU], [CPU, CPU]], dtype=object),
                 ("data", "model"), ranks=[[0, 1], [0, 1]])
        rows = Mesh(np.array([[CPU, CPU], [CPU, CPU]], dtype=object),
                    ("data", "model"), ranks=[[0, 0], [1, 1]])
        assert rows.spans_processes and rows.shape == {"data": 2,
                                                        "model": 2}

    def test_one_process_consumers_refuse_it(self):
        mesh = Mesh([CPU] * 2, ("data",), ranks=[0, 1])
        with pytest.raises(MeshGeometryError, match="one process"):
            mesh.flat
        from deeplearning4j_torch.parallel.mesh import data_devices
        with pytest.raises(MeshGeometryError, match="A11d"):
            data_devices(mesh)
        assert Mesh([CPU] * 2, ("data",)).flat == [CPU, CPU]

    def test_process_local_array_holds_this_process_rows(self):
        mesh = Mesh([CPU] * 4, ("data",), ranks=[0, 0, 1, 1])
        sh = DataSharding(mesh)
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        a = make_array_from_process_local_data(sh, x[:4], (8, 3))
        assert isinstance(a, ShardedArray) and a.process_local
        assert a.shape == (8, 3) and a.sharding.local_indices() == [0, 1]
        np.testing.assert_array_equal(a.pieces[0].numpy(), x[:2])
        np.testing.assert_array_equal(a.pieces[1].numpy(), x[2:4])
        assert a.pieces[2] is None and a.pieces[3] is None
        assert a.piece_bytes() == [24, 24, 0, 0]
        with pytest.raises(ValueError, match="this process's pieces"):
            np.asarray(a)
        with pytest.raises(ValueError, match="pieces of"):
            make_array_from_process_local_data(sh, x[:3], (8, 3))
        one = make_array_from_process_local_data(
            DataSharding(Mesh([CPU] * 2, ("data",))), x)
        assert not one.process_local and np.array_equal(np.asarray(one), x)


# --------------------------------------------------------- two processes
def jax_mlp():
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.nn.updater import Sgd

    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Sgd(learning_rate=0.1))
            .list(DenseLayer(n_out=16, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf).init()


def port_mlp(weights):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_torch.utils.convert import params_from_jax

    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Sgd(learning_rate=0.1))
            .list(DenseLayer(n_out=16, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return params_from_jax(weights, MultiLayerNetwork(conf).init(
        device="cpu"))


@pytest.mark.parametrize("how", ["address", "environment", "store"])
def test_two_process_training_equals_single_process(tmp_path, how):
    """``tests/test_multiprocess.py``'s contract: two gloo processes, one
    global data mesh, four Sgd steps on their rows; ranks bitwise equal and
    within 1e-6 of one process's steps on the whole batch (port and JAX).
    The children report the group's queries, the collectives across the
    two processes and the refusal of a model axis across them. They join
    the group by address, from torchrun's environment (no arguments), or
    through a store of their own."""
    jnet = jax_mlp()
    weights = jax.tree_util.tree_map(np.asarray, jnet.params)
    np.savez(tmp_path / "weights.npz",
             **{f"{k}/{n}": weights[k][n] for k in weights
                for n in weights[k]})
    reports = run_ranks(tmp_path, MLP_WORKER, how)

    rs = np.random.RandomState(0)
    x = rs.randn(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    single = port_mlp(weights)
    losses = []
    for _ in range(4):
        losses.append(float(single.do_step(x, y)[0]))
        jnet.do_step(x, y)

    p0 = np.load(tmp_path / "params_0.npy")
    p1 = np.load(tmp_path / "params_1.npy")
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_allclose(p0, single.params_flat(), atol=1e-6)
    np.testing.assert_allclose(p0, np.asarray(jnet.params_flat()),
                               atol=1e-6)
    for pid, r in enumerate(reports):
        assert r["backend"] == "gloo"
        assert (r["global_devices"], r["local_devices"],
                r["process_index"], r["coordinator"]) == (2, 1, pid,
                                                          pid == 0)
        assert r["mesh_ranks"] == [0, 1]
        assert not r["jax_imported"]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(r["output"], single.output(x).numpy(),
                                   atol=1e-6)
        assert r["psum"] == [10.0, 12.0, 14.0, 16.0]
        assert r["all_gather"] == [0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0,
                                   13.0]
        assert r["pmean"] == [5.0, 6.0, 7.0, 8.0]
        assert set(r["model_axis_errors"]) == {"data_model_1x2",
                                               "model_mesh_2"}
        assert all("A11d" in m for m in r["model_axis_errors"].values())
    assert reports[0]["losses"] == reports[1]["losses"]


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["data", "data_model", "data_masked"])
def test_two_process_transformer_lm_matches_jax_sharded_trainer(tmp_path,
                                                                layout):
    """The zoo TransformerLM (d_model 32, 4 heads, 1 block) sharded over a
    global ``data`` mesh (one CPU entry a process) or a global (data 2,
    model 2) mesh (two CPU entries a process, one data row each): three
    Adam steps on process-local rows, ranks bitwise equal, against JAX's
    ``ShardedTrainer`` on ``data_model_mesh(2, m)`` of its XLA CPU devices
    at rtol 1e-4 / atol 1e-5. ``data_masked`` adds a label mask whose
    totals differ between the ranks (each rank's share of the loss comes
    from the totals summed over the group), against JAX's unsharded steps
    under the same mask."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
    from deeplearning4j_tpu.parallel import model_sharding as jms
    from deeplearning4j_tpu.parallel.mesh import data_model_mesh

    V, T, B = 16, 8, 4
    cfg = dict(num_labels=V, max_length=T, d_model=32, n_heads=4,
               n_blocks=1, seed=3)
    jnet = JTransformerLM(**cfg).init()
    weights = jax.tree_util.tree_map(np.asarray, jnet.params)
    np.savez(tmp_path / "weights.npz",
             **{f"{k}/{n}": weights[k][n] for k in weights
                for n in weights[k]})
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    rs = np.random.RandomState(5)
    tok = rs.randint(0, V, (3, B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    xs, ys = eye[tok[:, :, :-1]], eye[tok[:, :, 1:]]
    ms = (rs.rand(3, B, T) > 0.3).astype(np.float32)
    ms[:, :B // 2, : T // 2] = 0.0          # rank 0 holds fewer labels
    np.savez(tmp_path / "data.npz", x=xs, y=ys, m=ms)
    reports = run_ranks(tmp_path, LM_WORKER, layout)

    model = 2 if layout == "data_model" else 1
    if layout == "data_masked":
        for x, y, m in zip(xs, ys, ms):
            jnet.do_step(x, y, label_masks=[m])
    else:
        trainer = jms.ShardedTrainer(jnet, data_model_mesh(2, model))
        for x, y in zip(xs, ys):
            trainer.fit(JDataSet(x, y))
    p0 = np.load(tmp_path / "params_0.npy")
    np.testing.assert_array_equal(p0, np.load(tmp_path / "params_1.npy"))
    np.testing.assert_allclose(p0, np.asarray(jnet.params_flat()),
                               rtol=1e-4, atol=1e-5)
    for r in reports:
        assert r["heads"] == [4 // model]
        # one core call per block on each of the process's model entries
        assert r["calls"] == 3 * model
