"""Port parity: sharded training-state checkpoints
(``deeplearning4j_torch/utils/orbax_checkpoint.py`` over
``torch.distributed.checkpoint``), the counterpart of
``tests/test_orbax_checkpoint.py``.

Both of the JAX file's contracts hold for the port: a restore without the
net (rebuilt from ``configuration.json``) equals the saved params at atol
0 with the iteration counter, and one more step on each stays within
1e-7; a sharded round trip on ``data_model_mesh(2, 4)`` (the CPU named
eight times) comes back with its sharding and every piece on its entry.
The port's ``configuration.json`` is read by JAX's ``serde.from_json``,
and the port's restored params equal JAX's ``load_checkpoint`` of the same
training within the Adam parity tolerance. The two-rank save (slow) is
written by two gloo processes and restored in this one.
"""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("orbax.checkpoint")

from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.nn.conf import builders as tb  # noqa: E402
from deeplearning4j_torch.nn.conf import inputs as tin  # noqa: E402
from deeplearning4j_torch.nn.conf import layers as tl  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TMLN)
from deeplearning4j_torch.nn import updater as tupd  # noqa: E402
from deeplearning4j_torch.parallel.mesh import data_model_mesh  # noqa
from deeplearning4j_torch.parallel.model_sharding import (  # noqa: E402
    MODEL_AXIS, SpecTensor, shard_network)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa
from deeplearning4j_torch.utils.orbax_checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet)
from deeplearning4j_tpu.nn import updater as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import builders as jb  # noqa: E402
from deeplearning4j_tpu.nn.conf import inputs as jin  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def conf(b, L, inp, upd):
    """The JAX test's net: Dense(16, relu) -> softmax(3), Adam(0.01),
    seed 5, in either package."""
    return (b.NeuralNetConfiguration.builder()
            .seed(5).updater(upd.Adam(learning_rate=0.01))
            .list(L.DenseLayer(n_out=16, activation="relu"),
                  L.OutputLayer(n_out=3, activation="softmax",
                                loss="mcxent"))
            .set_input_type(inp.InputType.feed_forward(4)).build())


@pytest.fixture(scope="module")
def jax_weights():
    return jax.tree_util.tree_map(
        np.asarray, JMLN(conf(jb, jl, jin, jupd)).init().params)


def _jnet(weights):
    net = JMLN(conf(jb, jl, jin, jupd)).init()
    net.params = jax.tree_util.tree_map(jax.numpy.asarray, weights)
    net.updater_state = net.conf.updater.init(net.params)
    return net


def _net(weights):
    return params_from_jax(weights, TMLN(conf(tb, tl, tin, tupd)).init(
        device="cpu"))


def _ds(seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 3, 32)
    return ((rs.randn(32, 4) + labels[:, None]).astype(np.float32),
            np.eye(3, dtype=np.float32)[labels])


def _pieces(tree):
    """``{path: [pieces]}`` of a tree of SpecTensor leaves."""
    out = {}
    for k, sub in tree.items():
        for n, st in sub.items():
            out[f"{k}/{n}"] = st.pieces
    return out


class TestOrbaxCheckpoint:
    def test_save_restore_resume(self, tmp_path, jax_weights):
        net = _net(jax_weights)
        x, y = _ds()
        for _ in range(5):
            net.fit(DataSet(x, y))
        save_checkpoint(net, str(tmp_path / "ckpt"))

        # restore WITHOUT the original object (config rebuilt from JSON)
        restored = load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
        np.testing.assert_allclose(restored.params_flat(),
                                   net.params_flat(), atol=0)
        assert restored.iteration == net.iteration == 5
        for k in ("m", "v"):
            for v in net.updater_state[k]:
                for n, t in net.updater_state[k][v].items():
                    assert torch.equal(restored.updater_state[k][v][n], t)

        # resume: one more step on each must match exactly
        net.fit(DataSet(x, y))
        restored.fit(DataSet(x, y))
        np.testing.assert_allclose(restored.params_flat(),
                                   net.params_flat(), atol=1e-7)

    def test_sharded_round_trip_preserves_sharding(self, tmp_path,
                                                   jax_weights):
        net = _net(jax_weights)
        mesh = data_model_mesh(2, 4, devices=[CPU] * 8)
        shard_network(net, mesh)
        net.fit(DataSet(*_ds(1)))
        save_checkpoint(net, str(tmp_path / "sharded"))

        # restore INTO a sharded target: arrays come back sharded
        net2 = _net(jax_weights)
        shard_network(net2, mesh)
        load_checkpoint(str(tmp_path / "sharded"), net=net2)
        np.testing.assert_allclose(net2.params_flat(), net.params_flat(),
                                   atol=0)
        s_orig = net.params["0"]["W"].sharding
        s_back = net2.params["0"]["W"].sharding
        assert s_back == s_orig
        assert s_back.spec == (None, MODEL_AXIS)
        assert net2.iteration == net.iteration
        # every piece of the params and the Adam moments back on its entry
        for tree, tree2 in ((net.params, net2.params),
                            (net.updater_state["m"], net2.updater_state["m"]),
                            (net.updater_state["v"],
                             net2.updater_state["v"])):
            got, want = _pieces(tree2), _pieces(tree)
            assert got.keys() == want.keys()
            for path in want:
                assert len(got[path]) == mesh.size
                for a, b in zip(got[path], want[path]):
                    assert a.device == b.device and torch.equal(a, b), path
        assert isinstance(net2.params["1"]["W"], SpecTensor)
        assert net2.params["0"]["W"].pieces[0].shape == (4, 4)

    def test_restore_into_another_sharding_and_unsharded(self, tmp_path,
                                                         jax_weights):
        """A checkpoint of a model-4 net restores into a model-2 net and
        an unsharded one: each target piece assembled from the saved
        pieces it overlaps."""
        net = _net(jax_weights)
        shard_network(net, data_model_mesh(2, 4, devices=[CPU] * 8))
        net.fit(DataSet(*_ds(2)))
        save_checkpoint(net, str(tmp_path / "c"))
        two = _net(jax_weights)
        shard_network(two, data_model_mesh(1, 2, devices=[CPU] * 2))
        load_checkpoint(str(tmp_path / "c"), net=two)
        assert two.params["0"]["W"].pieces[0].shape == (4, 8)
        plain = load_checkpoint(str(tmp_path / "c"), net=_net(jax_weights))
        assert torch.is_tensor(plain.params["0"]["W"])
        for other in (two, plain):
            np.testing.assert_array_equal(other.params_flat(),
                                          net.params_flat())
            assert other.iteration == 1

    def test_layout_records_each_piece_once_with_its_offset(self, tmp_path,
                                                            jax_weights):
        import torch.distributed.checkpoint as dcp

        net = _net(jax_weights)
        shard_network(net, data_model_mesh(2, 4, devices=[CPU] * 8))
        save_checkpoint(net, str(tmp_path / "c"))
        md = dcp.FileSystemReader(
            str(tmp_path / "c" / "state")).read_metadata()
        keys = md.state_dict_metadata
        assert [k for k in keys if k.startswith("params/0/W@")] == [
            f"params/0/W@0,{4 * e}" for e in range(4)]
        assert tuple(keys["params/0/W@0,4"].size) == (4, 4)
        # the 3-wide output bias does not split 4 ways: one whole piece
        assert [k for k in keys if k.startswith("params/1/b@")] == [
            "params/1/b@0"]
        assert {"counters/iteration@", "counters/epoch@"} <= set(keys)
        assert len(md.storage_data) == sum(
            len(m.chunks) for m in keys.values())

    def test_configuration_json_is_read_by_jax(self, tmp_path, jax_weights):
        from deeplearning4j_tpu.utils import serde as jserde

        save_checkpoint(_net(jax_weights), str(tmp_path / "c"))
        text = (tmp_path / "c" / "configuration.json").read_text()
        jconf = jserde.from_json(text)
        assert json.loads(jconf.to_json()) == json.loads(
            conf(jb, jl, jin, jupd).to_json())

    def test_restored_params_equal_jax_restore_of_the_same_training(
            self, tmp_path, jax_weights):
        from deeplearning4j_tpu.utils.orbax_checkpoint import (
            load_checkpoint as jload, save_checkpoint as jsave)

        x, y = _ds(3)
        net, jnet = _net(jax_weights), _jnet(jax_weights)
        for _ in range(4):
            net.fit(DataSet(x, y))
            jnet.fit(JDataSet(x, y))
        save_checkpoint(net, str(tmp_path / "port"))
        jsave(jnet, str(tmp_path / "jax"))
        mine = load_checkpoint(str(tmp_path / "port"), device="cpu")
        theirs = jload(str(tmp_path / "jax"))
        assert mine.iteration == theirs.iteration == 4
        np.testing.assert_allclose(mine.params_flat(),
                                   np.asarray(theirs.params_flat()),
                                   rtol=1e-5, atol=1e-6)


CKPT_WORKER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from deeplearning4j_torch.parallel import distributed as dist
dist.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                process_id=pid, device=["cpu", "cpu"], timeout=60)
from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.nn.conf import builders as b, inputs as i
from deeplearning4j_torch.nn.conf import layers as L
from deeplearning4j_torch.nn import updater as u
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.parallel.mesh import data_model_mesh
from deeplearning4j_torch.parallel.model_sharding import shard_network
from deeplearning4j_torch.utils.convert import params_from_jax
from deeplearning4j_torch.utils.orbax_checkpoint import save_checkpoint
conf = (b.NeuralNetConfiguration.builder().seed(5)
        .updater(u.Adam(learning_rate=0.01))
        .list(L.DenseLayer(n_out=16, activation="relu"),
              L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(i.InputType.feed_forward(4)).build())
w = np.load(f"{outdir}/weights.npz")
net = params_from_jax({k: {n: w[f"{k}/{n}"] for n in ("W", "b")}
                       for k in ("0", "1")},
                      MultiLayerNetwork(conf).init(device="cpu"))
shard_network(net, data_model_mesh(2, 2))
d = np.load(f"{outdir}/data.npz")
for _ in range(2):
    net.fit(DataSet(d["x"], d["y"]))
save_checkpoint(net, f"{outdir}/ckpt")
np.save(f"{outdir}/params_{pid}.npy", net.params_flat())
dist.shutdown()
print("WORKER " + json.dumps({"iteration": net.iteration}), flush=True)
"""


@pytest.mark.slow
def test_two_rank_save_restores_in_one_process(tmp_path, jax_weights):
    """Two gloo processes of two CPU entries each train on a global (data
    2, model 2) mesh, one data row a process, and save; this process
    restores without a net and equals both ranks' params bitwise, and the
    rank-0-only configuration is there."""
    from tests.test_torch_distributed import run_ranks

    np.savez(tmp_path / "weights.npz",
             **{f"{k}/{n}": jax_weights[k][n] for k in jax_weights
                for n in jax_weights[k]})
    x, y = _ds(4)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    reports = run_ranks(tmp_path, CKPT_WORKER)
    assert [r["iteration"] for r in reports] == [2, 2]
    assert os.path.exists(tmp_path / "ckpt" / "configuration.json")
    restored = load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert restored.iteration == 2
    p0 = np.load(tmp_path / "params_0.npy")
    np.testing.assert_array_equal(p0, np.load(tmp_path / "params_1.npy"))
    np.testing.assert_array_equal(restored.params_flat(), p0)
    single = _net(jax_weights)
    for _ in range(2):
        single.fit(DataSet(x, y))
    np.testing.assert_allclose(p0, single.params_flat(), rtol=1e-5,
                               atol=1e-6)
