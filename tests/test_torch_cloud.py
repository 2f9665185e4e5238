"""Port parity: the cloud provisioning command layer
(``deeplearning4j_torch/cloud/provision.py``), the counterpart of
``tests/test_cloud.py``. Every test runs in dry-run mode and asserts the
exact gcloud/gsutil argv the module would execute: the port drives A3 H100
instances (``gcloud compute instances``, ``gcloud compute ssh``/``scp``)
where the JAX module drives TPU VMs, takes a list of instances where JAX
takes one slice, and launches ``torchrun`` on each instance."""

import shlex

import pytest

from deeplearning4j_torch.cloud import (ClusterSetup, CommandRunner,
                                        GcsTransfer, GpuVmProvisioner)
from deeplearning4j_torch.cloud import provision as tprov
from deeplearning4j_tpu.cloud import ClusterSetup as JClusterSetup
from deeplearning4j_tpu.cloud import GcsTransfer as JGcsTransfer
from deeplearning4j_tpu.cloud.provision import CommandRunner as JRunner

pytestmark = pytest.mark.torch_port

WHERE = ["--project=my-proj", "--zone=us-central1-a", "--quiet"]


class TestGpuVmProvisioner:
    def test_create_describe_delete_argv(self):
        r = CommandRunner(dry_run=True)
        gpus = GpuVmProvisioner("my-proj", "us-central1-a", r)
        gpus.create(["node0", "node1"], machine_type="a3-highgpu-8g",
                    preemptible=True)
        gpus.describe("node0")
        gpus.delete(["node0", "node1"])
        create, describe, delete = r.history
        assert create[:4] == ["gcloud", "compute", "instances", "create"]
        assert create[4:6] == ["node0", "node1"]
        assert "--machine-type=a3-highgpu-8g" in create
        assert "--maintenance-policy=TERMINATE" in create
        assert "--preemptible" in create
        assert create[-4:-1] == WHERE and create[-1] == "--preemptible"
        assert describe == ["gcloud", "compute", "instances", "describe",
                            "node0", "--format=value(status)", *WHERE]
        assert delete == ["gcloud", "compute", "instances", "delete",
                          "node0", "node1", *WHERE]

    def test_one_name_is_one_instance(self):
        r = CommandRunner(dry_run=True)
        GpuVmProvisioner("p", "z", r).create("solo")
        (create,) = r.history
        assert create[4] == "solo" and create[5].startswith("--")
        assert "--preemptible" not in create

    @pytest.mark.parametrize("names", [["node0"], ["node0", "node1",
                                                   "node2"]])
    def test_wait_until_ready_polls_each_instance(self, names):
        r = CommandRunner(dry_run=True)
        r.canned[("gcloud", "compute", "instances", "describe")] = \
            "RUNNING\n"
        GpuVmProvisioner("p", "z", r).wait_until_ready(names)
        polled = [argv[4] for argv in r.history if "describe" in argv]
        assert polled == names

    def test_wait_until_ready_times_out_on_a_stuck_instance(self,
                                                            monkeypatch):
        r = CommandRunner(dry_run=False)
        monkeypatch.setattr(r, "run", lambda argv, check=True: "STAGING\n")
        with pytest.raises(TimeoutError, match="not RUNNING"):
            GpuVmProvisioner("p", "z", r).wait_until_ready(
                "node0", timeout_s=0.0, poll_s=0.0)

    def test_ssh_and_scp_target_one_instance(self):
        r = CommandRunner(dry_run=True)
        gpus = GpuVmProvisioner("p", "z", r)
        gpus.ssh("node1", "hostname")
        gpus.scp("node1", "wheel.whl", "~/wheel.whl")
        ssh, scp = r.history
        assert ssh[:4] == ["gcloud", "compute", "ssh", "node1"]
        assert "--command=hostname" in ssh
        assert not any(a.startswith("--worker") for a in ssh)
        assert scp[:3] == ["gcloud", "compute", "scp"]
        assert "node1:~/wheel.whl" in scp
        assert "--recurse" not in scp  # plain file: no recursive copy

    def test_scp_directory_adds_recurse(self, tmp_path):
        # a directory package (ClusterSetup pushes "the training package")
        # needs gcloud's --recurse or the copy fails at runtime
        r = CommandRunner(dry_run=True)
        pkg = tmp_path / "pkg"
        pkg.mkdir()
        GpuVmProvisioner("p", "z", r).scp("node0", str(pkg), "~/pkg")
        (scp,) = r.history
        assert "--recurse" in scp
        assert scp.index("--recurse") < scp.index(str(pkg))


class TestGcsTransfer:
    def test_upload_download_argv_equal_jax(self):
        r, jr = CommandRunner(dry_run=True), JRunner(dry_run=True)
        for runner, cls in ((r, GcsTransfer), (jr, JGcsTransfer)):
            gcs = cls(runner)
            gcs.upload("model.zip", "gs://bucket/model.zip")
            gcs.download("gs://bucket/data", "data/")
        assert r.history == jr.history
        assert r.history[0] == ["gsutil", "-m", "cp", "-r", "model.zip",
                                "gs://bucket/model.zip"]
        with pytest.raises(ValueError):
            GcsTransfer(r).upload("x", "s3://nope")
        with pytest.raises(ValueError):
            GcsTransfer(r).download("s3://nope", "x")


class TestClusterSetup:
    NODES = ["train-0", "train-1"]

    def test_full_flow_records_a_runnable_script(self):
        cs = ClusterSetup("my-proj", "us-central1-a", dry_run=True)
        cs.provision(self.NODES, package_path="dist/pkg.whl")
        cs.launch(self.NODES, "python -m train --epochs 10")
        cs.teardown(self.NODES)
        script = cs.runner.script()
        # ordered: create -> describe(wait) -> scp -> pip -> launch -> delete
        order = [script.index(tok) for tok in
                 ("create", "describe", "scp", "pip install",
                  "python -m train", "delete")]
        assert order == sorted(order), script
        # every line is a real gcloud/gsutil invocation
        assert all(line.startswith(("gcloud ", "gsutil "))
                   for line in script.splitlines())

    def test_flow_matches_jax_step_for_step(self):
        """The same steps in JAX's order, one per instance where JAX's
        reaches every worker of its slice at once."""
        def steps(history):
            out = []
            for argv in history:
                line = " ".join(argv)
                for tok in ("create", "describe", "mkdir -p ~/pkg", "scp",
                            "pip install", "python -m train", "delete"):
                    if tok in line:
                        out.append(tok)
                        break
            return out

        cs = ClusterSetup("p", "z", dry_run=True)
        cs.provision(["solo"], package_path="dist/pkg.whl")
        cs.launch(["solo"], "python -m train --epochs 10")
        cs.teardown(["solo"])
        jcs = JClusterSetup("p", "z", dry_run=True)
        jcs.provision("pod", package_path="dist/pkg.whl")
        jcs.launch("pod", "python -m train --epochs 10")
        jcs.teardown("pod")
        assert steps(cs.runner.history) == steps(jcs.runner.history)

    def test_pip_spec_install_when_no_package(self):
        cs = ClusterSetup("p", "z", dry_run=True)
        cs.provision(self.NODES, pip_spec="deeplearning4j_torch==1.0")
        installs = [argv for argv in cs.runner.history
                    if "--command=pip install deeplearning4j_torch==1.0"
                    in argv]
        assert [argv[3] for argv in installs] == self.NODES

    def test_package_pushed_to_every_instance(self):
        cs = ClusterSetup("p", "z", dry_run=True)
        cs.provision(self.NODES, package_path="dist/pkg.whl")
        scps = [argv for argv in cs.runner.history if argv[2] == "scp"]
        assert [a[-4] for a in scps] == [f"{n}:~/pkg/" for n in self.NODES]

    @pytest.mark.parametrize("nproc", [1, 8])
    def test_launch_runs_torchrun_on_each_instance(self, nproc):
        cs = ClusterSetup("p", "z", dry_run=True)
        cs.launch(self.NODES, "python -m train --epochs 10",
                  nproc_per_node=nproc, master_port=29512)
        assert len(cs.runner.history) == 2
        for rank, (name, argv) in enumerate(zip(self.NODES,
                                                cs.runner.history)):
            assert argv[:4] == ["gcloud", "compute", "ssh", name]
            (cmd,) = [a[len("--command="):] for a in argv
                      if a.startswith("--command=")]
            assert shlex.split(cmd) == [
                "torchrun", "--nnodes=2", f"--node-rank={rank}",
                f"--nproc-per-node={nproc}", "--master-addr=train-0",
                "--master-port=29512", "--no-python", "python", "-m",
                "train", "--epochs", "10"]

    def test_launch_starts_every_instance_before_waiting(self, monkeypatch):
        """A launch's instances wait for each other at the rendezvous, so
        they start together (JAX's ``--worker=all``), not in turn."""
        started, waited = [], []

        class FakeProc:
            def __init__(self, argv, **kw):
                started.append(argv[3])
                self.returncode = 0

            def communicate(self):
                waited.append(len(started))
                return "ok", ""

        monkeypatch.setattr(tprov.subprocess, "Popen", FakeProc)
        cs = ClusterSetup("p", "z", dry_run=False)
        assert cs.launch(self.NODES, "python train.py") == ["ok", "ok"]
        assert started == self.NODES and waited == [2, 2]

    def test_failed_command_raises_with_its_argv(self, monkeypatch):
        class Done:
            returncode = 3
            stdout = ""
            stderr = "quota exceeded"

        monkeypatch.setattr(tprov.subprocess, "run",
                            lambda argv, **kw: Done())
        cs = ClusterSetup("p", "z", dry_run=False)
        with pytest.raises(RuntimeError, match="quota exceeded"):
            cs.teardown(["node0"])
