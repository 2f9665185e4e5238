"""H100 fleet provisioning over the gcloud CLI (port of
``deeplearning4j_tpu/cloud/provision.py``).

Reference analog (deeplearning4j-scaleout/deeplearning4j-aws), as in the
JAX module:
- ``Ec2BoxCreator`` -> ``GpuVmProvisioner``: create, describe and delete A3
  H100 instances (``gcloud compute instances``) and wait for RUNNING; it
  takes a list of instances where the JAX module's ``TpuVmProvisioner``
  takes one pod slice and its ``--worker=all``.
- ``HostProvisioner`` / ``ClusterSetup`` -> ``ClusterSetup``: push the
  training package to every instance (``gcloud compute scp``, ``gcloud
  compute ssh``) and launch the distributed run on all of them: the same
  command under ``torchrun`` on each instance (``--nnodes``,
  ``--node-rank``, ``--nproc-per-node``, instance 0 as ``--master-addr``),
  whose processes join the group with ``parallel/distributed.py::
  initialize()`` and no arguments, as the JAX launch's workers call
  ``jax.distributed.initialize()``.
- ``S3Uploader`` / ``S3Downloader`` -> ``GcsTransfer`` via gsutil.

Everything builds explicit argv lists. ``dry_run=True`` records the argv
instead of executing, which is what the tests assert against; the same
commands run verbatim against a real project when ``dry_run=False``
(``gcloud`` must be on PATH; nothing in this module imports a cloud SDK).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time
from typing import List, Optional, Sequence, Union

#: an A3 machine: eight H100 80GB cards on NVLink
DEFAULT_MACHINE_TYPE = "a3-highgpu-8g"
DEFAULT_IMAGE_FAMILY = "common-cu124-debian-11"
DEFAULT_IMAGE_PROJECT = "deeplearning-platform-release"
DEFAULT_MASTER_PORT = 29500

Names = Union[str, Sequence[str]]


def _names(names: Names) -> List[str]:
    out = [names] if isinstance(names, str) else list(names)
    if not out:
        raise ValueError("no instance named")
    return out


class CommandRunner:
    """Executes (or, dry_run, records) argv lists. One seam for tests and
    for the real CLI; keeps provisioning logic free of subprocess
    details."""

    def __init__(self, dry_run: bool = False):
        self.dry_run = dry_run
        self.history: List[List[str]] = []
        self.canned: dict = {}  # prefix tuple -> stdout (dry-run responses)

    def _canned(self, argv: List[str]) -> str:
        for prefix, out in self.canned.items():
            if tuple(argv[:len(prefix)]) == tuple(prefix):
                return out
        return ""

    def run(self, argv: Sequence[str], check: bool = True) -> str:
        argv = list(argv)
        self.history.append(argv)
        if self.dry_run:
            return self._canned(argv)
        proc = subprocess.run(argv, capture_output=True, text=True)
        if check and proc.returncode != 0:
            raise RuntimeError(
                f"command failed ({proc.returncode}): "
                f"{shlex.join(argv)}\n{proc.stderr}")
        return proc.stdout

    def run_all(self, argvs: Sequence[Sequence[str]]) -> List[str]:
        """Run every argv at once and wait for all (the counterpart of
        gcloud's ``--worker=all``: a launch whose processes wait for each
        other must not run one instance after another); their outputs in
        order."""
        argvs = [list(a) for a in argvs]
        self.history.extend(argvs)
        if self.dry_run:
            return [self._canned(a) for a in argvs]
        procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for a in argvs]
        outs = [p.communicate() for p in procs]
        for a, p, (_, err) in zip(argvs, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"command failed ({p.returncode}): {shlex.join(a)}\n"
                    f"{err}")
        return [out for out, _ in outs]

    def script(self) -> str:
        """The recorded session as a copy-pasteable shell script."""
        return "\n".join(shlex.join(argv) for argv in self.history)


class GpuVmProvisioner:
    """Create / inspect / delete H100 instances (reference:
    Ec2BoxCreator.create + blockTillAllRunning)."""

    def __init__(self, project: str, zone: str, runner: CommandRunner):
        self.project = project
        self.zone = zone
        self.runner = runner

    def _where(self) -> List[str]:
        return [f"--project={self.project}", f"--zone={self.zone}",
                "--quiet"]

    def _instances(self, *args: str) -> List[str]:
        return ["gcloud", "compute", "instances", *args, *self._where()]

    def create(self, names: Names,
               machine_type: str = DEFAULT_MACHINE_TYPE,
               image_family: str = DEFAULT_IMAGE_FAMILY,
               image_project: str = DEFAULT_IMAGE_PROJECT,
               preemptible: bool = False) -> None:
        """One ``instances create`` for every name. A GPU instance cannot
        live-migrate, so its host maintenance terminates it."""
        argv = self._instances("create", *_names(names),
                               f"--machine-type={machine_type}",
                               f"--image-family={image_family}",
                               f"--image-project={image_project}",
                               "--maintenance-policy=TERMINATE")
        if preemptible:
            argv.append("--preemptible")
        self.runner.run(argv)

    def describe(self, name: str) -> str:
        return self.runner.run(
            self._instances("describe", name, "--format=value(status)"))

    def wait_until_ready(self, names: Names, timeout_s: float = 600,
                         poll_s: float = 10) -> None:
        """Poll each instance until its status is RUNNING
        (Ec2BoxCreator.blockTillAllRunning)."""
        deadline = time.monotonic() + timeout_s
        for name in _names(names):
            while True:
                status = self.describe(name).strip()
                if status == "RUNNING":
                    break
                if self.runner.dry_run:
                    break  # recorded the poll; nothing to wait for
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"instance {name} not RUNNING after {timeout_s}s "
                        f"(status={status!r})")
                time.sleep(poll_s)

    def delete(self, names: Names) -> None:
        self.runner.run(self._instances("delete", *_names(names)))

    def _ssh_argv(self, name: str, command: str) -> List[str]:
        return ["gcloud", "compute", "ssh", name, f"--command={command}",
                *self._where()]

    def ssh(self, name: str, command: str) -> str:
        """Run a command on one instance
        (HostProvisioner.runRemoteCommand)."""
        return self.runner.run(self._ssh_argv(name, command))

    def scp(self, name: str, local: str, remote: str) -> None:
        """Push a file or directory to one instance
        (HostProvisioner.uploadFile). A directory (an unpacked training
        package) needs gcloud's --recurse or the copy fails at runtime."""
        extra = ["--recurse"] if os.path.isdir(local) else []
        self.runner.run(["gcloud", "compute", "scp", *extra, local,
                         f"{name}:{remote}", *self._where()])


class GcsTransfer:
    """gsutil up/down (reference: s3/uploader/S3Uploader.java,
    s3/reader/S3Downloader.java)."""

    def __init__(self, runner: CommandRunner):
        self.runner = runner

    def upload(self, local: str, gcs_uri: str) -> None:
        if not gcs_uri.startswith("gs://"):
            raise ValueError(f"not a GCS uri: {gcs_uri}")
        self.runner.run(["gsutil", "-m", "cp", "-r", local, gcs_uri])

    def download(self, gcs_uri: str, local: str) -> None:
        if not gcs_uri.startswith("gs://"):
            raise ValueError(f"not a GCS uri: {gcs_uri}")
        self.runner.run(["gsutil", "-m", "cp", "-r", gcs_uri, local])


class ClusterSetup:
    """Provision instances, push the training package, launch the
    distributed run on every instance (reference: ec2/provision/
    ClusterSetup.java + DistributedDeepLearningTrainer.java, whose flow is:
    create boxes, provision each over SSH, start the distributed job)."""

    def __init__(self, project: str, zone: str, dry_run: bool = False):
        self.runner = CommandRunner(dry_run=dry_run)
        self.gpus = GpuVmProvisioner(project, zone, self.runner)
        self.gcs = GcsTransfer(self.runner)

    def provision(self, names: Names,
                  machine_type: str = DEFAULT_MACHINE_TYPE,
                  image_family: str = DEFAULT_IMAGE_FAMILY,
                  package_path: Optional[str] = None,
                  pip_spec: str = "deeplearning4j_torch") -> None:
        names = _names(names)
        self.gpus.create(names, machine_type, image_family)
        self.gpus.wait_until_ready(names)
        for name in names:
            if package_path is not None:
                self.gpus.ssh(name, "mkdir -p ~/pkg")
                self.gpus.scp(name, package_path, "~/pkg/")
                self.gpus.ssh(name, "pip install ~/pkg/*")
            else:
                self.gpus.ssh(name, f"pip install {pip_spec}")

    @staticmethod
    def _torchrun(names: List[str], node_rank: int, train_command: str,
                  nproc_per_node: int, master_port: int) -> str:
        """``train_command`` under ``torchrun`` as instance ``node_rank``
        runs it: one process a card, instance 0 the rendezvous."""
        return shlex.join([
            "torchrun", f"--nnodes={len(names)}",
            f"--node-rank={node_rank}",
            f"--nproc-per-node={nproc_per_node}",
            f"--master-addr={names[0]}", f"--master-port={master_port}",
            "--no-python", *shlex.split(train_command)])

    def launch(self, names: Names, train_command: str,
               nproc_per_node: int = 8,
               master_port: int = DEFAULT_MASTER_PORT) -> List[str]:
        """Start ``train_command`` on every instance at once under
        ``torchrun`` (the ClusterSetup.java 'distributed launch' step);
        each process's ``distributed.initialize()`` reads its rank and the
        rendezvous from torchrun's environment. Returns each instance's
        output."""
        names = _names(names)
        return self.runner.run_all([
            self.gpus._ssh_argv(name, self._torchrun(
                names, rank, train_command, nproc_per_node, master_port))
            for rank, name in enumerate(names)])

    def teardown(self, names: Names) -> None:
        self.gpus.delete(names)
