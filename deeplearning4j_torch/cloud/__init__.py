"""Cloud provisioning for H100 training fleets (port of
``deeplearning4j_tpu/cloud``).

The JAX package's analog of the reference's deeplearning4j-aws module
drives TPU VMs; the port drives A3 H100 instances the same way: instance
creation, SSH fan-out and GCS transfer through the ``gcloud``/``gsutil``
CLIs, and a ``torchrun`` launch on every instance that
``parallel/distributed.py::initialize()`` picks up from the environment.
"""

from deeplearning4j_torch.cloud.provision import (
    ClusterSetup,
    CommandRunner,
    GcsTransfer,
    GpuVmProvisioner,
)

__all__ = ["ClusterSetup", "CommandRunner", "GcsTransfer",
           "GpuVmProvisioner"]
