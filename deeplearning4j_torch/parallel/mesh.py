"""Device-mesh errors (the port's own copy of the exception of
``deeplearning4j_tpu/parallel/mesh.py``).

Only ``MeshGeometryError`` is here: ``fleet.device_groups`` raises it. The
meshes themselves (``data_mesh``, ``model_mesh``) and tensor-parallel
serving over ``torch.distributed`` are not ported yet (ROADMAP A9).
"""

from __future__ import annotations


class MeshGeometryError(ValueError):
    """Typed, loud mesh-geometry failure: the requested replica groups do
    not fit the device count. A plain ``ValueError`` subclass so
    ``except ValueError`` callers keep working, but catchable on its own by
    fleet factories that want to fall back to a smaller layout."""
