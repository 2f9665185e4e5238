"""Distributed (map-reduce) evaluation (port of
``deeplearning4j_tpu/parallel/evaluation.py``).

Reference: SparkDl4jMultiLayer.evaluate — executors each evaluate their
partitions into an IEvaluation, then the results are reduced with
IEvaluation.merge. Here the forward is split over the mesh's ``data``
devices (the "executors") and, by default, the reduce happens ON DEVICE:
each device accumulates its confusion/top-N/loss counts in the fused
evaluator and the W accumulators are summed once, so only the final
``[C, C]`` counts cross to the host. ``fused=False`` keeps the per-batch
map-reduce (the data-parallel forward of ``ParallelInference``, host-side
eval and merge per batch).
"""

from __future__ import annotations

import copy
from typing import Optional

from deeplearning4j_torch.parallel.inference import ParallelInference
from deeplearning4j_torch.parallel.mesh import data_mesh


def evaluate_on_mesh(net, iterator, mesh=None, evaluation=None, *,
                     fused: Optional[bool] = None,
                     eval_batches: Optional[int] = None):
    """Evaluate ``net`` over all batches of ``iterator`` with forwards
    split over ``mesh`` (default ``data_mesh()``: every CUDA device).
    ``evaluation`` is a prototype instance (configuration like label names
    or top_n is kept in the result). Default path: the device-side fused
    evaluator (merge = one sum of the devices' counts, one host fetch).
    ``fused=False``: per-batch forward, host-side eval and merge."""
    from deeplearning4j_torch.evaluation.classification import Evaluation

    if evaluation is None:
        evaluation = Evaluation()
    if mesh is None:
        mesh = data_mesh()
    if hasattr(iterator, "reset"):
        iterator.reset()

    if fused is None or fused:
        from deeplearning4j_torch.evaluation.fused_eval import (
            FusedEvalDriver)
        driver = FusedEvalDriver(net, eval_batches=eval_batches, mesh=mesh)
        return driver.evaluate(iterator, copy.deepcopy(evaluation))

    result = None
    with ParallelInference(net, mesh=mesh) as inf:
        for ds in iterator:
            out = inf.output(ds.features, mask=ds.features_mask)
            partial = copy.deepcopy(evaluation)
            partial.eval(ds.labels, out, mask=ds.labels_mask)
            if result is None:
                result = partial
            else:
                result.merge(partial)
    return result if result is not None else evaluation
