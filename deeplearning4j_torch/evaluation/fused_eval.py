"""Device-resident evaluation (port of
``deeplearning4j_tpu/evaluation/fused_eval.py``).

- ``build_eval_stats``: one forward per batch giving the output head's
  activation (what ``output()`` returns) and, where the net has a loss
  head, its per-example loss from the same pre-head activations.
- ``_accumulate``: argmax, then the counts added into a device-side
  accumulator of int32 counts (the confusion matrix, the top-N counters)
  and f32 loss sums; rows or steps of eval weight 0 add nothing.
- ``FusedEvalDriver``: blocks of K batches with the fused-fit shape bucket
  (the first usable batch fixes it; a shorter batch is padded up by
  repeating its last row with eval weight 0, so the counts are those of
  the unpadded batch), copied to the device ahead of use
  (``device_put_ahead``), and ONE host fetch at the end of the call: the
  ``C²`` counts and four scalars.
- With ``mesh=`` (a ``parallel/mesh.py`` mesh with a ``data`` axis) the
  bucket rounds up to a multiple of the W data devices, each block's batch
  axis is split into W equal pieces, each device's replica of the params
  computes its piece into its own accumulator, and the W accumulators are
  summed once at the end (JAX's cross-replica merge).

The counts are ``Evaluation.eval``'s: 2-D ``[B, C]`` labels ignore any
labels mask (only padded rows get weight 0); 3-D ``[B, T, C]`` labels weight
the steps by the labels mask. Top-N counts the true class when fewer than
N classes score strictly higher (``argpartition`` membership, except on an
exact tie at the N-th place).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.optimize.fused_fit import (DEFAULT_FUSED_STEPS,
                                                     FusedFitDriver,
                                                     device_put_ahead)

#: batches per block on the CPU (the JAX package's CPU eval width)
DEFAULT_EVAL_BATCHES_CPU = 8


def resolve_eval_batches(net, eval_batches) -> int:
    """K: ``eval_batches``, or the default for the net's device type."""
    if eval_batches is None:
        dev = getattr(net, "device", None)
        return (DEFAULT_EVAL_BATCHES_CPU if dev is None or dev.type == "cpu"
                else DEFAULT_FUSED_STEPS)
    k = int(eval_batches)
    if k < 1:
        raise ValueError(f"eval_batches must be >= 1, got {eval_batches}")
    return k


def build_eval_stats(net):
    """``stats(params, state, x, y, im) -> (probs, per_ex_loss)`` for a
    MultiLayerNetwork or the first output of a ComputationGraph;
    ``per_ex_loss`` is None without a loss head."""
    from deeplearning4j_torch.nn.conf.layers.misc import (
        CenterLossOutputLayer)

    def head_loss(layer, p_out, last_in, y, st):
        if not hasattr(layer, "compute_loss_per_example"):
            return None
        if isinstance(layer, CenterLossOutputLayer):
            return layer.compute_loss_per_example(p_out, last_in, y,
                                                  state=st)
        return layer.compute_loss_per_example(p_out, last_in, y)

    layers = getattr(net, "layers", None)
    if isinstance(layers, list):
        out_idx = len(layers) - 1
        out_layer = layers[out_idx]
        key = str(out_idx)

        def stats(params, state, x, y, im):
            last_in, _, mask = net._forward(params, state, x, im,
                                            upto=out_idx)
            prep = net.conf.preprocessors.get(out_idx)
            if prep is not None:
                last_in = prep.forward(last_in)
                mask = prep.feed_forward_mask(mask)
            probs, _ = out_layer.forward(params[key], state.get(key, {}),
                                         last_in, mask=mask)
            return probs, head_loss(out_layer, params[key], last_in, y,
                                    state.get(key))

        return stats

    name = net.conf.network_outputs[0]
    vertex = net.conf.vertices[name]

    def stats(params, state, x, y, im):
        outs, _, masks, loss_inputs = net._forward(
            params, state, [x], [im], collect_loss_inputs=True)
        if name not in loss_inputs:
            return outs[0], None
        layer = vertex.layer
        last_in = loss_inputs[name]
        probs, _ = layer.forward(params.get(name, {}), state.get(name, {}),
                                 last_in, mask=masks[0])
        return probs, head_loss(layer, params.get(name, {}), last_in, y,
                                state.get(name))

    return stats


def init_accumulator(num_classes: int, device) -> dict:
    """A zeroed accumulator on ``device``: int32 counts (an evaluation stays
    far below 2^31 examples per cell), f32 loss sums."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"confusion": zeros((num_classes, num_classes), torch.int32),
            "top_n_correct": zeros((), torch.int32),
            "top_n_total": zeros((), torch.int32),
            "loss_sum": zeros((), torch.float32),
            "loss_weight": zeros((), torch.float32)}


def _accumulate(acc, probs, y, ew, per_ex, top_n: int, num_classes: int):
    """Add one batch into ``acc`` in place. ``ew`` is the eval weight
    (``[B]``, or ``[B, T]`` for time series)."""
    if probs.dim() == 3:
        p = probs.reshape(-1, probs.shape[-1])
        t = y.reshape(-1, y.shape[-1])
        w = ew.reshape(-1)
    else:
        p, t, w = probs, y, ew
    wi = (w != 0).to(torch.int32)
    true_idx = t.argmax(dim=-1)
    pred_idx = p.argmax(dim=-1)
    acc["confusion"].index_put_((true_idx, pred_idx), wi, accumulate=True)
    if top_n > 1:
        if top_n >= num_classes:
            hit = torch.ones_like(wi)
        else:
            p_true = p.gather(-1, true_idx[:, None])
            hit = ((p > p_true).sum(dim=-1) < top_n).to(torch.int32)
        acc["top_n_correct"] += (hit * wi).sum().to(torch.int32)
        acc["top_n_total"] += wi.sum().to(torch.int32)
    if per_ex is not None:
        wl = ew.reshape(per_ex.shape).to(per_ex.dtype)
        acc["loss_sum"] += (per_ex * wl).sum().float()
        acc["loss_weight"] += wl.sum().float()
    return acc


class FusedEvalDriver:
    """Consumes a stream of DataSets as K-batch eval blocks into one device
    accumulator. Batches that do not fit the bucket (other trailing dims,
    larger than the bucket, no labels) take the host per-batch path: the
    evaluation is a sum, so mixing the paths reorders nothing."""

    def __init__(self, net, eval_batches: Optional[int] = None,
                 prefetch_depth: int = 2, mesh=None):
        from deeplearning4j_torch.parallel.mesh import data_devices

        self.net = net
        self.K = resolve_eval_batches(net, eval_batches)
        self.depth = max(1, prefetch_depth)
        self.mesh = mesh
        self._devices = ([net.device] if mesh is None
                         else data_devices(mesh))
        self._row_multiple = len(self._devices)

    # ------------------------------------------------------------- assembly
    def _blocks(self, batches):
        from deeplearning4j_torch.datasets.dataset import DataSet

        bucket = None
        pend: list = []
        for ds in batches:
            item = None
            if (isinstance(ds, DataSet) and ds.labels is not None
                    and ds.labels.ndim >= 2):
                f, y = ds.features, ds.labels
                im, lm = ds.features_mask, ds.labels_mask
                if bucket is None:
                    B = -(-f.shape[0] // self._row_multiple) \
                        * self._row_multiple
                    bucket = (B, tuple(f.shape[1:]), tuple(y.shape[1:]),
                              im is not None)
                B, ftail, ltail, has_im = bucket
                if (tuple(f.shape[1:]) == ftail
                        and tuple(y.shape[1:]) == ltail
                        and (im is not None) == has_im
                        and f.shape[0] <= B):
                    item = self._pad_micro(f, y, im, lm, B)
            if item is not None:
                pend.append(item)
                if len(pend) == self.K:
                    yield ("block", FusedFitDriver._stack(pend))
                    pend = []
            else:
                yield ("raw", ds)
        if pend:
            yield ("block", FusedFitDriver._stack(pend))

    @staticmethod
    def _pad_micro(f, y, im, lm, B):
        n = f.shape[0]
        if y.ndim == 3:
            # time series: the labels mask weights the steps
            ew = (np.ones(y.shape[:2], np.float32) if lm is None
                  else np.asarray(torch.as_tensor(lm).cpu(), np.float32)
                  .reshape(y.shape[:2]))
        else:
            # 2-D labels: any mask is ignored; only padded rows weigh 0
            ew = np.ones((n,), np.float32)
        f, y, im, _ = FusedFitDriver._pad_micro(f, y, im, None, B,
                                                tuple(y.shape[1:]), False)
        if B > n:
            ew = np.concatenate(
                [ew, np.zeros((B - n,) + ew.shape[1:], ew.dtype)])
        return (f, y, im, ew)

    # ------------------------------------------------------------ execution
    @torch.inference_mode()
    def evaluate(self, batches, evaluation):
        """Evaluate the stream into ``evaluation`` (mutated and returned)."""
        from deeplearning4j_torch.parallel.mesh import Replicas

        net = self.net
        ev = evaluation
        top_n = getattr(ev, "top_n", 1)
        dtype = getattr(torch, net.conf.dtype)
        stats = build_eval_stats(net)
        place = FusedFitDriver(net, 1)._place
        replicas = Replicas(net)
        devices = self._devices
        accs = None
        num_classes = None
        for tag, payload in device_put_ahead(self._blocks(batches),
                                             self.depth, place):
            if tag == "raw":
                out = net._output_one(payload.features,
                                      payload.features_mask)
                ev.eval(payload.labels, out.float().cpu().numpy(),
                        mask=payload.labels_mask)
                continue
            xs, ys, ims, ews = payload
            if accs is None:
                num_classes = ev.num_classes or ys.shape[-1]
                accs = [init_accumulator(num_classes, d) for d in devices]
            xs, ys = xs.to(dtype), ys.to(dtype)
            rows = xs.shape[1] // len(devices)
            for k in range(xs.shape[0]):
                for i, dev in enumerate(devices):
                    part = slice(i * rows, (i + 1) * rows)
                    probs, per_ex = stats(
                        *replicas.weights(dev), xs[k][part].to(dev),
                        ys[k][part].to(dev),
                        None if ims is None
                        else ims[k][part].to(dev, torch.float32))
                    _accumulate(accs[i], probs, ys[k][part].to(dev),
                                ews[k][part].to(dev), per_ex, top_n,
                                num_classes)
        if accs is not None:
            # the merge: the devices' counts summed once, in mesh order
            acc = {key: sum((a[key].to(net.device) for a in accs[1:]),
                            accs[0][key]) for key in accs[0]}
            # the one fetch: C² counts and four scalars
            C2 = num_classes * num_classes
            host = torch.cat([acc["confusion"].reshape(-1).double(),
                              torch.stack([acc[k].double() for k in (
                                  "top_n_correct", "top_n_total",
                                  "loss_sum", "loss_weight")])
                              ]).cpu().numpy()
            dev_ev = type(ev)(num_classes=num_classes, top_n=top_n)
            dev_ev.confusion = host[:C2].reshape(
                num_classes, num_classes).astype(np.int64)
            dev_ev.top_n_correct = int(host[C2])
            dev_ev.top_n_total = int(host[C2 + 1])
            ev.merge(dev_ev)
            if host[C2 + 3] > 0:
                ev.eval_loss = float(host[C2 + 2]) / float(host[C2 + 3])
        return ev
