"""Load the JAX package's parameters and updater state into the port.

``params_from_jax`` takes the reference net's parameters as numpy arrays —
``{vertex: {name: ndarray}}`` for a graph, ``{layer index: {name:
ndarray}}`` for a MultiLayerNetwork, as ``jax.device_get(net.params)``
gives them — and loads them into the port's net unchanged: the layouts are
the same on both sides (Dense ``W`` is ``[n_in, n_out]``, convolution
kernels HWIO, the mixture-of-experts leaves ``Wg, W1, b1, W2, b2``
stacked on the expert axis, the pretrain layers' ``W [n_in, n_out]``,
``b`` and visible bias ``vb`` (RBM, AutoEncoder) and the VAE's
``eW*/eb*, mW/mb, lW/lb, dW*/db*, rW/rb`` in its ``param_order``), so no
transpose or reorder is needed. A
graph's tree is keyed by vertex name and holds an empty dict for each
parameterless vertex, on both sides. ``state_from_jax`` loads the layer
state the same way (batch norm's running ``mean``/``var``, the center-loss
centers) and ``updater_state_from_jax`` the optimizer slots (``{slot:
{vertex: {name: ndarray}}}``, Adam's ``m`` and ``v``), so a run can
continue from a JAX-trained state. ``sequence_vectors_state`` and
``sequence_vectors_from_jax`` carry an embedding trainer's vocab, Huffman
tree and tables across the same way. A quantized
reference tree (``quantize_params``/``quantize_net``: int8 codes with
``"<name>_scale"`` f32 siblings) loads as it is, codes int8 and scales f32,
whether the port net is quantized already or not. Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.optimize.quantize import SCALE_SUFFIX


def _load_tree(tree: dict, ours: dict) -> dict:
    """``tree`` as tensors on the devices and dtypes of ``ours``, after
    checking its vertices, names and shapes against ``ours``. A weight that
    carries a ``"<name>_scale"`` sibling in ``tree`` but not in ``ours``
    loads as int8 codes (which it must be) beside its f32 scale of one
    entry per output channel."""
    if set(tree) != set(ours):
        raise ValueError(f"vertex sets differ: only in the reference "
                         f"{sorted(set(tree) - set(ours))}, only in the "
                         f"port {sorted(set(ours) - set(tree))}")
    loaded = {}
    for vname, p in tree.items():
        mine = ours[vname]
        scales = {k for k in p if k.endswith(SCALE_SUFFIX) and k not in mine
                  and k[:-len(SCALE_SUFFIX)] in mine}
        if set(p) - scales != set(mine):
            raise ValueError(f"vertex '{vname}': parameters "
                             f"{sorted(p)} != {sorted(mine)}")
        loaded[vname] = {}
        for pname, a in p.items():
            a = np.asarray(a)
            if pname in scales:          # a dequant scale: f32 [out]
                ref = mine[pname[:-len(SCALE_SUFFIX)]]
                shape, dtype = tuple(ref.shape[-1:]), torch.float32
            elif pname + SCALE_SUFFIX in scales:     # its int8 codes
                ref = mine[pname]
                shape, dtype = tuple(ref.shape), torch.int8
                if a.dtype != np.int8:
                    raise ValueError(f"{vname}.{pname}: a scaled weight "
                                     f"must be int8 codes, got {a.dtype}")
            else:
                ref = mine[pname]
                shape, dtype = tuple(ref.shape), ref.dtype
            if tuple(a.shape) != shape:
                raise ValueError(f"{vname}.{pname}: shape {a.shape} != "
                                 f"{shape}")
            loaded[vname][pname] = torch.from_numpy(np.array(a)).to(
                device=ref.device, dtype=dtype)
    return loaded


def _to_numpy(tree: dict) -> dict:
    return {v: {k: t.detach().cpu().numpy() for k, t in p.items()}
            for v, p in tree.items()}


def params_from_jax(params: dict, net):
    """Check every vertex and parameter against ``net``'s own and replace
    ``net.params`` with ``params`` on the net's device. Returns ``net``."""
    net.params = _load_tree(params, net.params)
    return net


def params_to_numpy(net) -> dict:
    """The port's parameters as ``{vertex: {name: ndarray}}`` (the inverse
    of ``params_from_jax``)."""
    return _to_numpy(net.params)


def state_from_jax(state: dict, net):
    """Check the reference's layer state (``jax.device_get(net.state)``)
    against ``net.state`` and replace it, on the net's device; the carry
    entries the port keeps out of the layer state (``nn/network.py::
    CARRY_KEYS``) are dropped. Returns ``net``."""
    from deeplearning4j_torch.nn.network import CARRY_KEYS

    tree = {v: {k: a for k, a in p.items() if k not in CARRY_KEYS}
            for v, p in state.items()}
    net.state = _load_tree(tree, net.state)
    return net


def updater_state_from_jax(state: dict, net, iteration=None):
    """Check the reference's updater state against the slots and shapes of
    ``net.updater_state`` and replace it, on the net's device. With
    ``iteration``, also set ``net.iteration`` (Adam's step count), so
    training continues where the reference stopped. Returns ``net``."""
    ours = net.updater_state
    if set(state) != set(ours):
        raise ValueError(f"updater slots differ: reference {sorted(state)}, "
                         f"port {sorted(ours)}")
    loaded = {}
    for slot, tree in state.items():
        try:
            loaded[slot] = _load_tree(tree, ours[slot])
        except ValueError as e:
            raise ValueError(f"updater slot '{slot}': {e}") from None
    net.updater_state = loaded
    if iteration is not None:
        net.iteration = int(iteration)
    return net


def updater_state_to_numpy(net) -> dict:
    """The port's updater state as ``{slot: {vertex: {name: ndarray}}}``
    (the inverse of ``updater_state_from_jax``)."""
    return {slot: _to_numpy(tree) for slot, tree in net.updater_state.items()}


def sequence_vectors_state(sv) -> dict:
    """The trainable state of an embedding trainer as host data: the vocab
    in index order as ``(word, count, codes, points)``, ``syn0``/``syn1``/
    ``syn1neg`` as numpy, the batch builder's numpy stream state and, for
    paragraph vectors, the label rows. Reads any object with the
    ``SequenceVectors`` surface (the JAX package's or the port's) by
    duck typing; arrays are fetched with ``np.asarray`` (a tensor through
    its host copy)."""
    def arr(a):
        if torch.is_tensor(a):
            a = a.detach().cpu()
        return np.array(a, np.float32)

    words = []
    for i in range(sv.vocab.num_words()):
        w = sv.vocab.element_at_index(i)
        words.append((w.word, float(w.count), list(w.codes), list(w.points)))
    state = {"words": words, "syn0": arr(sv.syn0), "syn1": arr(sv.syn1),
             "syn1neg": arr(sv.syn1neg)}
    if getattr(sv, "_builder", None) is not None:
        state["builder_rng"] = sv._builder.rng.get_state()
    if getattr(sv, "_label_ids", None):
        state["label_ids"] = dict(sv._label_ids)
    return state


def sequence_vectors_from_jax(state: dict, sv):
    """Load ``state`` (``sequence_vectors_state`` of a JAX
    ``SequenceVectors``, ``Word2Vec``, ``ParagraphVectors`` or DeepWalk's
    trainer) into the port's ``sv``: the same vocab (words, counts,
    indices, Huffman codes and points), the three tables on ``sv``'s
    device, and a batch builder in the same numpy stream state, so one
    epoch trains from the same state in both packages. Returns ``sv``."""
    from deeplearning4j_torch.nlp.learning import BatchBuilder
    from deeplearning4j_torch.nlp.vocab import AbstractCache, VocabWord

    cache = AbstractCache()
    for i, (word, count, codes, points) in enumerate(state["words"]):
        cache.add_token(VocabWord(word, count, i, list(codes), list(points)))
    cache.update_indices()
    if [cache.word_at_index(i) for i in range(cache.num_words())] != \
            [w[0] for w in state["words"]]:
        raise ValueError("the vocab's counts do not give its index order")
    sv.vocab = cache
    dev = sv._dev()
    V, D = state["syn0"].shape
    if D != sv.layer_size:
        raise ValueError(f"layer size {D} != the trainer's {sv.layer_size}")
    for name in ("syn0", "syn1", "syn1neg"):
        setattr(sv, name, torch.from_numpy(np.array(state[name],
                                                    np.float32)).to(dev))
    sv._builder = BatchBuilder(cache, window=sv.window, negative=sv.negative,
                               use_hs=sv.use_hs, sampling=sv.sampling,
                               seed=sv.seed)
    if "builder_rng" in state:
        sv._builder.rng.set_state(state["builder_rng"])
    if "label_ids" in state and hasattr(sv, "_label_ids"):
        sv._label_ids = dict(state["label_ids"])
    return sv
