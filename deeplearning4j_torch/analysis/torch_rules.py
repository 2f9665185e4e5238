"""Torch hazard rules for graftcheck (the port's counterpart of
``deeplearning4j_tpu/analysis/jax_rules.py``).

Rules emitted by :func:`check_module`:

- ``torch-host-sync-in-hot-loop`` — the forms of JAX's
  ``jax-host-sync-in-hot-loop`` (``.item()``, ``float()``/``int()``/
  ``bool()`` of a non-literal, ``np.asarray``/``np.array`` of a
  non-literal) and torch's own device→host syncs (``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``) inside the
  decode/coalescer/fit hot loops named in :data:`HOT_FUNCTIONS`. Each
  stalls the host until the card has drained its queue, which serializes
  the dispatch pipeline. The AST cannot tell a device tensor from a host
  array, so a conversion of an array already on the host flags as well:
  such a spot is baselined with the one fetch it converts named.
- ``torch-global-randomness`` — a draw that bypasses the sanctioned
  paths: ``torch.rand*``/``randn*``/``randint``/``randperm``/
  ``multinomial``/``bernoulli``/``normal`` and the in-place samplers
  (``uniform_``, ``normal_``, ``bernoulli_``, ``random_``, ...) without
  ``generator=``, draws from the global state of ``np.random`` or of the
  stdlib ``random``, and their generators built without a seed. A seeded
  ``torch.Generator``, ``np.random.default_rng(seed)``,
  ``np.random.RandomState(seed)``, ``random.Random(seed)`` and the keyed
  ``deeplearning4j_torch.ops.random`` (JAX's ``jax.random`` bit for bit)
  are explicit. Names resolve through the module's imports, so
  ``from deeplearning4j_torch.ops import random`` is not the stdlib.

JAX's ``jax-retrace-hazard``, ``jax-varying-capture`` and
``jax-donation-misuse`` have no counterparts: they are hazards of a traced
program, and the port traces nothing (no ``torch.compile``, ``torch.jit``
or CUDA graph; ``tests/test_torch_analysis.py`` holds that). The change
that brings capture (ROADMAP A4) adds the counterpart rule with it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from deeplearning4j_torch.analysis.core import Finding

# functions that ARE the serving/training hot loops; one host sync here
# stalls every slot/request in the batch. JAX's set under the port's
# names: JAX's ``_mesh_decode_once``, ``_reshard_snapshot`` and
# ``_sharded_write_attend`` are folded into ``_decode_once``,
# ``_adopt_into_slot`` and ``_paged_forward`` here, and JAX's stale
# ``_coalesce_loop``/``_monitor_loop`` are the live ``_coalesce_once``/
# ``_monitor_tick`` in both packages.
HOT_FUNCTIONS = {
    "_decode_once", "_prefill_wave",              # generation slot loop
    "_spec_decode_once",                          # speculative verify loop
    "_coalesce_once", "_complete_loop",           # inference coalescer
    "_dispatch_batch", "_dispatch_fwd",           # inference dispatch
    "_run_block", "fit_stream",                   # fused-fit driver loop
    "_route_once", "_replica_done",               # fleet router hot path
    "_monitor_tick",                              # fleet redispatch/hedge
    "_service_parked",                            # fleet resume path
    "_snapshot_slot", "_adopt_into_slot",         # KV handoff export/adopt
    "_tier_route",                                # disagg tier routing
    "_transfer_loop",                             # prefill->decode export
    "_autoscale_tick",                            # autoscaler control loop
    "_soak_arrival_loop",                         # load-generator pacing
    "_snapshot_families",                         # /metrics scrape path
    "_proj",                                      # fused-dequant projection
    "_quantize_kv",                               # int8 KV write quantizer
    "_knn_coalesce_once",                         # knn query coalescer
    "_knn_dispatch_batch", "_dispatch_knn",       # knn search dispatch
    "_knn_complete_loop",                         # knn completer fetch
    "_paged_forward",                             # paged-KV decode read+write
    "paged_attend",                               # helper-seam dispatch
    "resolve_paged_backend",                      # helper-seam selection
    "_fresh_pool",                                # mesh pool placement
    "_gossip_loop",                               # federation router tick
    "_route_host",                                # federation dispatch path
    "_harvest_host",                              # federation crash harvest
    "_rag_retrieve_done",                         # rag knn-tier completion
    "_rag_assemble_dispatch",                     # rag tier-boundary route
    "_rag_generate_done",                         # rag generate completion
    "_probe_local_rank",                          # per-device IVF probe body
}

SYNC_BUILTINS = {"float", "bool", "int"}
#: numpy's host copies; the bare ``np.`` forms also match where ``np`` is
#: not bound by an import (as JAX's rule matches them)
SYNC_NUMPY = {"numpy.asarray", "numpy.array", "np.asarray", "np.array"}
#: tensor methods that copy device memory to the host (``.cpu()``,
#: ``.tolist()``, ``.numpy()``)
SYNC_METHODS = {"cpu", "tolist", "numpy"}

#: torch functions that draw from the global generator unless handed one
TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
               "randint_like", "randperm", "multinomial", "bernoulli",
               "normal", "poisson"}
#: in-place tensor samplers (``t.uniform_()``, ``nn.init.normal_(t)``)
INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: generator constructors: explicit when given a seed
SEEDED_CTORS = {"numpy.random.default_rng", "numpy.random.RandomState",
                "random.Random"}
#: numpy.random names that build or type a generator and draw nothing
NUMPY_GENERATOR_TYPES = {"Generator", "BitGenerator", "SeedSequence",
                         "PCG64", "PCG64DXSM", "MT19937", "Philox",
                         "SFC64"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'np.random.normal' for Attribute chains, 'float' for Names."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> the dotted module path (or module.name) it is bound to
    by the module's imports, at any depth (the last in the source wins)."""
    aliases: Dict[str, str] = {}
    imports = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in sorted(imports, key=lambda n: (n.lineno, n.col_offset)):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{mod}.{a.name}"
    return aliases


def _resolve(dn: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    if head not in aliases:
        return dn
    full = aliases[head]
    return f"{full}.{rest}" if rest else full


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _randomness(call: ast.Call, dn: Optional[str],
                full: Optional[str]) -> Optional[str]:
    """The draw's label if ``call`` takes randomness from a global
    (unseeded) state, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in INPLACE_DRAWS \
            and not _has_generator(call):
        return dn or f".{f.attr}()"
    if full is None:
        return None
    if full in SEEDED_CTORS:
        return None if (call.args or call.keywords) else dn
    mod, _, name = full.rpartition(".")
    if mod == "torch" and name in TORCH_DRAWS:
        return None if _has_generator(call) else dn
    if mod == "numpy.random":
        return None if name in NUMPY_GENERATOR_TYPES else dn
    if mod == "random" and name != "Random":
        return dn
    return None


class _ModuleScan(ast.NodeVisitor):
    """Walks scopes (classes and functions) so every finding names the
    scope it sits in, as JAX's scanner does."""

    def __init__(self, relpath: str, aliases: Dict[str, str]):
        self.relpath = relpath
        self.aliases = aliases
        self.findings: List[Finding] = []
        self.stack: List[str] = []      # enclosing class/function names
        self.funcs: List[str] = []      # enclosing function names

    def _scope_name(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.funcs.append(node.name)
        if node.name in HOT_FUNCTIONS:
            self._check_hot_loop(node)
        self.generic_visit(node)
        self.funcs.pop()
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # ---- rule: global randomness ---------------------------------------
    def visit_Call(self, node):
        dn = _dotted(node.func)
        label = _randomness(node, dn, _resolve(dn, self.aliases))
        if label is not None:
            where = self.funcs[-1] if self.funcs else "<module>"
            self.findings.append(Finding(
                rule="torch-global-randomness", path=self.relpath,
                line=node.lineno, col=node.col_offset,
                scope=self._scope_name(), detail=f"{where}:{label}",
                message=(f"`{label}` draws from a global random state — "
                         "results depend on whatever drew before; pass a "
                         "seeded generator= or use the keyed "
                         "deeplearning4j_torch.ops.random"),
            ))
        self.generic_visit(node)

    # ---- rule: host sync inside hot loops ------------------------------
    def _sync_kind(self, node: ast.Call) -> Optional[str]:
        f = node.func
        dn = _dotted(f)
        if _resolve(dn, self.aliases) == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(f, ast.Attribute) and not node.args:
            if f.attr == "item":
                return ".item()"
            if f.attr in SYNC_METHODS:
                return f".{f.attr}()"
        if dn in SYNC_BUILTINS and len(node.args) == 1 \
                and not isinstance(node.args[0], ast.Constant):
            return f"{dn}()"
        if _resolve(dn, self.aliases) in SYNC_NUMPY and node.args \
                and not isinstance(node.args[0], ast.Constant):
            return dn
        return None

    def _check_hot_loop(self, fn):
        scope = self._scope_name()  # fn already pushed on the stack
        seq: Dict[str, int] = {}   # occurrence index per call shape —
        # keeps the finding key stable while surrounding lines move
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = self._sync_kind(node)
            if hit:
                seq[hit] = seq.get(hit, 0) + 1
                self.findings.append(Finding(
                    rule="torch-host-sync-in-hot-loop", path=self.relpath,
                    line=node.lineno, col=node.col_offset, scope=scope,
                    detail=f"{fn.name}:{hit}:{seq[hit]}",
                    message=(f"`{hit}` in hot loop `{fn.name}` forces a "
                             "device→host sync per iteration — batch the "
                             "fetch or keep the value on device"),
                ))


def check_module(tree: ast.Module, relpath: str) -> List[Finding]:
    scan = _ModuleScan(relpath, _import_aliases(tree))
    scan.visit(tree)
    return scan.findings
