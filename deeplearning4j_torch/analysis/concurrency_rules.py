"""Concurrency rules for graftcheck (the port's own copy of
``deeplearning4j_tpu/analysis/concurrency_rules.py``: the same rules,
details and messages, with torch's waits on the device added to the
blocking calls).

Rules emitted by :func:`check_module`:

- ``conc-mixed-lock`` — per-class lock-ownership inference. For every
  non-lock attribute of a class that constructs ``threading.Lock``/
  ``RLock``/``Condition`` members, accesses outside ``__init__`` are
  classified as locked/unlocked reads/writes. An attribute that is ever
  written AND is accessed both under and outside a lock is a finding:
  either the unlocked side races or the locked side is cargo cult.
  Private methods (``_name``) inherit the intersection of the lock sets
  held at their intra-class call sites, so ``_trip()`` called only with
  ``self._lock`` held does not false-positive.
- ``conc-lock-blocking-call`` — a blocking call (``Future.result``,
  ``queue.get``/``put``, ``.join``, ``Condition.wait`` on a *different*
  condition than the one held, ``block_until_ready`` and torch's
  ``.synchronize()`` (``torch.cuda.synchronize()``, an event's or a
  stream's), ``sleep``,
  socket/HTTP I/O, retry loops) made while holding a lock. Everything
  else queued behind that lock stalls for the full wait.
- ``monotonic-deadline`` — ``time.time()`` used in arithmetic or
  comparisons (directly or via a local assigned from it). Wall clock
  jumps under NTP step/VM migration; durations and deadlines must use
  ``time.monotonic()``. Storing a wall timestamp (no arithmetic) is
  fine and not flagged.
- ``conc-loop-ownership`` — classes may declare
  ``_LOOP_OWNED = ("attr", ...)`` + ``_LOOP_LOCK = "lockname"`` at class
  level: state owned by the class's loop thread (the method handed to
  ``threading.Thread``/``ServingLoop`` as ``target=``/``tick=``/
  ``handler=``), read lock-free on that thread between rounds. Declared
  attributes are EXEMPT from ``conc-mixed-lock`` (the lock-free loop
  reads are the design), and in exchange every WRITE from a method
  reachable off the loop thread must hold the declared lock — a bare
  off-loop write is a finding, checked instead of baselined.

:func:`check_lock_graph` builds the cross-module lock-acquisition graph
(nodes = ``(Class, lock_attr)``; edges = "acquired while holding", via
nested ``with``, intra-class calls, and cross-object calls resolved
through ``self.x = ClassName(...)`` attribute types) and emits
``conc-lock-cycle`` for every cycle, naming the acquisition site of
every edge so a deadlock report is actionable.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from deeplearning4j_torch.analysis.core import Finding

LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
              "Lock", "RLock", "Condition"}

# receivers whose .get/.put we treat as queue ops even without a
# timeout/block kwarg
_QUEUEISH = ("q", "queue")

# method calls that mutate their receiver: self.xs.append(...) is a
# WRITE to xs for lock-ownership purposes
_MUTATORS = {"append", "appendleft", "pop", "popleft", "add", "remove",
             "discard", "clear", "update", "extend", "insert",
             "setdefault", "popitem"}

# ``block_until_ready`` is JAX's wait on the device; ``synchronize`` is
# torch's (``torch.cuda.synchronize()``, ``Event.synchronize()``,
# ``Stream.synchronize()``)
BLOCKING_ATTR_CALLS = {"result", "block_until_ready", "synchronize", "recv",
                       "accept", "sendall", "connect", "urlopen",
                       "getresponse"}


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class _Access:
    attr: str
    write: bool
    held: FrozenSet[str]   # locally-held lock attrs at the access
    line: int


@dataclass
class _Acquire:
    lock: str
    held: FrozenSet[str]
    line: int


@dataclass
class _Call:
    node: ast.Call
    held: FrozenSet[str]
    line: int
    self_method: Optional[str]          # self.m(...)
    obj_attr: Optional[str] = None      # self.x.m(...) -> "x"
    obj_method: Optional[str] = None    # self.x.m(...) -> "m"


@dataclass
class _Method:
    name: str
    node: ast.AST
    accesses: List[_Access] = field(default_factory=list)
    acquires: List[_Acquire] = field(default_factory=list)
    calls: List[_Call] = field(default_factory=list)
    entry_held: FrozenSet[str] = frozenset()


@dataclass
class _Class:
    name: str
    path: str
    line: int
    locks: Set[str] = field(default_factory=set)
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, _Method] = field(default_factory=dict)
    loop_owned: Tuple[str, ...] = ()      # declared _LOOP_OWNED attrs
    loop_lock: Optional[str] = None       # declared _LOOP_LOCK name


# --------------------------------------------------------------------------
# per-class extraction
# --------------------------------------------------------------------------

def _scan_class(cls_node: ast.ClassDef, path: str) -> _Class:
    info = _Class(name=cls_node.name, path=path, line=cls_node.lineno)

    # pass 0: loop-ownership declarations (class-level literal assigns)
    for stmt in cls_node.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        tname = stmt.targets[0].id
        if tname == "_LOOP_OWNED" \
                and isinstance(stmt.value, (ast.Tuple, ast.List)):
            info.loop_owned = tuple(
                e.value for e in stmt.value.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str))
        elif tname == "_LOOP_LOCK" \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str):
            info.loop_lock = stmt.value.value

    # pass 1: lock members + attribute types from __init__
    for stmt in cls_node.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
            for node in ast.walk(stmt):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if isinstance(node.value, ast.Call):
                    ctor = _dotted(node.value.func)
                    if ctor in LOCK_CTORS:
                        info.locks.add(tgt.attr)
                    elif ctor and ctor[:1].isupper():
                        # self.x = ClassName(...) — remember the type for
                        # cross-object lock-graph edges
                        info.attr_types[tgt.attr] = ctor.split(".")[-1]

    # pass 2: walk every method
    for stmt in cls_node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _Method(name=stmt.name, node=stmt)
            _walk_method(stmt, info, m)
            info.methods[stmt.name] = m
    return info


def _walk_method(fn, cls: _Class, out: _Method) -> None:
    """Walk a method body tracking the set of locally-held lock attrs.
    Nested defs (retry closures) are walked with the held set at their
    definition site — they run in place on this stack in practice."""

    def lock_of(expr) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and expr.attr in cls.locks:
            return expr.attr
        return None

    def visit(node, held: FrozenSet[str]):
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                lk = lock_of(item.context_expr)
                if lk is not None:
                    out.acquires.append(
                        _Acquire(lock=lk, held=inner, line=node.lineno))
                    inner = inner | {lk}
                else:
                    visit(item.context_expr, held)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and node.attr not in cls.locks:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                out.accesses.append(_Access(node.attr, True, held,
                                            node.lineno))
            elif isinstance(node.ctx, ast.Load):
                out.accesses.append(_Access(node.attr, False, held,
                                            node.lineno))
            # no return: fall through to children (e.g. subscripts)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)) \
                and isinstance(node.value, ast.Attribute) \
                and isinstance(node.value.value, ast.Name) \
                and node.value.value.id == "self" \
                and node.value.attr not in cls.locks:
            # self.xs[k] = ... / del self.xs[k] mutate the container
            out.accesses.append(_Access(node.value.attr, True, held,
                                        node.lineno))
        if isinstance(node, ast.AugAssign):
            tgt = node.target
            if isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self" \
                    and tgt.attr not in cls.locks:
                # += is a read-modify-write
                out.accesses.append(_Access(tgt.attr, True, held,
                                            node.lineno))
                out.accesses.append(_Access(tgt.attr, False, held,
                                            node.lineno))
            visit(node.value, held)
            return
        if isinstance(node, ast.Call):
            self_method = None
            obj_attr = obj_method = None
            f = node.func
            if isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Name) and f.value.id == "self":
                    self_method = f.attr
                elif isinstance(f.value, ast.Attribute) \
                        and isinstance(f.value.value, ast.Name) \
                        and f.value.value.id == "self":
                    obj_attr, obj_method = f.value.attr, f.attr
                    if f.attr in _MUTATORS \
                            and obj_attr not in cls.locks:
                        # self.xs.append(...) mutates xs
                        out.accesses.append(_Access(obj_attr, True, held,
                                                    node.lineno))
            out.calls.append(_Call(node=node, held=held, line=node.lineno,
                                   self_method=self_method,
                                   obj_attr=obj_attr,
                                   obj_method=obj_method))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, frozenset())


def _propagate_entry_locks(cls: _Class, rounds: int = 3) -> None:
    """Private methods inherit the intersection of lock sets held at
    their intra-class call sites (public methods assume unlocked
    external callers). Fixed point over a few rounds handles private →
    private chains."""
    for _ in range(rounds):
        changed = False
        sites: Dict[str, List[FrozenSet[str]]] = {}
        for m in cls.methods.values():
            for c in m.calls:
                if c.self_method and c.self_method in cls.methods:
                    sites.setdefault(c.self_method, []).append(
                        c.held | m.entry_held)
        for name, m in cls.methods.items():
            if not name.startswith("_") or name.startswith("__"):
                continue  # public / dunder: callable from anywhere
            if name not in sites:
                continue
            entry = frozenset.intersection(*map(frozenset, sites[name]))
            if entry != m.entry_held:
                m.entry_held = entry
                changed = True
        if not changed:
            break


# --------------------------------------------------------------------------
# rule: conc-mixed-lock
# --------------------------------------------------------------------------

def _check_mixed_lock(cls: _Class) -> List[Finding]:
    findings: List[Finding] = []
    # attr -> [locked_any, unlocked_any, write_any, first unlocked line,
    #          lock names seen]
    stats: Dict[str, list] = {}
    for m in cls.methods.values():
        if m.name in ("__init__", "__del__"):
            continue  # construction/teardown are single-threaded
        for a in m.accesses:
            if a.attr in cls.loop_owned:
                continue  # covered by conc-loop-ownership instead
            held = a.held | m.entry_held
            st = stats.setdefault(a.attr, [False, False, False, None, set()])
            if held:
                st[0] = True
                st[4] |= set(held)
            else:
                st[1] = True
                if st[3] is None:
                    st[3] = a.line
            if a.write:
                st[2] = True
    for attr in sorted(stats):
        locked_any, unlocked_any, write_any, line, locks = stats[attr]
        if locked_any and unlocked_any and write_any:
            lk = "/".join(sorted("self." + l for l in locks))
            findings.append(Finding(
                rule="conc-mixed-lock", path=cls.path, line=line or cls.line,
                col=0, scope=cls.name, detail=attr,
                message=(f"attribute `{attr}` is accessed both under "
                         f"{lk} and with no lock held — the unlocked "
                         "side races with the locked writers"),
            ))
    return findings


# --------------------------------------------------------------------------
# rule: conc-loop-ownership
# --------------------------------------------------------------------------

def _loop_roots(cls: _Class) -> Set[str]:
    """Methods handed to a thread/loop constructor as its entrypoint:
    ``threading.Thread(target=self._m)``, ``ServingLoop(tick=self._m)``,
    ``ServingLoop(handler=self._m)``. (``wake=`` is excluded: wake hooks
    run on whichever thread advances the state machine.)"""
    roots: Set[str] = set()
    for m in cls.methods.values():
        for c in m.calls:
            fn = _dotted(c.node.func) or ""
            if fn.split(".")[-1] not in ("Thread", "ServingLoop"):
                continue
            for kw in c.node.keywords:
                if kw.arg in ("target", "tick", "handler") \
                        and isinstance(kw.value, ast.Attribute) \
                        and isinstance(kw.value.value, ast.Name) \
                        and kw.value.value.id == "self":
                    roots.add(kw.value.attr)
    return roots


def _reach(cls: _Class, seeds: Set[str]) -> Set[str]:
    """Transitive closure of intra-class ``self.m()`` calls."""
    seen = {s for s in seeds if s in cls.methods}
    frontier = list(seen)
    while frontier:
        name = frontier.pop()
        for c in cls.methods[name].calls:
            if c.self_method and c.self_method in cls.methods \
                    and c.self_method not in seen:
                seen.add(c.self_method)
                frontier.append(c.self_method)
    return seen


def _check_loop_ownership(cls: _Class) -> List[Finding]:
    """Writes to declared loop-owned attrs are legal (a) on the loop
    thread itself — methods reachable ONLY from the loop entrypoints —
    or (b) anywhere else under the declared loop lock. Anything else is
    exactly the race the mixed-lock exemption would otherwise hide."""
    if not cls.loop_owned or cls.loop_lock is None:
        return []
    public = {n for n in cls.methods if not n.startswith("_")}
    exclusive = _reach(cls, _loop_roots(cls)) - _reach(cls, public)
    findings: List[Finding] = []
    seen: Set[str] = set()
    for m in cls.methods.values():
        if m.name in ("__init__", "__del__") or m.name in exclusive:
            continue
        for a in m.accesses:
            if not a.write or a.attr not in cls.loop_owned:
                continue
            if cls.loop_lock in (a.held | m.entry_held):
                continue
            detail = f"{m.name}:{a.attr}"
            if detail in seen:
                continue
            seen.add(detail)
            findings.append(Finding(
                rule="conc-loop-ownership", path=cls.path, line=a.line,
                col=0, scope=f"{cls.name}.{m.name}", detail=detail,
                message=(f"loop-owned attribute `{a.attr}` written off "
                         f"the owning loop thread without `self."
                         f"{cls.loop_lock}` — the loop reads it "
                         "lock-free between rounds, so this write races"),
            ))
    return findings


# --------------------------------------------------------------------------
# rule: conc-lock-blocking-call
# --------------------------------------------------------------------------

def _blocking_kind(call: ast.Call, held: FrozenSet[str]) -> Optional[str]:
    f = call.func
    if not isinstance(f, ast.Attribute):
        fn = _dotted(f)
        if fn == "sleep":
            return "sleep()"
        return None
    name = f.attr
    recv = _dotted(f.value) or ""
    kwargs = {kw.arg for kw in call.keywords if kw.arg}

    if name in BLOCKING_ATTR_CALLS:
        return f".{name}()"
    if name == "sleep" or _dotted(f) in ("time.sleep",):
        return "time.sleep()"
    if name == "wait":
        # waiting on the condition you hold releases it — that's the
        # point of a Condition. Waiting on anything ELSE while holding
        # a lock is a stall.
        recv_attr = recv.split(".")[-1]
        if recv_attr in held:
            return None
        return f".wait() on `{recv}`"
    if name == "join":
        # thread.join() / thread.join(timeout) block; "sep".join(parts)
        # does not
        if not call.args and not kwargs:
            return ".join()"
        if "timeout" in kwargs:
            return ".join(timeout=...)"
        if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float)):
            return ".join(t)"
        return None
    if name in ("get", "put"):
        last = recv.split(".")[-1].lower()
        queueish = last.endswith(_QUEUEISH[0]) or _QUEUEISH[1] in last
        if queueish or "timeout" in kwargs or "block" in kwargs:
            return f".{name}() on queue `{recv}`"
        return None
    if name == "call" and "retry" in recv.split(".")[-1].lower():
        return f"`{recv}.call()` (sleeps between retries)"
    return None


def _check_blocking(cls: _Class) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[str] = set()
    for m in cls.methods.values():
        if m.name == "__init__":
            continue
        for c in m.calls:
            held = c.held | m.entry_held
            if not held:
                continue
            kind = _blocking_kind(c.node, held)
            if kind is None:
                continue
            lk = "/".join(sorted("self." + l for l in held))
            detail = f"{m.name}:{kind}"
            if detail in seen:
                continue  # one finding per (method, call shape)
            seen.add(detail)
            findings.append(Finding(
                rule="conc-lock-blocking-call", path=cls.path, line=c.line,
                col=c.node.col_offset, scope=f"{cls.name}.{m.name}",
                detail=detail,
                message=(f"blocking call {kind} while holding {lk} — "
                         "every thread queued on that lock stalls for "
                         "the full wait"),
            ))
    return findings


# --------------------------------------------------------------------------
# rule: monotonic-deadline
# --------------------------------------------------------------------------

def _contains_wall_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _dotted(sub.func) == "time.time":
            return True
    return False


def _check_monotonic(tree: ast.Module, relpath: str) -> List[Finding]:
    findings: List[Finding] = []

    def scan_fn(fn, scope: str):
        wall_names: Set[str] = set()
        ordered: List[ast.AST] = sorted(
            (n for n in ast.walk(fn) if hasattr(n, "lineno")),
            key=lambda n: (n.lineno, getattr(n, "col_offset", 0)))
        # first: names assigned from time.time() anywhere in fn
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _contains_wall_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        wall_names.add(t.id)
        seen: Set[str] = set()
        for node in ordered:
            if not isinstance(node, (ast.BinOp, ast.Compare)):
                continue
            hit = None
            if _contains_wall_call(node):
                hit = "time.time()"
            else:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) \
                            and isinstance(sub.ctx, ast.Load) \
                            and sub.id in wall_names:
                        hit = sub.id
                        break
            if hit is None:
                continue
            detail = f"{getattr(fn, 'name', '<module>')}:{hit}"
            if detail in seen:
                continue
            seen.add(detail)
            findings.append(Finding(
                rule="monotonic-deadline", path=relpath, line=node.lineno,
                col=node.col_offset, scope=scope, detail=detail,
                message=(f"duration/deadline arithmetic on wall clock "
                         f"(`{hit}`) — wall time jumps under NTP; use "
                         "time.monotonic() for durations"),
            ))

    # top-level functions and methods (scan_fn covers their nested defs)
    class Top(ast.NodeVisitor):
        def __init__(self):
            self.stack: List[str] = []

        def visit_ClassDef(self, node):
            self.stack.append(node.name)
            for stmt in node.body:
                self.visit(stmt)
            self.stack.pop()

        def visit_FunctionDef(self, node):
            scan_fn(node, ".".join(self.stack + [node.name]))

        visit_AsyncFunctionDef = visit_FunctionDef

    Top().visit(tree)
    return findings


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def _classes_of(tree: ast.Module, relpath: str) -> List[_Class]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cls = _scan_class(node, relpath)
            if cls.locks:
                _propagate_entry_locks(cls)
                out.append(cls)
    return out


def check_module(tree: ast.Module, relpath: str) -> List[Finding]:
    findings: List[Finding] = []
    for cls in _classes_of(tree, relpath):
        findings.extend(_check_mixed_lock(cls))
        findings.extend(_check_loop_ownership(cls))
        findings.extend(_check_blocking(cls))
    findings.extend(_check_monotonic(tree, relpath))
    return findings


def check_lock_graph(modules: List[Tuple[str, ast.Module]]) -> List[Finding]:
    """Cross-module pass: build the lock-acquisition graph and report
    every cycle with the acquisition site of each edge."""
    classes: Dict[str, _Class] = {}
    for relpath, tree in modules:
        for cls in _classes_of(tree, relpath):
            classes.setdefault(cls.name, cls)

    # method -> set of (lock, line) it acquires, incl. via self-calls
    acq: Dict[Tuple[str, str], Set[Tuple[str, int]]] = {}
    for cname, cls in classes.items():
        for mname, m in cls.methods.items():
            acq[(cname, mname)] = {(a.lock, a.line) for a in m.acquires}
    for _ in range(2):  # transitive through intra-class calls
        for cname, cls in classes.items():
            for mname, m in cls.methods.items():
                for c in m.calls:
                    if c.self_method and (cname, c.self_method) in acq:
                        acq[(cname, mname)] |= acq[(cname, c.self_method)]

    # edges: (src_node, dst_node) -> (path, line) acquisition site of dst
    edges: Dict[Tuple[Tuple[str, str], Tuple[str, str]],
                Tuple[str, int]] = {}

    def add_edge(src, dst, path, line):
        edges.setdefault((src, dst), (path, line))

    for cname, cls in classes.items():
        for m in cls.methods.values():
            for a in m.acquires:
                for h in (a.held | m.entry_held):
                    if h != a.lock:
                        add_edge((cname, h), (cname, a.lock),
                                 cls.path, a.line)
            for c in m.calls:
                held = c.held | m.entry_held
                if not held:
                    continue
                # cross-object: self.x.m() where x's class holds locks
                if c.obj_attr and c.obj_attr in cls.attr_types:
                    dname = cls.attr_types[c.obj_attr]
                    dcls = classes.get(dname)
                    if dcls is None:
                        continue
                    for (lk, line) in acq.get((dname, c.obj_method), ()):
                        for h in held:
                            add_edge((cname, h), (dname, lk),
                                     dcls.path, line)

    # cycle detection (DFS with colors); report each cycle once
    findings: List[Finding] = []
    graph: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for (src, dst) in edges:
        graph.setdefault(src, []).append(dst)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[Tuple[str, str], int] = {}
    stack: List[Tuple[str, str]] = []
    reported: Set[Tuple[Tuple[str, str], ...]] = set()

    def canon(cycle):
        i = cycle.index(min(cycle))
        return tuple(cycle[i:] + cycle[:i])

    def dfs(u):
        color[u] = GRAY
        stack.append(u)
        for v in graph.get(u, ()):
            if color.get(v, WHITE) == WHITE:
                dfs(v)
            elif color.get(v) == GRAY:
                cyc = canon(stack[stack.index(v):])
                if cyc in reported:
                    continue
                reported.add(cyc)
                parts = []
                ring = list(cyc) + [cyc[0]]
                for a, b in zip(ring, ring[1:]):
                    path, line = edges[(a, b)]
                    parts.append(f"{a[0]}.{a[1]} -> {b[0]}.{b[1]} "
                                 f"(acquired at {path}:{line})")
                first_path, first_line = edges[(ring[0], ring[1])]
                findings.append(Finding(
                    rule="conc-lock-cycle", path=first_path,
                    line=first_line, col=0, scope="<lock-graph>",
                    detail="->".join(f"{c}.{l}" for c, l in cyc),
                    message=("lock-order cycle: " + "; ".join(parts)
                             + " — two threads taking these in opposite "
                               "order deadlock"),
                ))
        stack.pop()
        color[u] = BLACK

    for node in list(graph):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    return findings
