"""Thread-boundary map of the serve plane (docs/ANALYSIS.md
"Concurrency analysis").

The serve plane is a genuinely concurrent system: a dispatch thread, N
per-device lane workers, M confirm workers, a watchdog monitor, an
oversized-body side worker, the rollout shadow/admission threads, the
postanalytics exporter, and every thread that calls ``Batcher.submit``
all execute against shared batcher/pipeline/guard state.  On a card
three of them also own a CUDA stream for their life: each lane worker
sets its lane's stream at thread start (serve/lanes.py), the shadow
worker makes a stream of its own current (control/rollout.py
``_shadow_run``), and admission runs on the controller's admission
stream, made once when the controller is built (``_admission_device``).
A stream orders the kernels a thread launches; it does not order the
host state those threads share, which is what this map is for.  This
module makes the thread boundary DECLARED and machine-checked:

* :data:`THREAD_ROOTS` is the authoritative registry of thread entry
  points.  Every entry is hand-declared because thread boundaries in
  this codebase are invisible to a call graph — work crosses onto a
  lane/confirm worker as a closure through ``LaneWorker.submit``, so the
  functions those closures call are declared as entries of the worker
  root, not discovered.
* :func:`build_thread_map` parses the serve-plane sources (no imports,
  pure AST), builds a conservative call graph, and computes for every
  function the set of thread roots that can reach it.  ``concheck``
  consumes this to decide which attribute mutations are genuinely
  multi-threaded.

The call graph is deliberately over-approximate (attribute calls
resolve by method name when the receiver type cannot be inferred): for
"which threads can execute this function" an over-approximation errs
toward reporting more sharing, never less — the safe direction for a
race analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: package root (ingress_plus_tpu_torch/) — analysis targets are relative to it
PACKAGE_ROOT = Path(__file__).resolve().parent.parent

#: the serve-plane sources concheck audits.
#: Threads started outside these files lie outside the boundary:
#: serve/client.py's connection and sender threads are a load generator's
#: (the client side of the socket); serve/front.py and
#: control/fleetobs.py are processes of their own in production (the
#: admission front, the fleet observer) and touch no serve-plane object;
#: control/fleetctl.py's drill harness runs a node's asyncio loop on a
#: thread, standing in for a serve process's event-loop thread;
#: utils/faults.py's collector is a test double; and parallel/ starts no
#: thread (the mesh step walks its entries on the caller's thread, one
#: CUDA stream per entry).  serve/stream.py is deliberately OUT: StreamState handles are poisoned
#: cross-thread by design (documented bool-write-atomic contract) and
#: live entirely inside the dispatch thread's happens-before chain.
#: serve/websocket.py is IN for its shared-state touches (it mutates
#: pipeline stats), but ServeLoop._handle_conn is NOT a registered
#: root: per-connection WSStream/stream state is owned by the single
#: asyncio event-loop thread, and rooting the handler would flag every
#: per-connection field as shared — the boundary model is batcher-and-
#: below, where the real threads live.
SERVE_PLANE_FILES: Tuple[str, ...] = (
    "serve/batcher.py",
    "serve/lanes.py",
    "serve/server.py",
    "serve/websocket.py",
    "models/pipeline.py",
    "models/confirm_plane.py",
    "models/confirm.py",
    "models/tenant_guard.py",
    "models/rule_stats.py",
    "control/rollout.py",
    "utils/trace.py",
    "post/counters.py",
    "post/topk.py",
    "post/queue.py",
    "post/channel.py",
    "post/export.py",
    "post/aggregate.py",
    "post/brute.py",
)


@dataclass(frozen=True)
class ThreadRoot:
    """One declared thread entry point class.

    ``entries`` are ``"relpath::Qualname"`` keys (``Class.method`` or a
    module-level function).  ``concurrent=True`` means two or more OS
    threads may execute this root SIMULTANEOUSLY (N lane workers, M
    confirm workers, arbitrary submit callers) — a single concurrent
    root is therefore already a data-race boundary on its own."""

    name: str
    entries: Tuple[str, ...]
    concurrent: bool
    description: str


#: The authoritative thread map of the serve plane.  Adding a thread to
#: the codebase without registering it here is itself a finding
#: (``conc.unregistered-thread`` — concheck cross-checks every
#: ``threading.Thread(target=...)`` site against these entries).
THREAD_ROOTS: Tuple[ThreadRoot, ...] = (
    ThreadRoot(
        name="dispatch",
        entries=("serve/batcher.py::Batcher._run",
                 "serve/batcher.py::Batcher._run_mesh"),
        concurrent=False,
        description="the ipt-batcher dispatch thread: drains admission, "
                    "launches/collects device cycles, resolves verdict "
                    "futures (sole owner of stream state and the mesh "
                    "double buffer)"),
    ThreadRoot(
        name="lane_worker",
        entries=("serve/lanes.py::LaneWorker._run",
                 # closures cross onto the worker via LaneWorker.submit:
                 # these are the functions the dispatch thread wraps in
                 # lambdas and hands over (serve/batcher.py lane.call)
                 "models/pipeline.py::DetectionPipeline.detect_strict",
                 "models/pipeline.py::DetectionPipeline.detect_tenant_degraded",
                 "serve/batcher.py::Batcher._stream_step"),
        concurrent=True,
        description="ipt-device-N per-card dispatch workers (one per "
                    "lane, each with its card and its lane's CUDA "
                    "stream current; zombies may linger after an "
                    "abandon, and a replacement gets a fresh stream)"),
    ThreadRoot(
        name="confirm_worker",
        entries=("models/confirm_plane.py::confirm_one",),
        concurrent=True,
        description="ipt-confirm-N sharded confirm workers "
                    "(--confirm-workers > 1); shares arrive as closures "
                    "through ConfirmPool.submit"),
    ThreadRoot(
        name="watchdog",
        entries=("serve/batcher.py::Batcher._watch",),
        concurrent=False,
        description="ipt-watchdog monitor: releases a wedged cycle's "
                    "futures fail-open, drains the queue while the "
                    "dispatcher is stuck"),
    ThreadRoot(
        name="oversized",
        entries=("serve/batcher.py::Batcher._run_oversized",),
        concurrent=False,
        description="ipt-oversized side worker: inflates and "
                    "chunk-scans oversized bodies off the batch path"),
    ThreadRoot(
        name="shadow",
        entries=("control/rollout.py::RolloutController._shadow_run",),
        concurrent=False,
        description="ipt-shadow rollout mirror: replays sampled live "
                    "traffic through the candidate generation (on a "
                    "card: the candidate's own kernels on a CUDA stream "
                    "of this thread's own)"),
    ThreadRoot(
        name="rollout_admission",
        entries=("control/rollout.py::RolloutController.admit",
                 "control/rollout.py::RolloutController.admit_scoring",
                 "control/rollout.py::RolloutController.abort",
                 "control/rollout.py::RolloutController.close"),
        concurrent=False,
        description="staged-rollout admission: runs on an HTTP executor "
                    "thread (ServeLoop run_in_executor), builds and "
                    "gates the candidate generation (on a card: on the "
                    "controller's admission CUDA stream)"),
    ThreadRoot(
        name="exporter",
        entries=("post/export.py::Exporter._run",
                 "post/export.py::RulesetWatcher._run"),
        concurrent=False,
        description="postanalytics exporter + artifact watcher threads"),
    ThreadRoot(
        name="submit",
        entries=("serve/batcher.py::Batcher.submit",
                 "serve/batcher.py::Batcher.begin_stream",
                 "serve/batcher.py::Batcher.feed_chunk",
                 "serve/batcher.py::Batcher.finish_stream",
                 "serve/batcher.py::Batcher.abort_stream"),
        concurrent=True,
        description="admission callers: the asyncio event loop in "
                    "production, arbitrary threads in benches/tests — "
                    "Batcher.submit is a declared thread-safe API "
                    "(models/tenant_guard.py contract)"),
    ThreadRoot(
        name="control",
        entries=("serve/batcher.py::Batcher.swap_ruleset",
                 "serve/batcher.py::Batcher.set_tenant_tags",
                 "serve/batcher.py::Batcher.set_scoring_head",
                 "serve/batcher.py::Batcher.reset_latency_observations",
                 "serve/batcher.py::Batcher.warm_lanes",
                 "serve/batcher.py::Batcher.close",
                 # the HTTP POST handlers run their mutations on
                 # executor threads (run_in_executor) — two concurrent
                 # POSTs are two threads
                 "serve/server.py::ServeLoop._route_http"),
        concurrent=True,
        description="control-plane mutations (hot swap, tenant tables, "
                    "scoring head, bench resets, HTTP POST handlers): "
                    "HTTP executor threads and the ipt-swapwarm-N "
                    "ephemeral warmers they fan out"),
    ThreadRoot(
        name="scrape",
        entries=("serve/server.py::ServeLoop._metrics_text",
                 "models/tenant_guard.py::TenantGuard.snapshot",
                 "models/tenant_guard.py::TenantGuard.brief",
                 "models/tenant_guard.py::TenantGuard.counters",
                 "models/rule_stats.py::RuleStats.health",
                 "models/rule_stats.py::RuleStats.rules_json",
                 "control/rollout.py::RolloutController.status",
                 "post/channel.py::PostChannel.status"),
        concurrent=True,
        description="status/metrics readers: /metrics, /healthz, "
                    "/tenants, /rules/*, dbg — read-only views that "
                    "must snapshot, never hold live references"),
)


# --------------------------------------------------------------- parsing


@dataclass
class FunctionInfo:
    """One analyzed function (nested defs and lambdas are merged into
    their enclosing function — a closure's body executes with the
    enclosing lexical context, and the declared registry covers the
    cases where it actually runs on another thread)."""

    key: str                       # "relpath::Qual.name"
    file: str
    cls: Optional[str]
    name: str
    lineno: int
    node: ast.AST = None           # type: ignore[assignment]
    calls: List[tuple] = field(default_factory=list)
    bases: Tuple[str, ...] = ()


@dataclass
class ClassInfo:
    name: str
    file: str
    bases: Tuple[str, ...]
    methods: Dict[str, str] = field(default_factory=dict)  # name -> key
    #: attr name -> type descriptor:
    #:   ("cls", "Name") | ("listof", "Name") | ("lock",) |
    #:   ("cond", lock_attr) | ("thread", daemon) | ("queue",) | None
    attr_types: Dict[str, tuple] = field(default_factory=dict)


@dataclass
class ModuleMap:
    """Everything the analyzers need from the parsed tree."""

    files: Dict[str, ast.Module]
    sources: Dict[str, List[str]]
    functions: Dict[str, FunctionInfo]
    classes: Dict[str, ClassInfo]          # class name -> info (last wins)
    func_by_name: Dict[str, List[str]]     # bare name -> keys
    method_index: Dict[str, List[str]]     # method name -> keys


def _call_name(node: ast.Call):
    """Classify a call target for conservative resolution."""
    f = node.func
    if isinstance(f, ast.Name):
        return ("name", f.id)
    if isinstance(f, ast.Attribute):
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id == "self":
            return ("self", f.attr)
        return ("attr", _expr_chain(recv), f.attr)
    return None


def _expr_chain(node) -> Optional[Tuple[str, ...]]:
    """``self.a.b`` → ("self", "a", "b"); ``x.y`` → ("x", "y");
    anything non-chain → None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    if isinstance(node, ast.Subscript):
        inner = _expr_chain(node.value)
        if inner is not None:
            return inner + ("[]",)
    return None


#: method names too generic to resolve by name alone (dict/list/str
#: builtins and same-name methods on unrelated classes shadow them) —
#: resolved only through an inferred receiver type
_AMBIENT_METHODS = frozenset({
    "get", "put", "update", "items", "keys", "values", "append", "pop",
    "popleft", "appendleft", "add", "remove", "discard", "clear",
    "extend", "sort", "join", "start", "wait", "set", "copy", "index",
    "count", "read", "write", "split", "strip", "encode", "decode",
    "format", "setdefault", "mkdir", "exists", "is_set", "close",
    "insert", "sum", "mean", "any", "all", "release", "acquire",
    "rotate", "result", "done", "cancel", "tolist", "astype", "send",
    "recv", "fileno", "flush", "match", "search", "group", "lower",
    "upper", "startswith", "endswith", "replace", "partition",
    # same-name methods on unrelated in-scope classes (Histogram vs
    # LoadController observe, Batcher vs LaneWorker submit, the many
    # snapshot()/reset()/record() views): by-name resolution here
    # manufactures cross-class reachability out of thin air
    "submit", "observe", "snapshot", "record", "reset", "status",
    "drain", "fire", "feed", "swap_ruleset",
})

_CTOR_TYPES = {
    ("threading", "Lock"): ("lock",),
    ("threading", "RLock"): ("lock",),
    ("queue", "Queue"): ("queue",),
    ("deque",): ("list",),
    ("collections", "deque"): ("list",),
    ("defaultdict",): ("dict",),
    ("collections", "defaultdict"): ("dict",),
}


def _infer_ctor(node) -> Optional[tuple]:
    """Type descriptor for a ``self.x = <expr>`` RHS."""
    if isinstance(node, ast.Call):
        chain = _expr_chain(node.func)
        if chain is None:
            return None
        if chain in _CTOR_TYPES:
            return _CTOR_TYPES[chain]
        if len(chain) == 1 and (chain[0],) in _CTOR_TYPES:
            return _CTOR_TYPES[(chain[0],)]
        if chain == ("threading", "Condition"):
            if node.args:
                arg = _expr_chain(node.args[0])
                if arg and arg[0] == "self" and len(arg) == 2:
                    return ("cond", arg[1])
            return ("lock",)
        if chain == ("threading", "Thread"):
            daemon = False
            for kw in node.keywords:
                if kw.arg == "daemon" and isinstance(kw.value,
                                                     ast.Constant):
                    daemon = bool(kw.value.value)
            return ("thread", daemon)
        if chain == ("named_lock",) or chain[-1] == "named_lock":
            return ("lock",)
        if len(chain) == 1 and chain[0][:1].isupper():
            return ("cls", chain[0])
    if isinstance(node, ast.ListComp) and isinstance(node.elt, ast.Call):
        c = _expr_chain(node.elt.func)
        if c and len(c) >= 2 and c[-2:] == ("threading", "Thread"):
            return ("listof_thread",)
        if c and len(c) == 1 and c[0][:1].isupper():
            return ("listof", c[0])
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return ("dict",)
    if isinstance(node, (ast.List, ast.ListComp)):
        return ("list",)
    if isinstance(node, (ast.Set, ast.SetComp)):
        return ("set",)
    return None


def parse_tree(root: Optional[Path] = None,
               files: Sequence[str] = SERVE_PLANE_FILES) -> ModuleMap:
    """Parse the target files into the shared module map (pure AST — the
    analyzer must run in CI without importing torch-heavy modules)."""
    root = Path(root) if root is not None else PACKAGE_ROOT
    mm = ModuleMap(files={}, sources={}, functions={}, classes={},
                   func_by_name={}, method_index={})
    for rel in files:
        p = root / rel
        if not p.is_file():
            continue
        src = p.read_text()
        tree = ast.parse(src, filename=str(p))
        mm.files[rel] = tree
        mm.sources[rel] = src.splitlines()
        _index_module(mm, rel, tree)
    _collect_calls(mm)
    return mm


def _index_module(mm: ModuleMap, rel: str, tree: ast.Module) -> None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            bases = tuple(b.id for b in node.bases
                          if isinstance(b, ast.Name))
            # last wins, explicitly: a same-named class in a later file
            # REPLACES the earlier entry (merging two classes' methods
            # into one ClassInfo would mis-attribute accesses silently)
            ci = ClassInfo(name=node.name, file=rel, bases=bases)
            mm.classes[node.name] = ci
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    key = "%s::%s.%s" % (rel, node.name, item.name)
                    fi = FunctionInfo(key=key, file=rel, cls=node.name,
                                      name=item.name, lineno=item.lineno,
                                      node=item, bases=bases)
                    mm.functions[key] = fi
                    ci.methods[item.name] = key
                    mm.method_index.setdefault(item.name, []).append(key)
                    _infer_attr_types(ci, item)
            # dataclass field annotations: ``x: Dict[...] = field(...)``
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and \
                        isinstance(item.target, ast.Name):
                    ci.attr_types.setdefault(
                        item.target.id,
                        _annotation_type(item.annotation))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = "%s::%s" % (rel, node.name)
            fi = FunctionInfo(key=key, file=rel, cls=None,
                              name=node.name, lineno=node.lineno,
                              node=node)
            mm.functions[key] = fi
            mm.func_by_name.setdefault(node.name, []).append(key)


def _annotation_type(ann) -> Optional[tuple]:
    """Type descriptor from an annotation node.  Handles ``Optional[X]``
    (unwraps), string annotations ("Batcher"), containers, and plain
    in-scope class names."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.split(".")[-1].split("[")[0]
        return ("cls", name) if name[:1].isupper() else None
    if isinstance(ann, ast.Subscript):
        chain = _expr_chain(ann.value)
        tail = chain[-1] if chain else ""
        if tail == "Optional":
            return _annotation_type(ann.slice)
        if tail in ("Dict", "dict", "DefaultDict"):
            return ("dict",)
        if tail in ("List", "list", "Deque", "deque"):
            return ("list",)
        if tail in ("Set", "set", "FrozenSet"):
            return ("set",)
        return None
    chain = _expr_chain(ann)
    if chain is None:
        return None
    tail = chain[-1]
    if tail in ("Dict", "dict", "DefaultDict"):
        return ("dict",)
    if tail in ("List", "list", "Deque", "deque"):
        return ("list",)
    if tail in ("Set", "set"):
        return ("set",)
    if tail in ("Lock", "RLock"):
        return ("lock",)
    if tail[:1].isupper() and tail not in (
            "Tuple", "Sequence", "Iterable", "Callable", "Any",
            "Union", "Optional", "Mapping", "Type", "Future"):
        return ("cls", tail)
    return None


def _infer_attr_types(ci: ClassInfo, fn: ast.AST) -> None:
    """Record ``self.x = <typed expr>`` assignments (any method — most
    live in __init__) plus param-annotation propagation
    (``def __init__(self, pipeline: DetectionPipeline)`` +
    ``self.pipeline = pipeline``)."""
    ann: Dict[str, tuple] = {}
    args = fn.args
    for a in list(args.posonlyargs) + list(args.args) + \
            list(args.kwonlyargs):
        if a.annotation is not None:
            t = _annotation_type(a.annotation)
            if t is not None and t[0] == "cls":
                ann[a.arg] = t
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                t = _infer_ctor(node.value)
                if t is None and isinstance(node.value, ast.Name):
                    t = ann.get(node.value.id)
                if t is not None:
                    ci.attr_types.setdefault(tgt.attr, t)


def _collect_calls(mm: ModuleMap) -> None:
    for fi in mm.functions.values():
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                c = _call_name(node)
                if c is not None:
                    fi.calls.append(c)


# ---------------------------------------------------------- resolution


def resolve_local_types(mm: ModuleMap, fi: FunctionInfo) -> Dict[str, tuple]:
    """Best-effort local-variable type map for one function: parameters
    by annotation, ``x = self.attr`` / ``x = self.a.b`` chains through
    the class attr-type table, ``x = ClassName(...)``, and loop vars
    over list-of-class locals."""
    out: Dict[str, tuple] = {}
    args = fi.node.args
    for a in list(args.posonlyargs) + list(args.args) + \
            list(args.kwonlyargs):
        if a.annotation is not None:
            t = _annotation_type(a.annotation)
            if t is not None and t[0] == "cls" and t[1] in mm.classes:
                out[a.arg] = t
    for _ in range(2):   # two passes: aliases of aliases
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                t = _infer_ctor(node.value)
                if t is None:
                    chain = _expr_chain(node.value)
                    if chain is not None:
                        t = chain_type(mm, fi, chain, out)
                if t is not None:
                    out.setdefault(name, t)
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name):
                chain = _expr_chain(node.iter)
                if chain is not None:
                    t = chain_type(mm, fi, chain, out)
                    if t is not None and t[0] == "listof":
                        out.setdefault(node.target.id, ("cls", t[1]))
                    elif t is not None and t[0] == "listof_thread":
                        out.setdefault(node.target.id,
                                       ("thread", False))
    return out


def chain_type(mm: ModuleMap, fi: FunctionInfo,
               chain: Tuple[str, ...],
               local_types: Dict[str, tuple]) -> Optional[tuple]:
    """Resolve an attribute chain to a type descriptor."""
    if not chain:
        return None
    head, rest = chain[0], chain[1:]
    if head == "self":
        if fi.cls is None:
            return None
        t: Optional[tuple] = ("cls", fi.cls)
    else:
        t = local_types.get(head)
    for part in rest:
        if t is None:
            return None
        if part == "[]":
            t = ("cls", t[1]) if t[0] == "listof" else None
            continue
        if t[0] != "cls" or t[1] not in mm.classes:
            return None
        t = mm.classes[t[1]].attr_types.get(part)
    return t


def _mro_method(mm: ModuleMap, cls: str, name: str) -> Optional[str]:
    seen = set()
    stack = [cls]
    while stack:
        c = stack.pop(0)
        if c in seen or c not in mm.classes:
            continue
        seen.add(c)
        ci = mm.classes[c]
        if name in ci.methods:
            return ci.methods[name]
        stack.extend(ci.bases)
    return None


def resolve_callees(mm: ModuleMap, fi: FunctionInfo,
                    local_types: Optional[Dict[str, tuple]] = None
                    ) -> Set[str]:
    """Function keys this function may call (conservative)."""
    if local_types is None:
        local_types = resolve_local_types(mm, fi)
    out: Set[str] = set()
    for call in fi.calls:
        if call[0] == "name":
            name = call[1]
            if name in mm.classes:      # constructor
                k = _mro_method(mm, name, "__init__")
                if k:
                    out.add(k)
            out.update(mm.func_by_name.get(name, ()))
        elif call[0] == "self":
            if fi.cls is not None:
                k = _mro_method(mm, fi.cls, call[1])
                if k:
                    out.add(k)
                    continue
            out.update(mm.func_by_name.get(call[1], ()))
        elif call[0] == "attr":
            chain, meth = call[1], call[2]
            t = chain_type(mm, fi, chain, local_types) if chain else None
            if t is not None and t[0] == "cls":
                k = _mro_method(mm, t[1], meth)
                if k:
                    out.add(k)
                continue
            if meth not in _AMBIENT_METHODS:
                out.update(mm.method_index.get(meth, ()))
    return out


# -------------------------------------------------------- reachability


@dataclass
class ThreadMap:
    """roots + per-function reachability: the product concheck (and the
    docs) consume."""

    roots: Tuple[ThreadRoot, ...]
    #: function key -> set of root names that can execute it
    reach: Dict[str, Set[str]]
    mm: ModuleMap

    def roots_of(self, key: str) -> Set[str]:
        return self.reach.get(key, set())

    def is_concurrent(self, names: Set[str]) -> bool:
        """True when ``names`` implies two threads can run at once:
        two distinct roots, or one root that is itself concurrent."""
        if len(names) >= 2:
            return True
        by = {r.name: r for r in self.roots}
        return any(by[n].concurrent for n in names if n in by)

    def registry_json(self) -> List[dict]:
        return [{"name": r.name, "concurrent": r.concurrent,
                 "entries": list(r.entries),
                 "description": r.description}
                for r in self.roots]


def build_thread_map(root: Optional[Path] = None,
                     roots: Tuple[ThreadRoot, ...] = THREAD_ROOTS,
                     mm: Optional[ModuleMap] = None) -> ThreadMap:
    if mm is None:
        mm = parse_tree(root)
    # constructor edges are EXCLUDED from reachability: an object under
    # construction is thread-local until published, so a root reaching
    # ``ClassName(...)`` does not make that class's __init__-time
    # mutations shared (fresh-object exemption, interprocedural half)
    callees: Dict[str, Set[str]] = {
        k: {c for c in resolve_callees(mm, fi)
            if not c.endswith(".__init__")}
        for k, fi in mm.functions.items()}
    reach: Dict[str, Set[str]] = {}
    for r in roots:
        frontier = [e for e in r.entries if e in mm.functions]
        seen: Set[str] = set()
        while frontier:
            k = frontier.pop()
            if k in seen:
                continue
            seen.add(k)
            reach.setdefault(k, set()).add(r.name)
            frontier.extend(callees.get(k, ()))
    return ThreadMap(roots=roots, reach=reach, mm=mm)
