"""concheck — concurrency static analysis of the serve plane
(docs/ANALYSIS.md "Concurrency analysis").

rulecheck is the static twin of a measured property of the
RULESET; concheck is the static twin of a measured property of the
SERVE PLANE: thread safety.  Four check classes over the AST of the
serve-plane sources (analysis/threadmap.py SERVE_PLANE_FILES):

1. **Thread-boundary map** — the declared registry of thread entry
   points (threadmap.THREAD_ROOTS) + conservative reachability, so
   every function knows which threads can execute it.  A
   ``threading.Thread(target=...)`` whose target is not a registered
   entry is itself a finding (``conc.unregistered-thread``).
2. **Guarded-by inference + unguarded mutations** — infer which
   attributes are only ever touched under a lock (``with self._lock``
   regions, propagated interprocedurally through always-locked call
   sites), then flag attributes MUTATED from two or more thread roots
   (a concurrent root — N lane workers, arbitrary submit callers —
   counts alone) where at least one mutation site is unguarded: the
   lost-update / resize-during-iteration race class.  Container mutations (dict/set/list resize —
   the "changed size during iteration" crash class) and
   mixed-discipline attributes (guarded in one method, bare in
   another) are errors; plain lost-update counters are warnings.
3. **Lock-order graph** — nested-acquisition edges across all modules
   (syntactic nesting + locks inherited through always-locked call
   sites); any cycle is ``conc.lock-order-cycle`` (deadlock risk).
4. **Thread-lifecycle lint** — non-daemon worker threads,
   ``join()`` without a timeout on a worker/warmer thread, silent
   except-pass handlers inside thread entry loops, and blocking
   queue-consumer loops without the abandon/replace None-sentinel
   pattern (serve/lanes.py LaneWorker is the reference discipline).

Intentional lock-free fast paths are annotatable inline::

    self.hits += 1   # concheck: ok telemetry-grade; GIL-atomic int add

An annotated site suppresses its finding with the reason carried into
the report (like a baseline entry, but next to the code it justifies).
The checked-in baseline (analysis/concheck-baseline.json) covers the
class-level patterns a per-line annotation cannot express — e.g.
single-owner handoff objects whose happens-before edge is a
``LanePending.wait``.

False-positive posture: the call graph and receiver typing are
conservative (over-approximate reachability, under-approximate guard
inference), so concheck over-reports rather than under-reports; the
baseline + annotations are the pressure valve, and both require a
reason.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ingress_plus_tpu_torch.analysis.findings import Baseline, Finding, Report
from ingress_plus_tpu_torch.analysis.threadmap import (
    _AMBIENT_METHODS,
    _mro_method,
    FunctionInfo,
    ModuleMap,
    ThreadMap,
    _expr_chain,
    build_thread_map,
    chain_type,
    resolve_callees,
    resolve_local_types,
)

#: container-method names that mutate the receiver
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "add", "insert", "remove",
    "discard", "pop", "popleft", "clear", "update", "setdefault",
    "rotate", "sort", "reverse", "offer",
})

#: builtins whose single-argument call is an atomic C-level snapshot of
#: the argument under the GIL — the documented safe-read idiom
#: (``dict(live)`` / ``list(live)``), never an iteration race
_SNAPSHOT_FNS = frozenset({"list", "dict", "tuple", "set", "frozenset",
                           "len", "sorted", "sum", "min", "max"})

_ANNOT_RE = re.compile(r"#\s*concheck:\s*ok\b[:\s]*(.*)")

LockId = Tuple[str, str]          # (class name or "?", attr name)


@dataclass
class Access:
    owner: str                    # class name
    attr: str
    kind: str                     # read|iterate|escape|assign|augassign|container
    func: str                     # function key
    file: str
    line: int
    locks: FrozenSet[LockId]      # syntactic locks held at the site


@dataclass
class _FuncScan:
    accesses: List[Access] = field(default_factory=list)
    #: lock acquisitions: (lock_id, syntactic locks held, line)
    acquisitions: List[Tuple[LockId, FrozenSet[LockId], int]] = \
        field(default_factory=list)
    #: callsites: (callee key, syntactic locks held)
    callsites: List[Tuple[str, FrozenSet[LockId]]] = \
        field(default_factory=list)
    #: thread ctor sites: (target key or None, daemon, line)
    thread_ctors: List[Tuple[Optional[str], bool, int]] = \
        field(default_factory=list)
    #: join() calls with no timeout on thread-typed receivers: lines
    naked_joins: List[int] = field(default_factory=list)


class _Scanner:
    """One function's AST walk: accesses with lock context, lock
    acquisitions, call sites, and the lifecycle raw material."""

    def __init__(self, mm: ModuleMap, fi: FunctionInfo):
        self.mm = mm
        self.fi = fi
        self.local_types = resolve_local_types(mm, fi)
        self.out = _FuncScan()
        self.callees_cache = resolve_callees(mm, fi, self.local_types)
        self._reads: Set[Tuple[str, str]] = set()
        self._writes: Set[Tuple[str, str]] = set()
        # locals holding objects CONSTRUCTED in this function: they are
        # thread-local until published — accesses through them are not
        # shared-state accesses (fresh-object exemption, local half)
        self._fresh: Set[str] = set()
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                chain = _expr_chain(node.value.func)
                if chain is not None and len(chain) == 1 \
                        and chain[0] in mm.classes:
                    self._fresh.add(node.targets[0].id)

    # ------------------------------------------------------ resolution

    def _owner_attr(self, node) -> Optional[Tuple[str, str]]:
        """Resolve an Attribute node to (owner class, attr) when the
        receiver's class is one of ours."""
        if not isinstance(node, ast.Attribute):
            return None
        chain = _expr_chain(node)
        if chain is None or len(chain) < 2:
            return None
        recv, attr = chain[:-1], chain[-1]
        if attr.startswith("__"):
            return None
        if recv[0] in self._fresh:
            return None
        t = chain_type(self.mm, self.fi, recv, self.local_types)
        if t is not None and t[0] == "cls" and t[1] in self.mm.classes:
            return (t[1], attr)
        return None

    def _lock_id(self, expr) -> Optional[LockId]:
        chain = _expr_chain(expr)
        if chain is None or len(chain) < 2:
            return None
        recv, attr = chain[:-1], chain[-1]
        t = chain_type(self.mm, self.fi, recv, self.local_types)
        if t is not None and t[0] == "cls" and t[1] in self.mm.classes:
            at = self.mm.classes[t[1]].attr_types.get(attr)
            if at is not None:
                if at[0] == "lock":
                    return (t[1], attr)
                if at[0] == "cond":
                    return (t[1], at[1])
        if "lock" in attr.lower() or attr in ("_not_empty", "_not_full"):
            owner = t[1] if (t is not None and t[0] == "cls") else "?"
            return (owner, attr)
        return None

    def _container_typed(self, owner: str, attr: str) -> bool:
        at = self.mm.classes[owner].attr_types.get(attr)
        return at is not None and at[0] in ("dict", "list", "set",
                                            "listof")

    # ----------------------------------------------------------- walk

    def scan(self) -> _FuncScan:
        body = self.fi.node.body
        for stmt in body:
            self._visit(stmt, frozenset())
        # RMW promotion: a plain assign to an attr this function also
        # READS is a read-modify-write (the Ewma.update shape), not an
        # atomic rebind
        for a in self.out.accesses:
            if a.kind == "assign" and (a.owner, a.attr) in self._reads:
                a.kind = "augassign"
        return self.out

    def _record(self, owner_attr, kind: str, node,
                locks: FrozenSet[LockId]) -> None:
        owner, attr = owner_attr
        self.out.accesses.append(Access(
            owner=owner, attr=attr, kind=kind, func=self.fi.key,
            file=self.fi.file, line=getattr(node, "lineno", 0),
            locks=locks))
        if kind in ("assign", "augassign", "container"):
            self._writes.add((owner, attr))
        else:
            self._reads.add((owner, attr))

    def _visit(self, node, locks: FrozenSet[LockId]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(locks)
            for item in node.items:
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    self.out.acquisitions.append(
                        (lid, locks, node.lineno))
                    inner.add(lid)
                else:
                    self._visit_expr(item.context_expr, locks)
            inner_f = frozenset(inner)
            for stmt in node.body:
                self._visit(stmt, inner_f)
            return
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._visit_target(tgt, locks)
            self._visit_expr(node.value, locks)
            return
        if isinstance(node, ast.AugAssign):
            self._visit_target(node.target, locks, aug=True)
            self._visit_expr(node.value, locks)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    oa = self._owner_attr(tgt.value)
                    if oa is not None:
                        self._record(oa, "container", tgt, locks)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                oa = self._owner_attr(node.value)
                if oa is not None and self._container_typed(*oa):
                    self._record(oa, "escape", node, locks)
                else:
                    self._visit_expr(node.value, locks)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            oa = self._owner_attr(node.iter)
            if oa is not None:
                self._record(oa, "iterate", node.iter, locks)
            else:
                self._visit_expr(node.iter, locks)
            for stmt in node.body + node.orelse:
                self._visit(stmt, locks)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested defs/lambdas merge into the enclosing function,
            # WITH the enclosing lock context at their definition site
            # (closures handed across threads are covered by the
            # declared registry, not by pretending they are calls)
            body = node.body if isinstance(node.body, list) \
                else [ast.Expr(value=node.body)]
            for stmt in body:
                self._visit(stmt, locks)
            return
        if isinstance(node, ast.Expr):
            self._visit_expr(node.value, locks)
            return
        # generic statement: visit children as statements/expressions
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, locks)
            else:
                self._visit(child, locks)

    def _visit_target(self, tgt, locks: FrozenSet[LockId],
                      aug: bool = False) -> None:
        if isinstance(tgt, ast.Attribute):
            oa = self._owner_attr(tgt)
            if oa is not None:
                self._record(oa, "augassign" if aug else "assign",
                             tgt, locks)
            return
        if isinstance(tgt, ast.Subscript):
            oa = self._owner_attr(tgt.value)
            if oa is not None:
                self._record(oa, "container", tgt, locks)
            else:
                self._visit_expr(tgt.value, locks)
            self._visit_expr(tgt.slice, locks)
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._visit_target(el, locks, aug=aug)

    def _visit_expr(self, node, locks: FrozenSet[LockId]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, locks)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                oa = self._owner_attr(gen.iter)
                if oa is not None:
                    self._record(oa, "iterate", gen.iter, locks)
                else:
                    self._visit_expr(gen.iter, locks)
                for cond in gen.ifs:
                    self._visit_expr(cond, locks)
            if isinstance(node, ast.DictComp):
                self._visit_expr(node.key, locks)
                self._visit_expr(node.value, locks)
            else:
                self._visit_expr(node.elt, locks)
            return
        if isinstance(node, ast.Attribute):
            oa = self._owner_attr(node)
            if oa is not None:
                self._record(oa, "read", node, locks)
            else:
                self._visit_expr(node.value, locks)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node, locks)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, locks)

    def _visit_call(self, node: ast.Call, locks: FrozenSet[LockId]) -> None:
        f = node.func
        # snapshot builtins: dict(x)/list(x)... is an atomic copy
        if isinstance(f, ast.Name) and f.id in _SNAPSHOT_FNS \
                and len(node.args) == 1:
            oa = self._owner_attr(node.args[0])
            if oa is not None:
                self._record(oa, "read", node.args[0], locks)
            else:
                self._visit_expr(node.args[0], locks)
            return
        if isinstance(f, ast.Attribute):
            # mutating container method on a RAW-container attribute —
            # a method call on a class-typed attr (SlowRing.offer,
            # Ewma.update) is that class's business, analyzed there
            oa = self._owner_attr(f.value)
            if oa is not None and f.attr in _MUTATORS \
                    and self._container_typed(*oa):
                self._record(oa, "container", node, locks)
            elif oa is not None:
                self._record(oa, "read", f.value, locks)
            else:
                self._visit_expr(f.value, locks)
            # thread lifecycle raw material
            if f.attr == "join":
                self._check_join(node, f)
            chain = _expr_chain(f)
            if chain is not None and len(chain) >= 2 \
                    and chain[-2:] == ("threading", "Thread"):
                self._record_thread_ctor(node)
        # record resolved callsites for guard propagation — EXCEPT calls
        # on freshly constructed locals: a method running on an object
        # this function just built is not a shared-state entry, and its
        # bare lock context must not poison the callee's inferred guard
        fresh_recv = False
        if isinstance(f, ast.Attribute):
            rchain = _expr_chain(f.value)
            fresh_recv = bool(rchain) and rchain[0] in self._fresh
        if not fresh_recv:
            for callee in self._resolve_one_call(node):
                self.out.callsites.append((callee, locks))
        for arg in node.args:
            self._visit_expr(arg, locks)
        for kw in node.keywords:
            self._visit_expr(kw.value, locks)

    def _resolve_one_call(self, node: ast.Call) -> Set[str]:
        mm, fi = self.mm, self.fi
        f = node.func
        out: Set[str] = set()
        if isinstance(f, ast.Name):
            if f.id in mm.classes:
                k = mm.classes[f.id].methods.get("__init__")
                if k:
                    out.add(k)
            out.update(mm.func_by_name.get(f.id, ()))
        elif isinstance(f, ast.Attribute):
            chain = _expr_chain(f.value)
            meth = f.attr
            t = chain_type(mm, fi, chain, self.local_types) \
                if chain else None
            if t is not None and t[0] == "cls" and t[1] in mm.classes:
                k = _mro_method(mm, t[1], meth)
                if k:
                    out.add(k)
                return out
            if chain == ("self",) and fi.cls is not None:
                k = _mro_method(mm, fi.cls, meth)
                if k:
                    out.add(k)
                return out
            if meth not in _AMBIENT_METHODS:
                out.update(mm.method_index.get(meth, ()))
        return out

    def _record_thread_ctor(self, node: ast.Call) -> None:
        daemon = False
        target_key: Optional[str] = None
        for kw in node.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
            if kw.arg == "target":
                chain = _expr_chain(kw.value)
                if chain is not None:
                    if chain[0] == "self" and len(chain) == 2 \
                            and self.fi.cls is not None:
                        target_key = _mro_method(self.mm, self.fi.cls,
                                                 chain[1])
                    elif len(chain) == 1:
                        keys = self.mm.func_by_name.get(chain[0], ())
                        target_key = keys[0] if keys else None
        self.out.thread_ctors.append((target_key, daemon, node.lineno))

    def _check_join(self, node: ast.Call, f: ast.Attribute) -> None:
        has_timeout = bool(node.args) or any(
            kw.arg == "timeout" for kw in node.keywords)
        if has_timeout:
            return
        chain = _expr_chain(f.value)
        t = chain_type(self.mm, self.fi, chain, self.local_types) \
            if chain else None
        if t is not None and t[0] in ("thread", "listof_thread"):
            self.out.naked_joins.append(node.lineno)


# ------------------------------------------------------------ analysis


def _annotations(mm: ModuleMap) -> Dict[Tuple[str, int], str]:
    """``# concheck: ok <reason>`` inline suppressions by (file, line)."""
    out: Dict[Tuple[str, int], str] = {}
    for rel, lines in mm.sources.items():
        for i, line in enumerate(lines, start=1):
            m = _ANNOT_RE.search(line)
            if m:
                out[(rel, i)] = m.group(1).strip() or "annotated ok"
    return out


def _propagate_guards(mm: ModuleMap, scans: Dict[str, _FuncScan],
                      root_entries: Set[str],
                      reachable: Optional[Set[str]] = None
                      ) -> Dict[str, FrozenSet[LockId]]:
    """Locks every call path provably holds when entering each function
    (intersection over call sites; thread entries start bare).  Under-
    approximates on purpose: an unknown call site contributes the empty
    set only if it exists — functions nobody calls inherit nothing.
    Call sites inside thread-UNREACHABLE functions are ignored: a
    library-only caller cannot race anything, so its bare context must
    not veto the serve plane's consistent locking."""
    callers: Dict[str, List[Tuple[str, FrozenSet[LockId]]]] = {}
    for key, scan in scans.items():
        if reachable is not None and key not in reachable:
            continue
        for callee, locks in scan.callsites:
            callers.setdefault(callee, []).append((key, locks))
    inherited: Dict[str, FrozenSet[LockId]] = {
        k: frozenset() for k in scans}
    for _ in range(4):                      # small fixpoint
        changed = False
        for key in scans:
            if key in root_entries:
                continue
            sites = callers.get(key)
            if not sites:
                continue
            acc: Optional[Set[LockId]] = None
            for caller, locks in sites:
                eff = set(locks) | set(inherited.get(caller,
                                                     frozenset()))
                acc = eff if acc is None else (acc & eff)
            new = frozenset(acc or ())
            if new != inherited[key]:
                inherited[key] = new
                changed = True
        if not changed:
            break
    return inherited


def _fmt_lock(lid: LockId) -> str:
    return "%s.%s" % lid


def _find_cycles(edges: Set[Tuple[LockId, LockId]]) -> List[List[LockId]]:
    graph: Dict[LockId, Set[LockId]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[List[LockId]] = []
    seen_cycles: Set[Tuple[LockId, ...]] = set()
    state: Dict[LockId, int] = {}

    def dfs(n: LockId, path: List[LockId]) -> None:
        state[n] = 1
        path.append(n)
        for m in sorted(graph.get(n, ())):
            if state.get(m, 0) == 1:
                cyc = path[path.index(m):] + [m]
                key = tuple(sorted(cyc[:-1]))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif state.get(m, 0) == 0:
                dfs(m, path)
        path.pop()
        state[n] = 2

    for n in sorted(graph):
        if state.get(n, 0) == 0:
            dfs(n, [])
    return cycles


@dataclass
class ConcScan:
    """The analyzer's intermediate product (exposed for tests and the
    threadmap doc generator)."""

    tmap: ThreadMap
    accesses: List[Access]
    inherited: Dict[str, FrozenSet[LockId]]
    lock_edges: Set[Tuple[LockId, LockId]]
    scans: Dict[str, _FuncScan]


def scan_concurrency(root: Optional[Path] = None,
                     tmap: Optional[ThreadMap] = None) -> ConcScan:
    if tmap is None:
        tmap = build_thread_map(root)
    mm = tmap.mm
    scans: Dict[str, _FuncScan] = {}
    for key, fi in mm.functions.items():
        scans[key] = _Scanner(mm, fi).scan()
    root_entries = {e for r in tmap.roots for e in r.entries}
    inherited = _propagate_guards(mm, scans, root_entries,
                                  reachable=set(tmap.reach))
    # effective lock context = syntactic + inherited; build the final
    # access list and the lock-order edge set
    accesses: List[Access] = []
    edges: Set[Tuple[LockId, LockId]] = set()
    for key, scan in scans.items():
        if _is_ctor(key):
            # an object under construction is thread-local: nothing a
            # constructor touches on self is shared yet
            continue
        inh = inherited.get(key, frozenset())
        for a in scan.accesses:
            if inh:
                a.locks = a.locks | inh
            accesses.append(a)
        for lid, held, _line in scan.acquisitions:
            for h in set(held) | set(inh):
                if h != lid:
                    edges.add((h, lid))
    return ConcScan(tmap=tmap, accesses=accesses, inherited=inherited,
                    lock_edges=edges, scans=scans)


def _is_ctor(key: str) -> bool:
    name = key.rsplit(".", 1)[-1]
    return name in ("__init__", "__post_init__", "__new__")


def check_concurrency(cs: ConcScan) -> List[Finding]:
    """Produce the findings from one scan (annotations applied by the
    caller via ``apply_annotations``)."""
    tmap = cs.tmap
    findings: List[Finding] = []

    # ---- 2. guarded-by inference + unguarded mutations + escapes
    by_attr: Dict[Tuple[str, str], List[Access]] = {}
    for a in cs.accesses:
        by_attr.setdefault((a.owner, a.attr), []).append(a)
    for (owner, attr), accs in sorted(by_attr.items()):
        # only mutations in thread-REACHABLE functions count: a
        # library-only mutator cannot race anything in the serve plane
        muts = [a for a in accs
                if a.kind in ("assign", "augassign", "container")
                and not _is_ctor(a.func)
                and tmap.roots_of(a.func)]
        if muts:
            mut_roots: Set[str] = set()
            for a in muts:
                mut_roots |= tmap.roots_of(a.func)
            unguarded = [a for a in muts if not a.locks]
            guarded = [a for a in muts if a.locks]
            if unguarded and tmap.is_concurrent(mut_roots):
                container = any(a.kind == "container" for a in unguarded)
                mixed = bool(guarded)
                rmw = any(a.kind == "augassign" for a in unguarded)
                if container or mixed:
                    sev = "error"
                elif rmw:
                    sev = "warning"
                else:
                    sev = "notice"   # atomic rebind: torn-free under GIL
                site = unguarded[0]
                kinds = sorted({a.kind for a in unguarded})
                msg = ("%s.%s mutated without a lock (%s) from "
                       "thread roots {%s}; %d unguarded site(s)"
                       % (owner, attr, "/".join(kinds),
                          ",".join(sorted(mut_roots)), len(unguarded)))
                if mixed:
                    locks = sorted({_fmt_lock(lid) for a in guarded
                                    for lid in a.locks})
                    msg += ("; other sites guard it with %s — mixed "
                            "discipline" % ", ".join(locks))
                findings.append(Finding(
                    check="conc.unguarded-mutation", severity=sev,
                    message=msg, subject="%s.%s" % (owner, attr),
                    file=site.file, line=site.line))
        # live-view escapes: the attr is lock-guarded somewhere, still
        # MUTATED after construction, and a method returns/iterates it
        # bare — the quarantined_ids() class
        guard_locks = {lid for a in accs for lid in a.locks}
        if guard_locks and muts:
            for a in accs:
                if a.kind in ("escape", "iterate") and not a.locks:
                    roots = tmap.roots_of(a.func)
                    other_roots = {r for m in accs if m is not a
                                   for r in tmap.roots_of(m.func)}
                    if not roots or not (roots | other_roots):
                        continue
                    if not tmap.is_concurrent(roots | other_roots):
                        continue
                    verb = ("returns a live reference to"
                            if a.kind == "escape" else "iterates")
                    findings.append(Finding(
                        check="conc.live-view-escape", severity="error",
                        message="%s %s %s.%s, which is guarded by %s "
                                "elsewhere — a concurrent resize "
                                "races the consumer (snapshot under "
                                "the lock instead)"
                                % (a.func.split("::")[-1], verb, owner,
                                   attr,
                                   ", ".join(sorted(_fmt_lock(g)
                                                    for g in
                                                    guard_locks))),
                        subject="%s.%s" % (owner, attr),
                        file=a.file, line=a.line))

    # ---- 3. lock-order cycles
    for cyc in _find_cycles(cs.lock_edges):
        findings.append(Finding(
            check="conc.lock-order-cycle", severity="error",
            message="lock-order cycle: %s — two threads taking these "
                    "in opposite order deadlock"
                    % " -> ".join(_fmt_lock(l) for l in cyc),
            subject=" -> ".join(_fmt_lock(l) for l in cyc)))

    # ---- 1b/4. thread lifecycle
    root_entries = {e for r in tmap.roots for e in r.entries}
    for key, scan in cs.scans.items():
        fi = tmap.mm.functions[key]
        for target_key, daemon, line in scan.thread_ctors:
            if not daemon:
                findings.append(Finding(
                    check="conc.thread-no-daemon", severity="warning",
                    message="thread created without daemon=True in %s "
                            "— a wedged worker blocks interpreter exit"
                            % key.split("::")[-1],
                    subject=key.split("::")[-1], file=fi.file,
                    line=line))
            if target_key is not None and target_key not in root_entries:
                findings.append(Finding(
                    check="conc.unregistered-thread", severity="warning",
                    message="thread target %s is not a registered "
                            "entry in analysis/threadmap.THREAD_ROOTS "
                            "— the thread map no longer covers this "
                            "plane" % target_key,
                    subject=target_key, file=fi.file, line=line))
        for line in scan.naked_joins:
            findings.append(Finding(
                check="conc.join-no-timeout", severity="warning",
                message="join() without a timeout in %s — a wedged "
                        "worker (native code cannot be interrupted) "
                        "hangs the caller forever; bound the join and "
                        "abandon, like serve/lanes.py"
                        % key.split("::")[-1],
                subject=key.split("::")[-1], file=fi.file, line=line))
        if key in root_entries:
            findings += _lint_root_body(tmap.mm, fi)
    return findings


def _lint_root_body(mm: ModuleMap, fi: FunctionInfo) -> List[Finding]:
    """Lifecycle lint applied to thread entry functions only."""
    out: List[Finding] = []
    for node in ast.walk(fi.node):
        if isinstance(node, ast.ExceptHandler):
            # queue.Empty / TimeoutError idle-poll handlers are the
            # normal shape of a timeout-driven consumer loop, not a
            # swallowed death
            tname = None
            if node.type is not None:
                tchain = _expr_chain(node.type)
                tname = tchain[-1] if tchain else None
            if tname in ("Empty", "TimeoutError", "Full"):
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue))
                   for s in node.body):
                out.append(Finding(
                    check="conc.silent-worker-death", severity="warning",
                    message="except handler in thread entry %s "
                            "swallows the exception with no counter — "
                            "a dying worker is invisible "
                            "(ipt_thread_uncaught_total is the "
                            "pattern)" % fi.name,
                    subject="%s.%s" % (fi.cls or fi.file, fi.name),
                    file=fi.file, line=node.lineno))
    # blocking queue-consumer loop without the None-sentinel discipline
    has_sentinel = any(
        isinstance(n, ast.Compare)
        and any(isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops)
        and any(isinstance(c, ast.Constant) and c.value is None
                for c in n.comparators)
        for n in ast.walk(fi.node))
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.While):
            continue
        for call in ast.walk(node):
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "get" \
                    and not call.args \
                    and not any(kw.arg == "timeout"
                                for kw in call.keywords):
                chain = _expr_chain(call.func.value)
                if chain and chain[0] == "self" and not has_sentinel:
                    out.append(Finding(
                        check="conc.no-abandon-sentinel",
                        severity="notice",
                        message="%s blocks on %s.get() with no "
                                "timeout and no None-sentinel exit — "
                                "the owner cannot abandon/replace a "
                                "wedged worker (LaneWorker discipline)"
                                % (fi.name, ".".join(chain)),
                        subject="%s.%s" % (fi.cls or fi.file, fi.name),
                        file=fi.file, line=call.lineno))
                    break
    return out


def apply_annotations(findings: List[Finding],
                      notes: Dict[Tuple[str, int], str],
                      cs: ConcScan) -> None:
    """Inline ``# concheck: ok`` suppression: a finding is suppressed
    when EVERY site that produced it is annotated (for attr findings:
    every unguarded mutating / escaping site of that subject).  An
    annotation counts when it sits on the access line or the line
    directly above it (the comment-above-the-statement style)."""
    def note_for(file: str, line: int) -> Optional[str]:
        return notes.get((file, line)) or notes.get((file, line - 1))

    site_index: Dict[str, List[Access]] = {}
    for a in cs.accesses:
        site_index.setdefault("%s.%s" % (a.owner, a.attr), []).append(a)
    for f in findings:
        if f.check == "conc.unguarded-mutation":
            sites = [a for a in site_index.get(f.subject, ())
                     if a.kind in ("assign", "augassign", "container")
                     and not a.locks and not _is_ctor(a.func)
                     and cs.tmap.roots_of(a.func)]
            keys = [(a.file, a.line) for a in sites]
        else:
            keys = [(f.file, f.line)]
        reasons = [note_for(*k) for k in keys]
        if reasons and all(r is not None for r in reasons):
            f.suppressed = True
            f.suppress_reason = reasons[0] + " (inline)"


#: default baseline shipped next to the analyzer
BASELINE_PATH = Path(__file__).resolve().parent / "concheck-baseline.json"


def run_concheck(root: Optional[Path] = None,
                 baseline_path="auto") -> Report:
    """Run the concurrency analyzer over the serve-plane sources.

    ``baseline_path="auto"`` uses analysis/concheck-baseline.json;
    ``None`` disables baseline suppression (inline annotations always
    apply — they live in the code they justify)."""
    cs = scan_concurrency(root)
    findings = check_concurrency(cs)
    apply_annotations(findings, _annotations(cs.tmap.mm), cs)
    resolved = ""
    if baseline_path == "auto":
        baseline_path = BASELINE_PATH if BASELINE_PATH.is_file() else None
    if baseline_path is not None:
        bl = Baseline.load(baseline_path)
        bl.apply([f for f in findings if not f.suppressed])
        resolved = bl.path
    n_locks = len({lid for e in cs.lock_edges for lid in e})
    return Report(
        findings=findings,
        rules_path="serve-plane",
        baseline_path=resolved,
        tool="concheck",
        meta={
            "files": sorted(cs.tmap.mm.files),
            "functions": len(cs.tmap.mm.functions),
            "thread_roots": cs.tmap.registry_json(),
            "lock_order_edges": sorted(
                "%s -> %s" % (_fmt_lock(a), _fmt_lock(b))
                for a, b in cs.lock_edges),
            "locks_in_order_graph": n_locks,
        })
