"""Lexical directive scanner: rules tree → positioned directive stream.

The SecLang parser (compiler/seclang.py) resolves control flow while it
loads — which is exactly why it cannot *report* on it: a skipped rule
never becomes a ``Rule``, a dangling marker is silently survived.  The
analyzers instead walk this raw, position-preserving directive stream
(file + line per directive, chain structure, action dicts) and re-derive
the control/dataflow properties independently, so findings can say
*where* the problem is authored.

Reuses only the seclang lexer primitives (tokenizer, action splitter) —
the semantics under audit are re-derived here, not imported.
"""

from __future__ import annotations

import glob as _glob
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ingress_plus_tpu_torch.compiler.seclang import (
    _logical_lines_numbered,
    _parse_actions,
    _phase_key,
    _split_directive,
)


@dataclass
class Directive:
    """One logical SecLang directive with its source position."""

    kind: str                 # "SecRule" | "SecAction" | "SecMarker" | ...
    tokens: List[str]
    file: str
    line: int                 # 1-based first line of the logical line
    actions: Dict[str, List[str]] = field(default_factory=dict)

    # -- SecRule/SecAction conveniences -------------------------------
    @property
    def rule_id(self) -> int:
        try:
            return int(self.actions.get("id", ["0"])[0] or 0)
        except ValueError:
            return 0

    @property
    def phase(self) -> str:
        return _phase_key(self.actions)

    @property
    def is_chain_link_opener(self) -> bool:
        return "chain" in self.actions

    @property
    def skip_marker(self) -> Optional[str]:
        v = self.actions.get("skipAfter")
        return v[0].strip().strip("'\"") if v else None

    @property
    def setvars(self) -> List[str]:
        return [v.strip("'\"") for v in self.actions.get("setvar", []) if v]

    @property
    def targets_txt(self) -> str:
        return self.tokens[1] if self.kind == "SecRule" and \
            len(self.tokens) > 1 else ""

    @property
    def op_txt(self) -> str:
        return self.tokens[2] if self.kind == "SecRule" and \
            len(self.tokens) > 2 else ""

    def operator(self) -> Tuple[bool, str, str]:
        """(negate, operator, argument) — mirrors the parser's split."""
        op = self.op_txt
        negate = False
        if op.startswith("!@"):
            negate, op = True, op[1:]
        if op.startswith("@"):
            parts = op.split(None, 1)
            return negate, parts[0][1:], parts[1] if len(parts) > 1 else ""
        if op.startswith("!"):
            return True, "rx", op[1:]
        return negate, "rx", op


@dataclass
class FileScan:
    path: str
    directives: List[Directive]
    #: directive index of an ``Include`` → the FileScans it pulled in,
    #: in glob order — the topology the parser's skip regions follow
    #: (a region survives INTO an included file and is cleared after it)
    includes: Dict[int, List["FileScan"]] = field(default_factory=dict)


def scan_file(path: Path) -> FileScan:
    directives: List[Directive] = []
    for lineno, line in _logical_lines_numbered(path.read_text()):
        try:
            tokens = _split_directive(line)
        except ValueError:
            continue  # the parser raises on these; not this pass's job
        if not tokens:
            continue
        kind = tokens[0]
        actions: Dict[str, List[str]] = {}
        if kind == "SecRule" and len(tokens) > 3:
            actions = _parse_actions(tokens[3])
        elif kind == "SecAction" and len(tokens) > 1:
            actions = _parse_actions(tokens[1])
        directives.append(Directive(kind=kind, tokens=tokens,
                                    file=str(path), line=lineno,
                                    actions=actions))
    return FileScan(path=str(path), directives=directives)


def scan_tree(path: str | Path) -> List[FileScan]:
    """Scan a rules tree in load order: a directory scans its sorted
    ``*.conf`` files; a file is scanned and its ``Include`` directives
    followed (sorted glob expansion, cycle-proof) — the same traversal
    load_seclang_dir performs."""
    p = Path(path)
    seen: set = set()
    out: List[FileScan] = []

    def visit(conf: Path) -> "FileScan | None":
        key = str(conf.resolve())
        if key in seen or not conf.is_file():
            return None
        seen.add(key)
        fs = scan_file(conf)
        out.append(fs)
        for i, d in enumerate(fs.directives):
            if d.kind != "Include" or len(d.tokens) < 2:
                continue
            pat = d.tokens[1]
            root = Path(pat) if Path(pat).is_absolute() else conf.parent / pat
            matches = ([Path(m) for m in sorted(_glob.glob(str(root)))]
                       if any(c in pat for c in "*?[") else [root])
            for m in matches:
                child = visit(m)
                if child is not None:
                    fs.includes.setdefault(i, []).append(child)
        return fs

    if p.is_dir():
        for conf in sorted(p.glob("*.conf")):
            visit(conf)
    else:
        visit(p)
    return out


def root_scans(scans: List[FileScan]) -> List[FileScan]:
    """The load-order entry files (those not pulled in by an Include) —
    the starting points for any walk that follows the include topology."""
    included = {id(c) for fs in scans
                for children in fs.includes.values() for c in children}
    return [fs for fs in scans if id(fs) not in included]


def iter_load_order(scans: List[FileScan]):
    """Yield ``(file_scan, directive)`` in the parser's ACTUAL load
    order: entry files in sequence, descending into Include'd files at
    the Include directive's position (a flat per-file walk would order
    a parent's post-Include directives before the included ones, which
    inverts read/write order across Includes)."""
    def walk(fs: FileScan):
        for idx, d in enumerate(fs.directives):
            yield fs, d
            if d.kind == "Include":
                for child in fs.includes.get(idx, []):
                    yield from walk(child)

    for fs in root_scans(scans):
        yield from walk(fs)


def static_tx_env(scans: List[FileScan]
                  ) -> Tuple[Dict[str, str], Dict[str, Directive]]:
    """(env, conditional_writes) mirroring the parser's TX-env fold
    semantics (compiler/seclang.py): SecActions fold in load order; a
    SecRule folds when its own condition resolves statically TRUE
    against the env so far, is ignored when FALSE, and otherwise
    INVALIDATES the names it writes (request-dependent).  Chain-carried
    setvars always invalidate.  ``conditional_writes`` maps each
    request-dependently-written name to its first writing directive —
    names folded from statically-true rules are NOT in it.

    Known divergence from the parser: taken skip regions are not
    simulated here, so a setvar inside a skipped interval still
    classifies — acceptable for reporting (the reachability sweep
    re-evaluates regions itself)."""
    from ingress_plus_tpu_torch.compiler.seclang import (
        _fold_tx_assignments,
        _invalidate_tx_names,
        _static_skip_condition,
    )
    env: Dict[str, str] = {}
    cond: Dict[str, Directive] = {}
    in_chain = False
    cur_fs: Optional[FileScan] = None
    for fs, d in iter_load_order(scans):
        if fs is not cur_fs:
            cur_fs = fs
            in_chain = False   # the parser's chain state is per file
        if d.kind == "SecAction":
            _fold_tx_assignments(env, d.setvars)
            continue
        if d.kind != "SecRule":
            continue
        is_link = in_chain
        # a chain continues while each link carries "chain"
        in_chain = d.is_chain_link_opener
        if not d.setvars:
            continue
        if is_link or d.is_chain_link_opener:
            verdict = None        # conjunction: never static here
        else:
            negate, op, arg = d.operator()
            verdict = _static_skip_condition(d.targets_txt, negate,
                                             op, arg, env)
        if verdict is True:
            _fold_tx_assignments(env, d.setvars)
        elif verdict is None:
            for name in _invalidate_tx_names(env, d.setvars):
                cond.setdefault(name, d)
        # verdict False: the rule never fires — env untouched
    return env, cond


def rule_positions(scans: List[FileScan]) -> Dict[int, Tuple[str, int]]:
    """rule id → (file, line) for findings that only know the id."""
    out: Dict[int, Tuple[str, int]] = {}
    for fs in scans:
        for d in fs.directives:
            if d.kind in ("SecRule", "SecAction") and d.rule_id:
                out.setdefault(d.rule_id, (d.file, d.line))
    return out
