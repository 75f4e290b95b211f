"""Strict-syntax SQLi / XSS detectors — the libdetection analog.

The reference optionally confirms libproton hits with wallarm/libdetection
(open-source C, separate repo): a tokenizer + per-language strict grammar
that kills false positives by requiring the payload to be *syntactically
meaningful* in the injection language (SURVEY.md §2.2).  This module is a
behavioral re-implementation in the same spirit (tokenize, then accept only
token patterns that continue/compose a SQL expression or active HTML), not
a port: the grammars are written fresh, sized to the corpus the F1 gate
uses.

Two builds of the detectors, pinned to each other by
``tests/test_torch_native_confirm.py``: the Python ones here
(``detect_sqli_py``, ``detect_xss_py``), and a C++ twin,
``csrc/libdetect.cc`` (a byte copy of the JAX package's
``native/confirm/libdetect.cc``), which ``g++`` builds at first use with
that package's Makefile flags into ``ingress_plus_tpu_torch/build/``
(``ops/cuda_build.py``) and ``ctypes`` loads.  ``detect_sqli`` and
``detect_xss`` dispatch as the JAX package does: the twin whenever its
``max_len`` window holds no NUL (``c_char_p`` data), the Python
detectors for a NUL window, and the Python detectors alone when
``IPT_NO_NATIVE_CONFIRM`` is set (read at each call; it also selects the
Python whitespace transforms over ``models/native_transforms.py``).  The
twin keeps no mutable static state, so the pooled confirm workers may
call it at once.  It is loaded with ``ctypes.PyDLL``, so a call keeps the
interpreter lock (the JAX package's ``ctypes.CDLL`` releases it): a call
lasts microseconds, and a thread that releases the lock that often waits to
take it back behind every busy Python thread of the process (the serve
plane's loop, lane and exporter threads).

:func:`run_sanitized` runs the twin under ASan and UBSan: linked with
the runner ``csrc/libdetect_check.cc`` into one executable (built at
first use, with ``native/sidecar/Makefile``'s ``SAN_ASAN`` flags), in a
process of its own, since a sanitized library would need the
sanitizer's runtime preloaded into Python.

One difference from the JAX package, on purpose: there, a missing or
unloadable library falls back to Python in silence.  Here a failed build
or load raises, with the compiler's output, unless
``IPT_NO_NATIVE_CONFIRM`` is set, so a run cannot hide which confirm
stage it ran.  ``DetectionPipeline`` builds the twin when it is
constructed (:func:`native_library`), so no request pays for the build.

``detect_sqli`` evaluates the input in three contexts (bare, breaking out
of a single-quoted string, double-quoted) like libdetection's context
automaton, and accepts on:
  - UNION/SELECT/stacked-query statement shapes
  - boolean tautology probes (value = value with OR/AND glue)
  - comment truncation after a quote-break
  - time/exfil function calls (sleep/benchmark/load_file/…)

``detect_xss`` tokenizes HTML-ish input and accepts on script-capable
constructs: script/active tags, event-handler attributes, javascript: URIs.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct
import subprocess
import tempfile
from typing import Iterable, List, Tuple

from ingress_plus_tpu_torch.ops.cuda_build import (
    CSRC,
    GXX_FLAGS,
    SAN_ASAN,
    SAN_CXXFLAGS,
    KernelLibrary,
    build_program,
)

# ------------------------------------------------------------------ SQLi

_SQL_KEYWORDS = {
    "select", "union", "insert", "update", "delete", "drop", "create",
    "alter", "truncate", "replace", "merge", "exec", "execute", "declare",
    "from", "where", "having", "group", "order", "limit", "offset", "into",
    "values", "table", "database", "and", "or", "not", "like", "between",
    "in", "is", "null", "case", "when", "then", "else", "end", "cast",
    "convert", "waitfor", "delay",
}
_SQL_FUNCTIONS = {
    "sleep", "benchmark", "pg_sleep", "load_file", "version", "user",
    "current_user", "session_user", "system_user", "database", "schema",
    "concat", "group_concat", "char", "chr", "ascii", "substring", "substr",
    "mid", "hex", "unhex", "extractvalue", "updatexml", "xp_cmdshell",
    "randomblob", "sqlite_version", "utl_inaddr", "dbms_pipe",
}

_TOKEN_RX = re.compile(
    rb"""
      (?P<ws>\s+)
    | (?P<comment>--[^\n]*|\#[^\n]*|/\*.*?(?:\*/|$))
    | (?P<str>'(?:[^'\\]|\\.|'')*'?|"(?:[^"\\]|\\.|"")*"?|`[^`]*`?)
    | (?P<hex>0x[0-9a-fA-F]+)
    | (?P<num>\d+(?:\.\d+)?)
    | (?P<word>[A-Za-z_][A-Za-z0-9_$]*)
    | (?P<op>\|\||&&|<=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|;|@@?|!|~|\^|&|\|)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize_sql(data: bytes) -> List[Tuple[str, bytes]]:
    tokens: List[Tuple[str, bytes]] = []
    i = 0
    while i < len(data) and len(tokens) < 512:
        m = _TOKEN_RX.match(data, i)
        if not m:
            i += 1  # unknown byte: skip (strict grammar tolerates noise gaps)
            continue
        i = m.end()
        kind = m.lastgroup or "ws"
        if kind == "ws":
            continue
        text = m.group(0)
        if kind == "word":
            w = text.lower().decode()
            if w in _SQL_KEYWORDS:
                kind = "kw:" + w
            elif w in _SQL_FUNCTIONS:
                kind = "fn"
        tokens.append((kind, text))
    return tokens


_VALUE_KINDS = {"str", "num", "hex", "word", "fn"}
_CMP_OPS = {b"=", b"<", b">", b"<=", b">=", b"<>", b"!=", b"like"}


def _is_value(tok: Tuple[str, bytes]) -> bool:
    return tok[0] in _VALUE_KINDS


def _no_word_run(tokens: List[Tuple[str, bytes]], lo: int, hi: int,
                 run: int = 3) -> bool:
    """True iff tokens[lo:hi] contains NO ``run`` consecutive bare words.

    The strictness test separating SQL from prose: a select-list/table
    reference is values separated by commas/operators/keywords, while
    English ("select the best option from the union of both lists") runs
    3+ unclassified words in a row.  (The earlier grammar
    accepted any co-occurrence of the keywords, which made the strict
    confirm — whose entire job is killing false positives — fire on
    ordinary sentences; wallarm/libdetection requires syntactic shape,
    so must we.)"""
    streak = 0
    for k, _ in tokens[lo:hi]:
        streak = streak + 1 if k == "word" else 0
        if streak >= run:
            return False
    return True


def _sqli_token_patterns(tokens: List[Tuple[str, bytes]]) -> bool:
    kinds = [k for k, _ in tokens]

    # UNION [ALL|DISTINCT] SELECT — structurally adjacent, not mere
    # co-occurrence.  Comments and an opening paren between the keywords
    # are the canonical obfuscations (`union/**/select`, `union(select`)
    # and stay adjacent; arbitrary prose words do not.
    for i, k in enumerate(kinds):
        if k != "kw:union":
            continue
        j = i + 1
        saw_modifier = False
        while j < len(kinds):
            kj = kinds[j]
            if kj == "comment" or (kj == "op" and tokens[j][1] == b"("):
                j += 1
                continue
            if not saw_modifier and kj == "word" and \
                    tokens[j][1].lower() in (b"all", b"distinct"):
                saw_modifier = True
                j += 1
                continue
            break
        if j < len(kinds) and kinds[j] == "kw:select":
            return True
    # SELECT <list> FROM <ref> — SQL-shaped list/ref (no prose word runs
    # within the clause or the 3 tokens after FROM), bounded gap
    for i, k in enumerate(kinds):
        if k != "kw:select":
            continue
        for j in range(i + 1, min(i + 33, len(kinds))):
            if kinds[j] == "kw:from":
                if _no_word_run(tokens, i + 1, min(j + 4, len(tokens))):
                    return True
                break
    # stacked query: ';' followed by a statement keyword
    for i, k in enumerate(kinds):
        if k == "op" and tokens[i][1] == b";":
            rest = kinds[i + 1 :]
            if any(r.startswith("kw:") and r[3:] in (
                    "select", "insert", "update", "delete", "drop", "create",
                    "alter", "exec", "execute", "declare", "truncate")
                   for r in rest[:3]):
                return True
    # boolean glue + comparison: (OR|AND) value cmp value.  Inline
    # comments are token separators in every SQL dialect
    # (OR/**/1/**/=/**/1 ≡ OR 1=1), so they are dropped before the
    # comparison-shape test — the TRUNCATION test below still sees them
    # in place (evadecheck evade.literal-fragility, corroborated by the
    # comment mutation family: /files/1/**/OR/**/1=1 escaped).
    for i, k in enumerate(kinds):
        if k in ("kw:or", "kw:and") and i + 3 <= len(tokens):
            rest = tokens[i + 1 :]
            vals = [t for t in rest if t[0] != "comment"]
            if len(vals) >= 3 and _is_value(vals[0]) and \
               vals[1][1].lower() in _CMP_OPS and _is_value(vals[2]):
                return True
            # OR 'a' / OR 1 — bare truthy value then TRUNCATION: end of
            # input, a line comment anywhere, or an inline comment that
            # ENDS the input.  A mid-expression /**/ is not truncation —
            # benign globstar queries ("src/**/lib or docs/**/api")
            # tokenize as value+comment there,
            # and real truncation semantics require the comment to eat
            # the statement tail.
            if len(rest) >= 1 and _is_value(rest[0]) and (
                    len(rest) == 1
                    or (rest[1][0] == "comment"
                        and (len(rest) == 2
                             or rest[1][1][:2] == b"--"
                             or rest[1][1][:1] == b"#"))):
                return True
    # time/exfil function call: fn '('
    for i, (k, _) in enumerate(tokens[:-1]):
        if k == "fn" and tokens[i + 1][1] == b"(":
            return True
    # tautology without glue at start: literal cmp literal (e.g. 1=1,
    # 'a'='a').  Bare words are excluded — "q=o" is a query param, not SQL.
    lits = {"str", "num", "hex"}
    if len(tokens) >= 3 and tokens[0][0] in lits and \
       tokens[1][1] in (b"=", b"<>", b"!=") and tokens[2][0] in lits:
        return True
    return False


def detect_sqli_py(data: bytes, max_len: int = 4096) -> bool:
    """Strict-grammar SQLi check in three quote contexts (pure Python)."""
    data = data[:max_len]
    if not data:
        return False
    for prefix in (b"", b"'", b'"'):
        payload = prefix + data if prefix and prefix in data else data
        tokens = _tokenize_sql(payload)
        if not tokens:
            continue
        # comment truncation straight after a quote-break: '--, '#, '/*
        if prefix and len(tokens) >= 2 and tokens[0][0] == "str" and \
           tokens[-1][0] == "comment":
            return True
        if _sqli_token_patterns(tokens):
            return True
    return False


# ------------------------------------------------------------------- XSS

_ACTIVE_TAGS = {
    b"script", b"iframe", b"embed", b"object", b"applet", b"svg", b"math",
    b"base", b"meta", b"form", b"video", b"audio", b"img", b"input",
    b"body", b"style", b"link", b"marquee", b"details", b"template",
}
_TAG_RX = re.compile(rb"<\s*(/?)\s*([a-zA-Z][a-zA-Z0-9-]*)", re.DOTALL)
_EVENT_ATTR_RX = re.compile(
    rb"\bon[a-zA-Z]{3,30}\s*=\s*[\"'`]?[^\s\"'`>]", re.DOTALL)
_JS_URI_RX = re.compile(rb"(?:javascript|vbscript)\s*:", re.IGNORECASE)
_DATA_URI_RX = re.compile(rb"data\s*:[^,]{0,60};\s*base64", re.IGNORECASE)


def detect_xss_py(data: bytes, max_len: int = 4096) -> bool:
    """Strict-ish XSS check: script-capable HTML constructs only
    (pure Python)."""
    data = data[:max_len]
    if not data:
        return False
    low = data.lower()
    for m in _TAG_RX.finditer(low):
        name = m.group(2)
        if name in _ACTIVE_TAGS:
            return True
    if _EVENT_ATTR_RX.search(low):
        # must look attribute-ish: inside a tag or with a quote near it
        return True
    if _JS_URI_RX.search(low):
        return True
    if _DATA_URI_RX.search(low):
        return True
    # entity-obfuscated script: &#x3c;script
    if b"&#" in low and b"script" in low:
        return True
    return False


# ------------------------------------------------- native dispatch (C++)

_TWIN = KernelLibrary(
    CSRC / "libdetect.cc",
    {"ipt_detect_sqli": ([ctypes.c_char_p, ctypes.c_size_t], ctypes.c_int),
     "ipt_detect_xss": ([ctypes.c_char_p, ctypes.c_size_t], ctypes.c_int)},
    init=None, compiler="g++", flags=GXX_FLAGS, hold_gil=True)


def native_library():
    """The C++ twin, built and loaded at first use (behind a lock), or
    None when ``IPT_NO_NATIVE_CONFIRM`` is set.  A failed build or load
    raises."""
    if os.environ.get("IPT_NO_NATIVE_CONFIRM"):
        return None
    return _TWIN.load()


def detect_sqli(data: bytes, max_len: int = 4096) -> bool:
    """Strict-grammar SQLi check (the C++ twin unless the window has a
    NUL or ``IPT_NO_NATIVE_CONFIRM`` is set)."""
    window = data[:max_len]  # only the scanned window matters for the guard
    lib = native_library()
    if lib is not None and b"\x00" not in window:
        # c_char_p data: a window with a NUL takes the Python path (rare:
        # the normalizers strip or replace NULs upstream)
        return bool(lib.ipt_detect_sqli(window, len(window)))
    return detect_sqli_py(data, max_len)


def detect_xss(data: bytes, max_len: int = 4096) -> bool:
    """Strict-ish XSS check (dispatched as :func:`detect_sqli`)."""
    window = data[:max_len]
    lib = native_library()
    if lib is not None and b"\x00" not in window:
        return bool(lib.ipt_detect_xss(window, len(window)))
    return detect_xss_py(data, max_len)


# ------------------------------------------- the twin under ASan + UBSan

#: UBSan stops at its first report (ASan always does), so a report also
#: fails the exit code
SANITIZER_ENV = {"UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}


def sanitized_binary():
    """The twin and its runner linked into one ASan + UBSan executable
    (built once per source hash into the port's build directory)."""
    return build_program([CSRC / "libdetect_check.cc", CSRC / "libdetect.cc"],
                         SAN_CXXFLAGS + SAN_ASAN)


def run_sanitized(strings: Iterable[bytes], timeout: float = 300.0
                  ) -> Tuple[List[Tuple[bool, bool]], str, int]:
    """Each of ``strings`` (NULs and all, any length) through the
    sanitized twin: ([(sqli, xss)] per string as far as the runner got,
    its stderr, its exit code).  The caller reads the sanitizer reports
    off stderr."""
    proc = run_framed(sanitized_binary(), strings, timeout)
    bits = [(line[:1] == b"1", line[1:2] == b"1")
            for line in proc.stdout.splitlines()]
    return bits, proc.stderr.decode(errors="replace"), proc.returncode


def run_framed(binary, strings: Iterable[bytes], timeout: float
               ) -> subprocess.CompletedProcess:
    """Run a sanitized runner on one input file of ``strings``, each a
    4-byte little-endian length and its bytes, with
    :data:`SANITIZER_ENV`; its stdout and stderr are captured."""
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        for data in strings:
            f.write(struct.pack("<I", len(data)) + data)
        f.flush()
        return subprocess.run([str(binary), f.name], capture_output=True,
                              timeout=timeout,
                              env={**os.environ, **SANITIZER_ENV})
