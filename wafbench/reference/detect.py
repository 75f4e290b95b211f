"""Strict-syntax SQLi / XSS detectors of the reference: a frozen copy of
the Python detectors of the port's ``models/libdetect.py``
(``detect_sqli_py``, ``detect_xss_py``).  The port serves its C++ twin
of them; the reference runs these.
"""

from __future__ import annotations

import re
from typing import List, Tuple

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
