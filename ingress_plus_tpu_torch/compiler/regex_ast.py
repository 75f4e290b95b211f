"""PCRE-subset regex parser → AST over byte classes.

The reference's detection engines consume PCRE (libmodsecurity/CRS `@rx`) and
proprietary signature syntax (libproton; closed source — SURVEY.md §2.2).  We
parse the PCRE subset the CRS-shaped corpus uses into an AST of byte-level
character classes, from which factors.py extracts mandatory factors for the
TPU bitap prefilter.  Constructs an NFA cannot express (backreferences,
lookaround) raise ``RegexUnsupported`` — those rules still run, prefiltered
by whatever factors are extractable and confirmed exactly on CPU.

Supported: literals, escapes (incl. \\xHH, \\d\\D\\w\\W\\s\\S), classes with
ranges/negation/POSIX names, ``.``, alternation, groups ``(?:...)``/named/
capturing, inline flags ``(?i)``/``(?s)``/``(?m)`` (set-only), quantifiers
``* + ? {m} {m,} {m,n}`` with lazy/possessive suffixes, anchors ``^ $ \\b
\\B \\A \\z \\Z``, ``\\Q...\\E`` quoting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

ALL_BYTES = frozenset(range(256))
DOT_NO_NL = frozenset(b for b in range(256) if b != 0x0A)

_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B])

_POSIX = {
    "alpha": frozenset(list(range(0x41, 0x5B)) + list(range(0x61, 0x7B))),
    "digit": _DIGIT,
    "alnum": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) + list(range(0x61, 0x7B))),
    "upper": frozenset(range(0x41, 0x5B)),
    "lower": frozenset(range(0x61, 0x7B)),
    "space": _SPACE,
    "blank": frozenset([0x20, 0x09]),
    "punct": frozenset(b for b in range(0x21, 0x7F) if not (chr(b).isalnum())),
    "xdigit": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x47)) + list(range(0x61, 0x67))),
    "cntrl": frozenset(list(range(0x00, 0x20)) + [0x7F]),
    "print": frozenset(range(0x20, 0x7F)),
    "graph": frozenset(range(0x21, 0x7F)),
    "word": _WORD,
}


class RegexUnsupported(Exception):
    """Raised for constructs outside the NFA-expressible subset."""


# ---------------------------------------------------------------- AST nodes


@dataclass(frozen=True)
class Lit:
    """One position matching any byte in ``chars``."""

    chars: frozenset

    def __repr__(self) -> str:  # compact for debugging
        if len(self.chars) == 256:
            return "Lit(ANY)"
        if len(self.chars) <= 4:
            return "Lit(%s)" % "".join(chr(c) if 0x20 <= c < 0x7F else "\\x%02x" % c for c in sorted(self.chars))
        return "Lit(<%d bytes>)" % len(self.chars)


@dataclass(frozen=True)
class Concat:
    parts: Tuple


@dataclass(frozen=True)
class Alt:
    options: Tuple


@dataclass(frozen=True)
class Repeat:
    node: object
    min: int
    max: Optional[int]  # None = unbounded


@dataclass(frozen=True)
class Anchor:
    kind: str  # '^' '$' 'b' 'B'


@dataclass
class _Flags:
    ignorecase: bool = False
    dotall: bool = False
    multiline: bool = False

    def copy(self) -> "_Flags":
        return _Flags(self.ignorecase, self.dotall, self.multiline)


def _fold_case(chars: frozenset) -> frozenset:
    out = set(chars)
    for b in chars:
        if 0x41 <= b <= 0x5A:
            out.add(b + 0x20)
        elif 0x61 <= b <= 0x7A:
            out.add(b - 0x20)
    return frozenset(out)


# ---------------------------------------------------------------- parser


class _Parser:
    def __init__(self, pattern: str):
        self.pat = pattern
        self.i = 0
        self.n = len(pattern)
        self._pending_sets: set = set()

    def error(self, msg: str) -> RegexUnsupported:
        return RegexUnsupported("%s at %d in %r" % (msg, self.i, self.pat))

    def peek(self) -> str:
        return self.pat[self.i] if self.i < self.n else ""

    def next(self) -> str:
        if self.i >= self.n:
            raise self.error("unexpected end of pattern")
        c = self.pat[self.i]
        self.i += 1
        return c

    def eat(self, c: str) -> None:
        if self.peek() != c:
            raise self.error("expected %r" % c)
        self.i += 1

    # alternation level
    def parse_alt(self, flags: _Flags):
        options = [self.parse_concat(flags)]
        while self.peek() == "|":
            self.next()
            options.append(self.parse_concat(flags))
        if len(options) == 1:
            return options[0]
        return Alt(tuple(options))

    def parse_concat(self, flags: _Flags):
        parts = []
        while self.i < self.n and self.peek() not in "|)":
            item = self.parse_quantified(flags)
            if item is not None:
                parts.append(item)
        if not parts:
            return Concat(())
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def parse_quantified(self, flags: _Flags):
        atom = self.parse_atom(flags)
        if atom is None:
            return None
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = Repeat(atom, 0, None)
            elif c == "+":
                self.next()
                atom = Repeat(atom, 1, None)
            elif c == "?":
                self.next()
                atom = Repeat(atom, 0, 1)
            elif c == "{":
                save = self.i
                rep = self._try_brace()
                if rep is None:
                    self.i = save
                    return atom
                lo, hi = rep
                atom = Repeat(atom, lo, hi)
            else:
                return atom
            # lazy / possessive suffix — same matched language
            if self.peek() and self.peek() in "?+":
                self.next()

    def _try_brace(self) -> Optional[Tuple[int, Optional[int]]]:
        # at '{'; returns (min, max|None) or None if not a quantifier
        assert self.next() == "{"
        start = self.i
        while self.i < self.n and self.pat[self.i].isdigit():
            self.i += 1
        if self.i == start and self.peek() != ",":
            return None
        lo = int(self.pat[start : self.i]) if self.i > start else 0
        if self.peek() == "}":
            self.next()
            return (lo, lo)
        if self.peek() != ",":
            return None
        self.next()
        start = self.i
        while self.i < self.n and self.pat[self.i].isdigit():
            self.i += 1
        hi = int(self.pat[start : self.i]) if self.i > start else None
        if self.peek() != "}":
            return None
        self.next()
        return (lo, hi)

    def parse_atom(self, flags: _Flags):
        c = self.peek()
        if c == "(":
            return self.parse_group(flags)
        if c == "[":
            return Lit(self.parse_class(flags))
        if c == ".":
            self.next()
            return Lit(ALL_BYTES if flags.dotall else DOT_NO_NL)
        if c == "^":
            self.next()
            return Anchor("^")
        if c == "$":
            self.next()
            return Anchor("$")
        if c == "\\":
            return self.parse_escape(flags)
        if c in "*+?{":
            if c == "{":  # literal brace when not a quantifier
                self.next()
                return Lit(self._single(ord("{"), flags))
            raise self.error("dangling quantifier")
        self.next()
        return Lit(self._single(ord(c), flags))

    def _single(self, b: int, flags: _Flags) -> frozenset:
        s = frozenset([b])
        return _fold_case(s) if flags.ignorecase else s

    def parse_group(self, flags: _Flags):
        self.eat("(")
        inner_flags = flags.copy()
        if self.peek() == "?":
            self.next()
            c = self.peek()
            if c == ":":
                self.next()
            elif c in "=!":
                raise self.error("lookahead unsupported")
            elif c == "<":
                self.next()
                if self.peek() in "=!":
                    raise self.error("lookbehind unsupported")
                # named group (?<name>...)
                while self.peek() not in (">", ""):
                    self.next()
                self.eat(">")
            elif c == "P":
                self.next()
                if self.peek() == "<":
                    self.next()
                    while self.peek() not in (">", ""):
                        self.next()
                    self.eat(">")
                else:
                    raise self.error("(?P subgroup reference unsupported")
            elif c == ">":  # atomic group — same language
                self.next()
            elif c in "imsx-":
                on = True
                while self.peek() and self.peek() in "imsx-":
                    f = self.next()
                    if f == "-":
                        on = False
                    elif f == "i":
                        inner_flags.ignorecase = on
                    elif f == "s":
                        inner_flags.dotall = on
                    elif f == "m":
                        inner_flags.multiline = on
                    # 'x' extended mode unsupported inside; tolerate set
                if self.peek() == ")":
                    self.next()
                    # flags-to-end-of-enclosing-group: mutate caller's flags
                    flags.ignorecase = inner_flags.ignorecase
                    flags.dotall = inner_flags.dotall
                    flags.multiline = inner_flags.multiline
                    return None
                self.eat(":")
            else:
                raise self.error("unsupported group (?%s" % c)
        node = self.parse_alt(inner_flags)
        self.eat(")")
        return node

    def parse_escape(self, flags: _Flags):
        self.eat("\\")
        if self.i >= self.n:
            raise self.error("trailing backslash")
        c = self.next()
        if c.isdigit() and c != "0":
            raise self.error("backreference \\%s unsupported" % c)
        simple = {
            "n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
            "a": 0x07, "e": 0x1B, "0": 0x00,
        }
        if c in simple:
            return Lit(frozenset([simple[c]]))
        if c == "x":
            h = self.pat[self.i : self.i + 2]
            if len(h) == 2 and all(x in "0123456789abcdefABCDEF" for x in h):
                self.i += 2
                return Lit(self._single(int(h, 16), flags))
            raise self.error("bad \\x escape")
        if c == "d":
            return Lit(_DIGIT)
        if c == "D":
            return Lit(ALL_BYTES - _DIGIT)
        if c == "w":
            return Lit(_WORD)
        if c == "W":
            return Lit(ALL_BYTES - _WORD)
        if c == "s":
            return Lit(_SPACE)
        if c == "S":
            return Lit(ALL_BYTES - _SPACE)
        if c == "b":
            return Anchor("b")
        if c == "B":
            return Anchor("B")
        if c == "A":
            return Anchor("^")
        if c in ("z", "Z"):
            return Anchor("$")
        if c == "Q":  # \Q ... \E literal span
            parts = []
            while self.i < self.n:
                if self.pat[self.i] == "\\" and self.pat[self.i + 1 : self.i + 2] == "E":
                    self.i += 2
                    break
                parts.append(Lit(self._single(ord(self.next()), flags)))
            return Concat(tuple(parts)) if len(parts) != 1 else parts[0]
        if c in ("K", "G", "p", "P", "R", "X", "C", "k", "g"):
            raise self.error("\\%s unsupported" % c)
        # any other escaped char is a literal (\. \/ \\ \[ etc.)
        return Lit(self._single(ord(c), flags))

    def parse_class(self, flags: _Flags) -> frozenset:
        self.eat("[")
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        chars: set = set()
        first = True
        while True:
            if self.i >= self.n:
                raise self.error("unterminated class")
            c = self.peek()
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "[" and self.pat[self.i : self.i + 2] == "[:":
                end = self.pat.find(":]", self.i)
                if end < 0:
                    raise self.error("bad POSIX class")
                name = self.pat[self.i + 2 : end]
                if name not in _POSIX:
                    raise self.error("POSIX class %r unsupported" % name)
                chars |= _POSIX[name]
                self.i = end + 2
                continue
            lo = self._class_char()
            if lo is None:  # class-shorthand escape like \d consumed whole set
                continue
            if self.peek() == "-" and self.pat[self.i + 1 : self.i + 2] not in ("]", ""):
                self.next()
                hi = self._class_char()
                if hi is None:
                    raise self.error("bad range")
                if hi < lo:
                    raise self.error("reversed range")
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        # stash shorthand sets accumulated by _class_char
        chars |= self._pending_sets
        self._pending_sets = set()
        out = frozenset(chars)
        if flags.ignorecase:
            out = _fold_case(out)
        if negate:
            out = ALL_BYTES - out
        if not out:
            raise self.error("empty class")
        return out

    def _class_char(self) -> Optional[int]:
        c = self.next()
        if c != "\\":
            return ord(c)
        e = self.next()
        simple = {
            "n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
            "a": 0x07, "e": 0x1B, "0": 0x00, "b": 0x08,
        }
        if e in simple:
            return simple[e]
        if e == "x":
            h = self.pat[self.i : self.i + 2]
            if len(h) == 2 and all(x in "0123456789abcdefABCDEF" for x in h):
                self.i += 2
                return int(h, 16)
            raise self.error("bad \\x in class")
        sets = {"d": _DIGIT, "D": ALL_BYTES - _DIGIT, "w": _WORD,
                "W": ALL_BYTES - _WORD, "s": _SPACE, "S": ALL_BYTES - _SPACE}
        if e in sets:
            self._pending_sets |= set(sets[e])
            return None
        return ord(e)


def parse_regex(pattern: str, ignorecase: bool = False):
    """Parse ``pattern`` into an AST.  Raises RegexUnsupported."""
    p = _Parser(pattern)
    flags = _Flags(ignorecase=ignorecase)
    node = p.parse_alt(flags)
    if p.i != p.n:
        raise p.error("unbalanced )")
    return node
