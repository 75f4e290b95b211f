"""Shared Prometheus text-exposition parser.

The fleet aggregator decodes many nodes' expositions to *merge* them,
and a lint of one node's exposition needs the same decode.  This module
is the single decode path:

* ``parse_exposition(text)`` → an :class:`Exposition` holding declared
  ``# TYPE``/``# HELP`` metadata, every sample line (name, labels,
  float value, line number), and per-line parse errors whose message
  strings are stable (promlint reports them verbatim as findings);
* ``base_name`` resolves histogram/summary component series
  (``_bucket``/``_sum``/``_count``) back to their declared family;
* ``Exposition.histogram_series`` regroups ``_bucket`` samples into
  per-labelset cumulative bucket lists — the shape both the lint's
  monotonicity check and ``Histogram.from_cumulative`` consume.

The parser never raises on malformed input: a scrape is attacker-
adjacent data (a half-written exposition from a dying node must not
take the aggregator down), so every defect becomes an ``errors`` entry
and the remaining lines still parse.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Sample",
    "Family",
    "Exposition",
    "base_name",
    "group_key",
    "parse_exposition",
]

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')
_META_RE = re.compile(
    r"^# (?P<kind>TYPE|HELP) (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\s+(?P<rest>.*))?$")

#: suffixes that resolve a series back to its declared metric family
HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def base_name(name: str, types: Dict[str, str]) -> str:
    """Resolve a series name to the declared metric it samples
    (histogram/summary components strip their suffix)."""
    if name in types:
        return name
    for suf in HIST_SUFFIXES:
        if name.endswith(suf) and name[: -len(suf)] in types:
            return name[: -len(suf)]
    return name


def group_key(labels: Dict[str, str],
              drop: Tuple[str, ...] = ("le",)) -> str:
    """Canonical labelset key (sorted ``k=v`` joined by commas, the
    dropped labels removed) — the grouping identity for histogram
    buckets and cross-node series matching."""
    return ",".join("%s=%s" % kv for kv in sorted(labels.items())
                    if kv[0] not in drop)


@dataclass
class Sample:
    """One parsed series line."""

    name: str
    labels: Dict[str, str]
    value: float
    lineno: int


@dataclass
class Family:
    """All samples of one declared metric family (or one undeclared
    series name when no ``# TYPE`` covers it)."""

    name: str
    type: str = "untyped"
    help: Optional[str] = None
    samples: List[Sample] = field(default_factory=list)


@dataclass
class Exposition:
    """Decoded scrape: metadata, samples, and non-fatal parse errors."""

    families: Dict[str, Family] = field(default_factory=dict)
    types: Dict[str, str] = field(default_factory=dict)
    helps: Dict[str, str] = field(default_factory=dict)
    samples: List[Sample] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    # ------------------------------------------------------------ views

    def family(self, name: str) -> Optional[Family]:
        return self.families.get(name)

    def value(self, name: str, **labels: str) -> Optional[float]:
        """First sample of ``name`` whose labels are a superset of the
        given ones (None when absent) — the point-read helper."""
        for s in self.samples:
            if s.name != name:
                continue
            if all(s.labels.get(k) == v for k, v in labels.items()):
                return s.value
        return None

    def counter_total(self, name: str, **labels: str) -> float:
        """Sum of every sample of ``name`` matching the label subset
        (0.0 when absent) — counters with bounded label splits roll up
        to their family total this way."""
        out = 0.0
        for s in self.samples:
            if s.name != name:
                continue
            if all(s.labels.get(k) == v for k, v in labels.items()):
                out += s.value
        return out

    def histogram_series(self, base: str) -> Dict[str, Dict]:
        """``_bucket`` samples of family ``base`` regrouped per
        non-``le`` labelset::

            {labelset_key: {"labels": {...},          # without le
                            "buckets": [(le, value)]  # sorted by le
                            "sum": float|None, "count": float|None}}

        ``le`` parses ``+Inf`` to ``math.inf``; the bucket list keeps
        whatever the node sent (the lint checks shape, the merger
        validates bounds)."""
        out: Dict[str, Dict] = {}
        for s in self.samples:
            if s.name != base + "_bucket":
                continue
            le = s.labels.get("le")
            if le is None:
                continue
            labels = {k: v for k, v in s.labels.items() if k != "le"}
            key = group_key(s.labels)
            rec = out.setdefault(
                key, {"labels": labels, "buckets": [],
                      "sum": None, "count": None})
            lev = math.inf if le == "+Inf" else float(le)
            rec["buckets"].append((lev, s.value))
        for suffix, slot in (("_sum", "sum"), ("_count", "count")):
            for s in self.samples:
                if s.name != base + suffix:
                    continue
                key = group_key(s.labels)
                if key in out:
                    out[key][slot] = s.value
        for rec in out.values():
            rec["buckets"].sort(key=lambda p: p[0])
        return out


def parse_exposition(text: str) -> Exposition:
    """Decode one text-format scrape.  Never raises: malformed lines
    land in ``Exposition.errors`` with promlint's exact finding
    strings, and every well-formed line still parses."""
    exp = Exposition()
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            m = _META_RE.match(line)
            if m is None:
                exp.errors.append("line %d: malformed comment %r"
                                  % (lineno, line[:60]))
                continue
            name = m.group("name")
            rest = (m.group("rest") or "").strip()
            if m.group("kind") == "TYPE":
                exp.types[name] = rest
            else:
                exp.helps[name] = rest
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            exp.errors.append("line %d: unparsable series line %r"
                              % (lineno, line[:60]))
            continue
        name = m.group("name")
        try:
            val = float(m.group("value"))
        except ValueError:
            exp.errors.append("line %d: %s value %r is not a float"
                              % (lineno, name, m.group("value")))
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        exp.samples.append(Sample(name, labels, val, lineno))

    # group samples into families once metadata is fully known (a
    # # TYPE line may legally follow its first sample in hand-built
    # expositions; the lint flags ordering separately)
    for s in exp.samples:
        base = base_name(s.name, exp.types)
        fam = exp.families.get(base)
        if fam is None:
            fam = Family(name=base,
                         type=exp.types.get(base, "untyped"),
                         help=exp.helps.get(base))
            exp.families[base] = fam
        fam.samples.append(s)
    # declared-but-unsampled families still appear (the aggregator
    # keeps their metadata when re-emitting)
    for name, mtype in exp.types.items():
        if name not in exp.families:
            exp.families[name] = Family(name=name, type=mtype,
                                        help=exp.helps.get(name))
    return exp
