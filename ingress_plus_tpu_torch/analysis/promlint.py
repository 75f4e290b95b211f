"""Prometheus exposition hygiene lint.

The /metrics exposition is hand-rolled; this lint holds it to the
conventions scrapers and dashboards assume.  It decodes one text-format scrape (via the shared
``utils/promparse`` parser — the same decode path the fleet
aggregator merges through, so what the lint accepts is exactly what
the fleet plane can aggregate) and enforces:

* **naming** — every metric carries the ``ipt_`` namespace prefix;
  counters end in ``_total`` (or ``_sum``/``_count`` — the cumulative
  microsecond counters like ``ipt_batch_us_sum`` predate this lint and
  follow the histogram-component convention);
* **metadata** — every emitted series has a ``# TYPE`` line, and every
  ``# TYPE`` a ``# HELP`` (the serve loop guarantees the pair via
  ``server._with_help``; the lint guards hand-added lines that bypass
  it);
* **bounded cardinality** — no label (other than ``le``) may exceed
  ``series_cap`` distinct values: the ``bounded_counter_series``
  budget is 30 + the "other" fold, so a per-rule or per-tenant series
  slipping into the exposition unfolded fails on its FIRST scrape, not
  after a dashboard dies;
* **aggregation safety** — counters and gauges must be
  summable across instances: a node-unique label (``instance``,
  ``host``, ``pid``, ...) on a per-node exposition makes the fleet
  sum double-count identity instead of traffic.  ``fleet=True``
  relaxes the check for the labels the aggregator itself adds
  deliberately (``node=`` per-node detail, ``agg=`` rollups — bounded
  by fleet size, which the cardinality cap still polices);
* **histogram shape** — ``_bucket`` series carry ``le``, include
  ``+Inf``, and the cumulative counts are monotonic;
* **values parse** — every sample value is a float (NaN allowed: the
  efficiency gauges are NaN until the first dispatch by design).

``check_exposition`` returns finding strings (empty = clean).
``chip_smoke.py`` runs it on a card server's ``/metrics`` after real
traffic, so the tenant/family folds are actually exercised, and
(``fleet=True``) on the fleet observer's aggregated ``/fleet/metrics``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Set, Tuple

from ingress_plus_tpu_torch.utils.promparse import (
    base_name, group_key, parse_exposition)

#: bounded_counter_series caps at 30 verbatim + "other"; lanes and
#: stages are small closed sets.  Anything past this is an unbounded
#: label escaping the budget.
DEFAULT_SERIES_CAP = 40

#: counter naming: _total is the convention; _sum/_count are accepted
#: for cumulative histogram-component counters (documented above)
_COUNTER_SUFFIXES = ("_total", "_sum", "_count")

#: labels that identify the emitting node rather than the traffic —
#: a counter/gauge split on one cannot be summed across the fleet
NODE_IDENTITY_LABELS = ("instance", "node", "host", "hostname",
                       "pod", "pid")

#: labels the fleet aggregator adds on purpose (per-node detail +
#: rollup axis); only legitimate on the AGGREGATED exposition
_FLEET_LABELS = ("node", "agg")


def check_exposition(text: str,
                     prefix: str = "ipt_",
                     series_cap: int = DEFAULT_SERIES_CAP,
                     fleet: bool = False) -> List[str]:
    exp = parse_exposition(text)
    findings: List[str] = list(exp.errors)
    types = exp.types
    helps = set(exp.helps)
    #: (metric, label) -> distinct values
    label_values: Dict[Tuple[str, str], Set[str]] = {}
    #: histogram buckets: (metric, non-le labelset) -> [(le, value)]
    buckets: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    seen_series: Set[str] = set()

    for s in exp.samples:
        seen_series.add(s.name)
        base = base_name(s.name, types)
        for k, v in s.labels.items():
            if k == "le":
                continue
            label_values.setdefault((base, k), set()).add(v)
        if s.name.endswith("_bucket"):
            le = s.labels.get("le")
            if le is None:
                findings.append("line %d: %s has no le label"
                                % (s.lineno, s.name))
            else:
                key = (base, group_key(s.labels))
                lev = math.inf if le == "+Inf" else float(le)
                buckets.setdefault(key, []).append((lev, s.value))

    # naming + metadata per declared or sampled metric family
    for name in sorted(seen_series):
        base = base_name(name, types)
        if not name.startswith(prefix):
            findings.append("%s: missing the %s namespace prefix"
                            % (name, prefix))
        if base not in types:
            findings.append("%s: series has no # TYPE line" % name)
    for base, mtype in sorted(types.items()):
        if base not in helps:
            findings.append("%s: # TYPE without # HELP" % base)
        if mtype == "counter" and not base.endswith(_COUNTER_SUFFIXES):
            findings.append(
                "%s: TYPE counter but name lacks a _total/_sum/_count "
                "suffix" % base)

    # bounded cardinality: the first offender is the finding (the gate
    # fails fast — an unbounded per-rule/per-tenant series is a scrape
    # bomb, not a style nit)
    for (base, label), values in sorted(label_values.items()):
        if len(values) > series_cap:
            findings.append(
                "%s{%s=}: %d distinct label values (cap %d) — an "
                "unbounded series escaped the bounded_counter_series "
                "fold" % (base, label, len(values), series_cap))

    # aggregation safety: counters/gauges keyed by node
    # identity cannot be summed across the fleet — the merge would
    # count nodes, not traffic.  Histograms are exempt (their le axis
    # merges bucket-wise); the aggregator's own node=/agg= labels are
    # legitimate only on the aggregated exposition (fleet=True).
    for (base, label), _values in sorted(label_values.items()):
        if label not in NODE_IDENTITY_LABELS:
            continue
        if fleet and label in _FLEET_LABELS:
            continue
        if types.get(base) == "histogram":
            continue
        findings.append(
            "%s{%s=}: node-identity label breaks cross-instance "
            "aggregation (counters/gauges must be summable across "
            "the fleet)" % (base, label))

    # histogram shape: +Inf present, cumulative counts monotonic
    for (base, labelset), pts in sorted(buckets.items()):
        pts.sort(key=lambda p: p[0])
        if not pts or pts[-1][0] != math.inf:
            findings.append("%s{%s}: histogram without a +Inf bucket"
                            % (base, labelset))
        vals = [v for _, v in pts]
        if any(b < a for a, b in zip(vals, vals[1:])):
            findings.append("%s{%s}: non-monotonic cumulative bucket "
                            "counts" % (base, labelset))
    return findings
