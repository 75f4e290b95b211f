"""Multi-window SLO burn-rate engine.

Declared objectives evaluated over CUMULATIVE good/total counters, the
way an SRE burn-rate alert consumes Prometheus counters: the engine
keeps a short time-indexed history of (good, total) samples per SLO
and computes, for each window, the windowed error rate divided by the
error budget (1 - objective).  Burn rate 1.0 means the budget spends
exactly at its sustainable pace; 14.4 (the classic page threshold)
means a 30-day budget dies in 2 days.

Two windows — fast (5m) and slow (1h) — give the standard trade:
the fast window reacts, the slow window confirms, and a *page* verdict
requires both to burn (a brief spike that already recovered stops
paging by itself).  The clock is injected so tests drive burn math
deterministically with a fake clock.

The default objectives come from the serve plane's own invariants:

* ``availability`` — share of verdicts that are neither fail-open nor
  degraded (the two paths where detection fidelity was sacrificed to
  stay up; both are first-class counters in /metrics);
* ``latency_p99`` — share of requests finishing under the p99 budget,
  measured from the e2e histogram's cumulative buckets (good = count
  at the smallest bound >= budget).

Counter resets (node restart, topology change shrinking the reachable
fleet) surface as negative deltas; windows clamp them to zero burn for
that span instead of inventing negative error rates.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["SLO", "SLOEngine", "DEFAULT_SLOS", "WINDOWS",
           "PAGE_BURN", "WARN_BURN"]

#: (window name, span seconds): fast reacts, slow confirms
WINDOWS: Tuple[Tuple[str, float], ...] = (("fast", 300.0),
                                          ("slow", 3600.0))

#: burn-rate thresholds: >= PAGE_BURN on BOTH windows pages
#: ("critical"); >= WARN_BURN on the fast window warns ("burning")
PAGE_BURN = 14.4
WARN_BURN = 1.0


@dataclass(frozen=True)
class SLO:
    """One declared objective.

    ``kind`` selects how the fleet plane derives (good, total) from
    the merged metric stream; the engine itself only sees counters.
    ``budget_us`` applies to ``kind="latency"``; ``tenant`` scopes an
    availability objective to one tenant's admission counters."""

    name: str
    kind: str                     # "availability" | "latency"
    objective: float              # target good share, e.g. 0.999
    budget_us: int = 0
    tenant: Optional[int] = None

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError("SLO %s: objective must be in (0, 1)"
                             % self.name)
        if self.kind not in ("availability", "latency"):
            raise ValueError("SLO %s: unknown kind %r"
                             % (self.name, self.kind))


DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO("availability", "availability", 0.999),
    SLO("latency_p99", "latency", 0.99, budget_us=20000),
)


class SLOEngine:
    """Burn-rate evaluation over sampled cumulative counters.

    ``observe(name, good, total)`` records one scrape's cumulative
    counts; ``burn_rates()`` reduces the history to per-window burn +
    a per-SLO verdict; ``prometheus_lines()`` renders the ``ipt_slo_*``
    series for the aggregated exposition."""

    def __init__(self, slos: Sequence[SLO] = DEFAULT_SLOS,
                 clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 4096):
        self.slos: Tuple[SLO, ...] = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO names: %r" % (names,))
        self._clock = clock
        self._max = max_samples
        #: name -> deque[(t, good, total)]
        self._hist: Dict[str, Deque[Tuple[float, float, float]]] = {
            s.name: deque(maxlen=max_samples) for s in self.slos}

    def slo(self, name: str) -> Optional[SLO]:
        for s in self.slos:
            if s.name == name:
                return s
        return None

    # ------------------------------------------------------- ingestion

    def observe(self, name: str, good: float, total: float) -> None:
        """Record one scrape of cumulative (good, total) for ``name``.
        Unknown names raise (a typo here silently disables alerting
        otherwise)."""
        dq = self._hist.get(name)
        if dq is None:
            raise KeyError("unknown SLO %r" % name)
        t = float(self._clock())
        dq.append((t, float(good), float(total)))
        # prune past the slow window (+25% slack for edge samples)
        horizon = t - WINDOWS[-1][1] * 1.25
        while len(dq) > 2 and dq[0][0] < horizon:
            dq.popleft()

    # ------------------------------------------------------ evaluation

    @staticmethod
    def _window_delta(dq: Deque[Tuple[float, float, float]],
                      t_now: float, span: float
                      ) -> Tuple[float, float, float]:
        """(delta_good, delta_total, observed_span) between the newest
        sample and the oldest sample inside the window.  Negative
        deltas (counter reset) clamp to zero."""
        t_new, g_new, n_new = dq[-1]
        base = dq[0]
        for rec in dq:
            if rec[0] >= t_now - span:
                base = rec
                break
        _t_old, g_old, n_old = base
        dg = max(g_new - g_old, 0.0)
        dn = max(n_new - n_old, 0.0)
        return dg, dn, max(t_new - base[0], 0.0)

    def burn_rates(self) -> Dict[str, Dict]:
        """Per-SLO burn summary::

            {name: {"objective": .., "kind": ..,
                    "windows": {"fast": {"burn": .., "error_rate": ..,
                                         "events": .., "span_s": ..},
                                "slow": {...}},
                    "verdict": "ok"|"burning"|"critical"|"no_data"}}

        ``burn`` is None until a window holds two samples with traffic
        between them."""
        t_now = float(self._clock())
        out: Dict[str, Dict] = {}
        for s in self.slos:
            dq = self._hist[s.name]
            windows: Dict[str, Dict] = {}
            burns: Dict[str, Optional[float]] = {}
            for wname, span in WINDOWS:
                if len(dq) < 2:
                    windows[wname] = {"burn": None, "error_rate": None,
                                      "events": 0.0, "span_s": 0.0}
                    burns[wname] = None
                    continue
                dg, dn, seen = self._window_delta(dq, t_now, span)
                if dn <= 0:
                    windows[wname] = {"burn": None, "error_rate": None,
                                      "events": 0.0, "span_s": seen}
                    burns[wname] = None
                    continue
                err = min(max(1.0 - dg / dn, 0.0), 1.0)
                burn = err / (1.0 - s.objective)
                windows[wname] = {"burn": round(burn, 4),
                                  "error_rate": round(err, 6),
                                  "events": dn,
                                  "span_s": round(seen, 3)}
                burns[wname] = burn
            fast, slow = burns.get("fast"), burns.get("slow")
            if fast is None and slow is None:
                verdict = "no_data"
            elif (fast is not None and fast >= PAGE_BURN
                    and slow is not None and slow >= PAGE_BURN):
                verdict = "critical"
            elif fast is not None and fast >= WARN_BURN:
                verdict = "burning"
            else:
                verdict = "ok"
            out[s.name] = {"objective": s.objective, "kind": s.kind,
                           "windows": windows, "verdict": verdict}
        return out

    def fleet_verdict(self) -> str:
        """Worst per-SLO verdict (ok < no_data < burning < critical) —
        the one-word fleet health answer /fleet/healthz leads with."""
        rank = {"ok": 0, "no_data": 1, "burning": 2, "critical": 3}
        worst = "ok"
        for rec in self.burn_rates().values():
            if rank[rec["verdict"]] > rank[worst]:
                worst = rec["verdict"]
        return worst

    # ------------------------------------------------------- exposition

    def prometheus_lines(self) -> List[str]:
        """``ipt_slo_*`` series (with # HELP/# TYPE headers) for the
        aggregated exposition: objective, per-window burn + error rate,
        and the numeric verdict (0 ok / 1 no_data / 2 burning /
        3 critical)."""
        rates = self.burn_rates()
        rank = {"ok": 0, "no_data": 1, "burning": 2, "critical": 3}
        lines = [
            "# HELP ipt_slo_objective declared SLO target (good share)",
            "# TYPE ipt_slo_objective gauge",
        ]
        for name, rec in sorted(rates.items()):
            lines.append('ipt_slo_objective{slo="%s"} %s'
                         % (name, rec["objective"]))
        lines += [
            "# HELP ipt_slo_burn_rate windowed error rate over the "
            "error budget (1.0 = budget spends at sustainable pace)",
            "# TYPE ipt_slo_burn_rate gauge",
        ]
        for name, rec in sorted(rates.items()):
            for wname, _span in WINDOWS:
                w = rec["windows"][wname]
                lines.append(
                    'ipt_slo_burn_rate{slo="%s",window="%s"} %s'
                    % (name, wname,
                       "NaN" if w["burn"] is None else w["burn"]))
        lines += [
            "# HELP ipt_slo_error_rate windowed bad-event share",
            "# TYPE ipt_slo_error_rate gauge",
        ]
        for name, rec in sorted(rates.items()):
            for wname, _span in WINDOWS:
                w = rec["windows"][wname]
                lines.append(
                    'ipt_slo_error_rate{slo="%s",window="%s"} %s'
                    % (name, wname,
                       "NaN" if w["error_rate"] is None
                       else w["error_rate"]))
        lines += [
            "# HELP ipt_slo_verdict per-SLO verdict (0 ok, 1 no_data, "
            "2 burning, 3 critical)",
            "# TYPE ipt_slo_verdict gauge",
        ]
        for name, rec in sorted(rates.items()):
            lines.append('ipt_slo_verdict{slo="%s"} %d'
                         % (name, rank[rec["verdict"]]))
        return lines
