"""Fleet telemetry plane: scrape, merge, judge.

Every serve node's observability surface is per-process.
``FleetObserver`` is the layer that aggregates: a node registry + resilient scraper
over the per-node HTTP surfaces (``/metrics``, ``/healthz``,
``/rules/stats?format=profile``, ``/rules/drift``), aggregation with
per-kind semantics, and an SLO burn-rate engine on top of the merged
stream.  The shape mirrors the reference's postanalytics rollup (per-
node WAF telemetry merges before any cluster decision) and the
per-device→pool aggregation of the parallel-firewall decomposition
(arXiv:1312.4188).

Aggregation semantics (docs/OBSERVABILITY.md "Fleet telemetry"):

=============  =========================================================
metric kind    fleet semantics
=============  =========================================================
counter        SUM over reachable nodes — conservation guaranteed:
               the fleet value equals Σ per-node values by
               construction, and the fault matrix asserts it against
               independently counted traffic
histogram      bucket-wise merge (``Histogram.merge``) — lossless
               because every node shares the fixed log2 bounds; a
               bounds mismatch is a *skew finding*, never a crash
gauge          min/max/mean rollup (``agg=`` label) + per-node detail
               (``node=`` label, emitted while the fleet is small
               enough to stay inside the cardinality budget)
info joints    value-1 label carriers (``*_info``) re-keyed as
               node-counts per label tuple and cross-checked: a node
               serving a stale pack generation is a first-class
               skew finding
=============  =========================================================

A node that fails its scrape is marked down (and *stale* if we ever
reached it), excluded from every rollup — conservation then holds
over the reachable subset, which the fault-matrix ``fleet_scrape``
scenario pins.  Skew findings cover generation skew, per-node e2e p99
outliers, and confirm-share outliers.

The aggregator serves ``/fleet/metrics``, ``/fleet/healthz``,
``/fleet/drift``, ``/fleet/slo``, and ``/fleet/profile`` (the merged
``MeasuredProfile`` canonical bytes — the artifact the continuous-
retune daemon consumes).  Transport is pluggable: real nodes scrape
over urllib HTTP; in-process ServeLoops (the fault matrix, tests) scrape
through ``ServeLoop.http_get`` with zero sockets.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ingress_plus_tpu_torch.compiler.profile import (
    MeasuredProfile, ProfileVersionError)
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils import promparse
from ingress_plus_tpu_torch.utils.slo import DEFAULT_SLOS, SLO, SLOEngine
from ingress_plus_tpu_torch.utils.trace import Histogram

__all__ = ["FleetObserver", "Node", "ScrapeError", "fetch_http"]

#: per-node detail gauges carry a node= label only while the fleet is
#: small enough to stay inside promlint's cardinality budget
MAX_NODE_DETAIL = 32

#: scrape paths pulled per node per cycle (one failure fails the node's
#: whole cycle — a half-scraped node is skew, not data)
SCRAPE_PATHS = ("/metrics", "/healthz", "/rules/stats?format=profile",
                "/rules/drift")

#: p99 outlier: a node pages when its e2e p99 exceeds the fleet median
#: by this factor AND by an absolute floor (a 3µs-vs-1µs "outlier" on
#: an idle fleet is noise, not skew)
P99_OUTLIER_FACTOR = 2.0
P99_OUTLIER_FLOOR_US = 1000.0

#: confirm-share outlier: flag a node whose confirm share of stage time
#: exceeds the fleet median by both this factor and absolute margin
CONFIRM_SHARE_FACTOR = 1.5
CONFIRM_SHARE_MARGIN = 0.10


class ScrapeError(RuntimeError):
    """One node's scrape cycle failed (transport error, non-2xx,
    injected fault) — the node goes down/stale, the cycle continues."""


# transport: (node, path) -> body bytes, raising ScrapeError on failure
Transport = Callable[[str], bytes]


def fetch_http(target: str, timeout_s: float = 3.0) -> Transport:
    """Default transport: GET http://target/path with a hard timeout."""
    import urllib.error
    import urllib.request

    def _fetch(path: str) -> bytes:
        url = "http://%s%s" % (target, path)
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as r:
                if not 200 <= r.status < 300:
                    raise ScrapeError("%s -> HTTP %d" % (url, r.status))
                return r.read()
        except ScrapeError:
            raise
        except Exception as e:
            raise ScrapeError("%s: %s" % (url, e)) from e
    return _fetch


def serve_loop_transport(serve) -> Transport:
    """In-process transport over ``ServeLoop.http_get`` — the zero-
    socket path fleetgate and the tests scrape through."""
    def _fetch(path: str) -> bytes:
        status, _ctype, body = serve.http_get(path)
        if not status.startswith("2"):
            raise ScrapeError("%s -> %s" % (path, status))
        return body
    return _fetch


@dataclass
class Node:
    """Registry entry + last-scrape state for one serve process."""

    name: str
    target: str = ""                  # host:port ("" = custom transport)
    transport: Optional[Transport] = None
    up: bool = False
    stale: bool = False               # reached before, unreachable now
    error: str = ""
    scrapes: int = 0
    failures: int = 0
    scrape_ms: float = 0.0
    exposition: Optional[promparse.Exposition] = None
    healthz: Dict = field(default_factory=dict)
    profile: Optional[MeasuredProfile] = None
    profile_raw: bytes = b""
    drift: Dict = field(default_factory=dict)

    def fetch(self, path: str) -> bytes:
        t = self.transport or fetch_http(self.target)
        return t(path)


class FleetObserver:
    """The aggregator: scrape every registered node, merge per metric
    kind, cross-check generations, feed the SLO engine, and serve the
    ``/fleet/*`` surfaces."""

    def __init__(self, slos: Tuple[SLO, ...] = DEFAULT_SLOS,
                 clock: Callable[[], float] = time.monotonic,
                 latency_stage: str = "e2e",
                 node_timeout_s: float = 5.0,
                 cycle_timeout_s: float = 15.0):
        self.nodes: List[Node] = []
        #: per-node scrape budget / whole-cycle bound: a
        #: node past its budget goes stale exactly like a refused one
        self.node_timeout_s = node_timeout_s
        self.cycle_timeout_s = cycle_timeout_s
        self.slo_engine = SLOEngine(slos, clock=clock)
        self.latency_stage = latency_stage
        self.scrape_cycles = 0
        self.scrape_errors = 0
        self._lock = threading.Lock()
        self._agg_lines: List[str] = []
        self._skew: List[Dict] = []
        self._counters: Dict[str, float] = {}
        self._per_node_counters: Dict[str, Dict[str, float]] = {}
        self._merged_profile: Optional[MeasuredProfile] = None
        self._profile_error: str = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd = None

    # -------------------------------------------------------- registry

    def add_node(self, name: str, target: str = "",
                 transport: Optional[Transport] = None) -> Node:
        if any(n.name == name for n in self.nodes):
            raise ValueError("duplicate node name %r" % name)
        if not target and transport is None:
            raise ValueError("node %r needs a target or a transport"
                             % name)
        node = Node(name=name, target=target, transport=transport)
        self.nodes.append(node)
        return node

    # -------------------------------------------------------- scraping

    @staticmethod
    def _fetch_node(node: Node) -> Dict[str, bytes]:
        """Pure fetch of every scrape path (worker thread).  Mutates
        NOTHING — a fetch abandoned past its budget can complete late
        without tearing node state a later cycle already rewrote."""
        return {"metrics": node.fetch("/metrics"),
                "healthz": node.fetch("/healthz"),
                "profile": node.fetch("/rules/stats?format=profile"),
                "drift": node.fetch("/rules/drift")}

    @staticmethod
    def _apply_node(node: Node, res: Dict[str, bytes],
                    ms: float) -> None:
        """Parse + install one node's fetched payloads (cycle thread)."""
        node.exposition = promparse.parse_exposition(
            res["metrics"].decode("utf-8", "replace"))
        try:
            node.healthz = json.loads(res["healthz"])
        except ValueError:
            node.healthz = {}
        node.profile_raw = res["profile"]
        try:
            node.profile = MeasuredProfile.from_json(
                res["profile"].decode("utf-8", "replace"))
        except (ValueError, KeyError):
            node.profile = None
        try:
            node.drift = json.loads(res["drift"])
        except ValueError:
            node.drift = {}
        node.scrape_ms = round(ms, 3)

    def scrape(self) -> Dict:
        """One scrape cycle over the registry, then re-aggregate and
        feed the SLO engine.  Node fetches run CONCURRENTLY, each with
        its own timeout budget, and the whole cycle is bounded — one
        hung node costs its own sample, never its siblings'.
        Fault sites still fire on the cycle thread in node order, so a
        seeded plan replays deterministically; stale accounting is
        unchanged.  Never raises on a node failure."""
        import concurrent.futures as cf

        deadline = time.monotonic() + self.cycle_timeout_s
        ex = cf.ThreadPoolExecutor(
            max_workers=max(1, min(len(self.nodes) or 1, 8)),
            thread_name_prefix="fleet-scrape")
        started: Dict[str, float] = {}
        futs: Dict[str, "cf.Future"] = {}
        injected: Dict[str, Exception] = {}
        for node in self.nodes:
            node.scrapes += 1
            try:
                # fault sites (utils/faults.py): every shape of scrape
                # failure, armed per node-scrape arrival so plans can
                # target the Nth node of the Nth cycle deterministically
                if faults.fire("scrape_timeout"):
                    raise ScrapeError("injected scrape timeout")
                if faults.fire("scrape_5xx"):
                    raise ScrapeError("injected scrape 5xx")
                if faults.fire("node_partition"):
                    raise ScrapeError("injected node partition")
            except ScrapeError as e:
                injected[node.name] = e
                continue
            started[node.name] = time.perf_counter()
            futs[node.name] = ex.submit(self._fetch_node, node)
        for node in self.nodes:
            err: Optional[Exception] = injected.get(node.name)
            if err is None:
                fut = futs.get(node.name)
                if fut is None:
                    continue
                budget = min(self.node_timeout_s,
                             max(0.0, deadline - time.monotonic()))
                try:
                    res = fut.result(timeout=budget)
                    self._apply_node(
                        node, res,
                        (time.perf_counter() - started[node.name]) * 1e3)
                    node.up = True
                    node.stale = False
                    node.error = ""
                    continue
                except cf.TimeoutError:
                    err = ScrapeError(
                        "scrape budget exceeded (%.1fs)" % budget)
                except Exception as e:   # noqa: BLE001 — resilience is
                    # the contract: one dying node must not stop the cycle
                    err = e
            node.failures += 1
            node.stale = node.up or node.stale
            node.up = False
            node.error = str(err)
            self.scrape_errors += 1
        ex.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            self.scrape_cycles += 1
            self._aggregate()
            self._feed_slos()
        return self.healthz()

    # ----------------------------------------------------- aggregation

    def _reachable(self) -> List[Node]:
        return [n for n in self.nodes
                if n.up and n.exposition is not None]

    def _aggregate(self) -> None:
        """Rebuild the aggregated exposition + skew findings from the
        last scrape of every reachable node.  Caller holds the lock."""
        nodes = self._reachable()
        skew: List[Dict] = []
        lines: List[str] = []
        counters: Dict[str, float] = {}
        per_node: Dict[str, Dict[str, float]] = {}

        # union of families over reachable nodes, deterministic order
        fam_names: List[str] = sorted(
            {name for n in nodes for name in n.exposition.families})
        for fname in fam_names:
            ftype = "untyped"
            fhelp = None
            for n in nodes:
                fam = n.exposition.families.get(fname)
                if fam is None:
                    continue
                if fam.type != "untyped":
                    ftype = fam.type
                if fhelp is None and fam.help:
                    fhelp = fam.help
            if ftype == "histogram":
                lines += self._merge_histogram(fname, fhelp, nodes, skew)
            elif ftype == "counter":
                lines += self._merge_counter(fname, fhelp, nodes,
                                             counters, per_node)
            else:
                lines += self._merge_gauge(fname, ftype, fhelp, nodes)

        lines += self._self_series()
        skew += self._generation_skew(nodes)
        skew += self._latency_skew(nodes)
        skew += self._confirm_share_skew(nodes)
        self._merge_profiles(nodes)

        self._agg_lines = lines
        self._skew = skew
        self._counters = counters
        self._per_node_counters = per_node

    @staticmethod
    def _fmt(v: float) -> str:
        if math.isnan(v):
            return "NaN"
        if float(v).is_integer() and abs(v) < 1e15:
            return "%d" % int(v)
        return repr(round(v, 9))

    def _merge_counter(self, fname: str, fhelp: Optional[str],
                       nodes: List[Node], counters: Dict[str, float],
                       per_node: Dict[str, Dict[str, float]]
                       ) -> List[str]:
        """SUM per labelset over reachable nodes — conservation by
        construction, with the per-node addends kept for the bench and
        gate to audit independently."""
        sums: Dict[str, Tuple[Dict[str, str], float]] = {}
        for n in nodes:
            fam = n.exposition.families.get(fname)
            if fam is None:
                continue
            node_total = 0.0
            for s in fam.samples:
                key = "%s|%s" % (s.name, promparse.group_key(s.labels))
                labels, cur = sums.get(key, (s.labels, 0.0))
                sums[key] = (labels, cur + s.value)
                node_total += s.value
            per_node.setdefault(fname, {})[n.name] = node_total
        counters[fname] = sum(v for _l, v in sums.values())
        if not sums:
            return []
        lines = ["# HELP %s %s" % (fname, fhelp or "fleet sum"),
                 "# TYPE %s counter" % fname]
        for key in sorted(sums):
            labels, val = sums[key]
            name = key.split("|", 1)[0]
            lab = "".join('%s="%s",' % kv
                          for kv in sorted(labels.items()))
            lines.append("%s%s %s"
                         % (name,
                            ("{%s}" % lab.rstrip(",")) if lab else "",
                            self._fmt(val)))
        return lines

    def _merge_histogram(self, fname: str, fhelp: Optional[str],
                         nodes: List[Node], skew: List[Dict]
                         ) -> List[str]:
        """Bucket-wise merge per labelset via Histogram.merge; a bounds
        mismatch books a skew finding and skips that labelset."""
        groups: Dict[str, List[Tuple[str, Dict]]] = {}
        for n in nodes:
            for key, rec in n.exposition.histogram_series(fname).items():
                groups.setdefault(key, []).append((n.name, rec))
        if not groups:
            return []
        lines = ["# HELP %s %s" % (fname, fhelp or "fleet merge"),
                 "# TYPE %s histogram" % fname]
        for key in sorted(groups):
            hists = []
            labels: Dict[str, str] = {}
            bad = False
            for node_name, rec in groups[key]:
                labels = rec["labels"]
                pts = rec["buckets"]
                if not pts or pts[-1][0] != math.inf:
                    bad = True
                    skew.append({
                        "kind": "histogram_shape", "node": node_name,
                        "detail": "%s{%s}: no +Inf bucket"
                                  % (fname, key)})
                    continue
                bounds = [int(le) for le, _v in pts[:-1]]
                try:
                    hists.append(Histogram.from_cumulative(
                        bounds, [v for _le, v in pts],
                        rec["sum"] or 0))
                except ValueError as e:
                    bad = True
                    skew.append({
                        "kind": "histogram_shape", "node": node_name,
                        "detail": "%s{%s}: %s" % (fname, key, e)})
            if not hists:
                continue
            try:
                merged = Histogram.merge(hists)
            except ValueError as e:
                skew.append({"kind": "histogram_bounds_mismatch",
                             "node": "*",
                             "detail": "%s{%s}: %s" % (fname, key, e)})
                continue
            if bad and not hists:
                continue
            lines += merged.prometheus(fname, labels or None)
        return lines

    def _merge_gauge(self, fname: str, ftype: str,
                     fhelp: Optional[str], nodes: List[Node]
                     ) -> List[str]:
        """min/max/mean rollup (+ per-node detail while small); info
        joints (``*_info``) become node-counts per label tuple."""
        if fname.endswith("_info"):
            return self._merge_info(fname, fhelp, nodes)
        groups: Dict[str, List[Tuple[str, Dict[str, str], float]]] = {}
        for n in nodes:
            fam = n.exposition.families.get(fname)
            if fam is None:
                continue
            for s in fam.samples:
                key = "%s|%s" % (s.name, promparse.group_key(s.labels))
                groups.setdefault(key, []).append(
                    (n.name, s.labels, s.value))
        if not groups:
            return []
        lines = ["# HELP %s %s" % (fname, fhelp or "fleet rollup"),
                 "# TYPE %s gauge" % fname]
        detail = len(nodes) <= MAX_NODE_DETAIL
        for key in sorted(groups):
            rows = groups[key]
            name = key.split("|", 1)[0]
            labels = rows[0][1]
            vals = [v for _n, _l, v in rows if not math.isnan(v)]
            base = "".join('%s="%s",' % kv
                           for kv in sorted(labels.items()))
            for agg, val in (("min", min(vals) if vals else math.nan),
                             ("max", max(vals) if vals else math.nan),
                             ("mean", (sum(vals) / len(vals))
                              if vals else math.nan)):
                lines.append('%s{%sagg="%s"} %s'
                             % (name, base, agg, self._fmt(val)))
            if detail:
                for node_name, _l, v in sorted(rows):
                    lines.append('%s{%snode="%s"} %s'
                                 % (name, base, node_name,
                                    self._fmt(v)))
        return lines

    def _merge_info(self, fname: str, fhelp: Optional[str],
                    nodes: List[Node]) -> List[str]:
        counts: Dict[str, Tuple[Dict[str, str], int]] = {}
        for n in nodes:
            fam = n.exposition.families.get(fname)
            if fam is None:
                continue
            for s in fam.samples:
                key = promparse.group_key(s.labels)
                labels, c = counts.get(key, (s.labels, 0))
                counts[key] = (labels, c + 1)
        if not counts:
            return []
        lines = ["# HELP %s %s (fleet: value = nodes serving this "
                 "label tuple)" % (fname, fhelp or "info joint"),
                 "# TYPE %s gauge" % fname]
        for key in sorted(counts):
            labels, c = counts[key]
            lab = "".join('%s="%s",' % kv
                          for kv in sorted(labels.items()))
            lines.append("%s%s %d"
                         % (fname,
                            ("{%s}" % lab.rstrip(",")) if lab else "",
                            c))
        return lines

    def _self_series(self) -> List[str]:
        """The aggregator's own health metrics."""
        up = sum(1 for n in self.nodes if n.up)
        stale = sum(1 for n in self.nodes if n.stale)
        return [
            "# HELP ipt_fleet_nodes registered fleet nodes",
            "# TYPE ipt_fleet_nodes gauge",
            "ipt_fleet_nodes %d" % len(self.nodes),
            "# HELP ipt_fleet_nodes_up nodes reachable at last scrape",
            "# TYPE ipt_fleet_nodes_up gauge",
            "ipt_fleet_nodes_up %d" % up,
            "# HELP ipt_fleet_nodes_stale nodes reached before but "
            "unreachable now (excluded from every rollup)",
            "# TYPE ipt_fleet_nodes_stale gauge",
            "ipt_fleet_nodes_stale %d" % stale,
            "# HELP ipt_fleet_scrape_cycles_total completed scrape "
            "cycles",
            "# TYPE ipt_fleet_scrape_cycles_total counter",
            "ipt_fleet_scrape_cycles_total %d" % self.scrape_cycles,
            "# HELP ipt_fleet_scrape_errors_total node scrapes that "
            "failed",
            "# TYPE ipt_fleet_scrape_errors_total counter",
            "ipt_fleet_scrape_errors_total %d" % self.scrape_errors,
        ]

    # ---------------------------------------------------- skew findings

    def _generation_skew(self, nodes: List[Node]) -> List[Dict]:
        """Cross-check ``ipt_ruleset_info`` version labels: nodes off
        the majority generation are skew (the exact condition a fleet
        rollout must converge away)."""
        versions: Dict[str, List[str]] = {}
        for n in nodes:
            v = n.exposition.value("ipt_ruleset_info")
            fam = n.exposition.families.get("ipt_ruleset_info")
            ver = ""
            if fam is not None and fam.samples:
                ver = fam.samples[0].labels.get("version", "")
            if v is not None and ver:
                versions.setdefault(ver, []).append(n.name)
        if len(versions) <= 1:
            return []
        majority = max(sorted(versions),
                       key=lambda v: (len(versions[v]), v))
        out = []
        for ver in sorted(versions):
            if ver == majority:
                continue
            for name in sorted(versions[ver]):
                out.append({
                    "kind": "generation_skew", "node": name,
                    "generation": ver,
                    "detail": "serving pack generation %r; fleet "
                              "majority is %r" % (ver, majority)})
        return out

    def _node_p99(self, n: Node) -> Optional[float]:
        series = n.exposition.histogram_series("ipt_stage_us")
        for rec in series.values():
            if rec["labels"].get("stage") != self.latency_stage:
                continue
            pts = rec["buckets"]
            if not pts or pts[-1][0] != math.inf or pts[-1][1] <= 0:
                return None
            bounds = [int(le) for le, _v in pts[:-1]]
            try:
                h = Histogram.from_cumulative(
                    bounds, [v for _le, v in pts], rec["sum"] or 0)
            except ValueError:
                return None
            return h.percentile(0.99)
        return None

    def _latency_skew(self, nodes: List[Node]) -> List[Dict]:
        p99s = [(n.name, self._node_p99(n)) for n in nodes]
        p99s = [(name, v) for name, v in p99s if v is not None]
        if len(p99s) < 3:
            return []
        med = sorted(v for _n, v in p99s)[len(p99s) // 2]
        out = []
        for name, v in sorted(p99s):
            if (v > med * P99_OUTLIER_FACTOR
                    and v - med > P99_OUTLIER_FLOOR_US):
                out.append({
                    "kind": "p99_outlier", "node": name,
                    "detail": "e2e p99 %.0fus vs fleet median %.0fus"
                              % (v, med)})
        return out

    @staticmethod
    def _confirm_share(n: Node) -> Optional[float]:
        exp = n.exposition
        parts = [exp.value("ipt_prep_us_sum"),
                 exp.value("ipt_engine_us_sum"),
                 exp.value("ipt_confirm_us_sum")]
        if any(p is None for p in parts):
            return None
        total = sum(parts)
        if total <= 0:
            return None
        return parts[2] / total

    def _confirm_share_skew(self, nodes: List[Node]) -> List[Dict]:
        shares = [(n.name, self._confirm_share(n)) for n in nodes]
        shares = [(name, v) for name, v in shares if v is not None]
        if len(shares) < 3:
            return []
        med = sorted(v for _n, v in shares)[len(shares) // 2]
        out = []
        for name, v in sorted(shares):
            if (v > med * CONFIRM_SHARE_FACTOR
                    and v - med > CONFIRM_SHARE_MARGIN):
                out.append({
                    "kind": "confirm_share_outlier", "node": name,
                    "detail": "confirm share %.2f vs fleet median %.2f"
                              % (v, med)})
        return out

    # ------------------------------------------------- profile merging

    def _merge_profiles(self, nodes: List[Node]) -> None:
        profs = [n.profile for n in nodes if n.profile is not None]
        if not profs:
            self._merged_profile = None
            self._profile_error = "no node profiles scraped"
            return
        try:
            self._merged_profile = MeasuredProfile.merge(profs)
            self._profile_error = ""
        except (ProfileVersionError, ValueError) as e:
            self._merged_profile = None
            self._profile_error = str(e)

    # ------------------------------------------------------ SLO feeding

    def _feed_slos(self) -> None:
        """Derive cumulative (good, total) per declared SLO from the
        merged counters and histogram and feed the engine.  Caller
        holds the lock."""
        nodes = self._reachable()
        req = self._counters.get("ipt_requests_total", 0.0)
        fail_open = self._counters.get("ipt_fail_open_total", 0.0)
        degraded = self._counters.get("ipt_degraded_verdicts_total",
                                      0.0)
        for s in self.slo_engine.slos:
            if s.kind == "availability" and s.tenant is None:
                good = max(req - fail_open - degraded, 0.0)
                self.slo_engine.observe(s.name, good, req)
            elif s.kind == "availability":
                good = total = 0.0
                for n in nodes:
                    t = n.exposition.counter_total(
                        "ipt_tenant_requests_total",
                        tenant=str(s.tenant))
                    d = n.exposition.counter_total(
                        "ipt_tenant_degraded_total",
                        tenant=str(s.tenant))
                    total += t
                    good += max(t - d, 0.0)
                self.slo_engine.observe(s.name, good, total)
            elif s.kind == "latency":
                good, total = self._latency_counts(nodes, s.budget_us)
                self.slo_engine.observe(s.name, good, total)

    def _latency_counts(self, nodes: List[Node], budget_us: int
                        ) -> Tuple[float, float]:
        """(requests under budget, requests) from the merged e2e
        histogram's cumulative buckets: good = cumulative count at the
        smallest bound >= budget (a conservative read — the bucket
        bound caps the true latency of everything it counts)."""
        good = total = 0.0
        for n in nodes:
            series = n.exposition.histogram_series("ipt_stage_us")
            for rec in series.values():
                if rec["labels"].get("stage") != self.latency_stage:
                    continue
                pts = rec["buckets"]
                if not pts or pts[-1][0] != math.inf:
                    continue
                total += pts[-1][1]
                g = 0.0
                for le, v in pts:
                    if le >= budget_us:
                        g = v
                        break
                good += g
        return good, total

    # ------------------------------------------------------- rendering

    def fleet_metrics(self) -> str:
        with self._lock:
            lines = list(self._agg_lines)
        lines += self.slo_engine.prometheus_lines()
        return "\n".join(lines) + "\n"

    def healthz(self) -> Dict:
        with self._lock:
            skew = list(self._skew)
            prof = self._merged_profile
            prof_err = self._profile_error
        node_rows = []
        for n in self.nodes:
            gen = ""
            if n.exposition is not None:
                fam = n.exposition.families.get("ipt_ruleset_info")
                if fam is not None and fam.samples:
                    gen = fam.samples[0].labels.get("version", "")
            p99 = self._node_p99(n) if n.exposition is not None else None
            share = (self._confirm_share(n)
                     if n.exposition is not None else None)
            req = (n.exposition.value("ipt_requests_total")
                   if n.exposition is not None else None)
            node_rows.append({
                "name": n.name, "target": n.target, "up": n.up,
                "stale": n.stale, "error": n.error,
                "generation": gen,
                "requests_total": req,
                "p99_e2e_us": round(p99, 1) if p99 is not None
                else None,
                "confirm_share": round(share, 4) if share is not None
                else None,
                "scrape_ms": n.scrape_ms,
                "scrapes": n.scrapes, "failures": n.failures,
            })
        return {
            "status": self.slo_engine.fleet_verdict(),
            "nodes": node_rows,
            "nodes_up": sum(1 for n in self.nodes if n.up),
            "nodes_stale": sum(1 for n in self.nodes if n.stale),
            "scrape_cycles": self.scrape_cycles,
            "scrape_errors": self.scrape_errors,
            "skew_findings": skew,
            "merged_profile": ({"content_hash": prof.content_hash(),
                                "requests": prof.requests,
                                "rules": len(prof.rules)}
                               if prof is not None
                               else {"error": prof_err}),
        }

    def fleet_drift(self) -> Dict:
        """Per-node drift reports + the fleet union of went-quiet rules
        with node attribution."""
        per_node: Dict[str, Dict] = {}
        quiet: Dict[str, List[str]] = {}
        for n in self.nodes:
            if not n.up or not n.drift:
                continue
            per_node[n.name] = n.drift
            for rec in (n.drift.get("went_quiet") or []):
                rid = str(rec.get("rule") if isinstance(rec, dict)
                          else rec)
                quiet.setdefault(rid, []).append(n.name)
        return {
            "nodes": per_node,
            "fleet_went_quiet": [
                {"rule": rid, "nodes": sorted(names)}
                for rid, names in sorted(quiet.items())],
        }

    def fleet_slo(self) -> Dict:
        return {
            "verdict": self.slo_engine.fleet_verdict(),
            "slos": self.slo_engine.burn_rates(),
        }

    def counters_snapshot(self) -> Tuple[Dict[str, float],
                                         Dict[str, Dict[str, float]]]:
        """(fleet counter sums, per-node addends) — the conservation
        audit surface fleetgate and bench check against independently
        counted traffic."""
        with self._lock:
            return dict(self._counters), {
                k: dict(v) for k, v in self._per_node_counters.items()}

    def merged_profile(self) -> Optional[MeasuredProfile]:
        with self._lock:
            return self._merged_profile

    # ------------------------------------------------------ HTTP plane

    def route(self, path: str) -> Tuple[str, str, bytes]:
        """Sync router for the /fleet/* surfaces (same (status, ctype,
        body) contract as ServeLoop._route_http)."""
        if path.startswith("/fleet/metrics"):
            return ("200 OK", "text/plain; version=0.0.4",
                    self.fleet_metrics().encode())
        if path.startswith("/fleet/healthz"):
            return ("200 OK", "application/json",
                    json.dumps(self.healthz()).encode())
        if path.startswith("/fleet/drift"):
            return ("200 OK", "application/json",
                    json.dumps(self.fleet_drift()).encode())
        if path.startswith("/fleet/slo"):
            return ("200 OK", "application/json",
                    json.dumps(self.fleet_slo()).encode())
        if path.startswith("/fleet/profile"):
            prof = self.merged_profile()
            if prof is None:
                return ("503 Service Unavailable", "application/json",
                        json.dumps({"error": self._profile_error
                                    or "no merged profile"}).encode())
            return ("200 OK", "application/json",
                    prof.to_json().encode())
        return ("404 Not Found", "application/json",
                json.dumps({"error": "unknown path %s" % path,
                            "routes": ["/fleet/metrics",
                                       "/fleet/healthz",
                                       "/fleet/drift", "/fleet/slo",
                                       "/fleet/profile"]}).encode())

    def serve_http(self, port: int = 0,
                   host: str = "127.0.0.1") -> int:
        """Expose the /fleet/* plane on a real TCP port (daemon
        thread); returns the bound port."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        obs = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:           # noqa: N802 (stdlib API)
                status, ctype, body = obs.route(self.path)
                self.send_response(int(status.split()[0]))
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:  # silence stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="fleetobs-http", daemon=True)
        t.start()
        return int(self._httpd.server_address[1])

    def start_scraping(self, interval_s: float = 5.0) -> None:
        """Background scrape loop (daemon thread)."""
        def _loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.scrape()
                except Exception:    # noqa: BLE001 — the loop survives
                    pass
        self._thread = threading.Thread(target=_loop,
                                        name="fleetobs-scraper",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet telemetry aggregator: scrape N serve "
                    "nodes, serve /fleet/*")
    ap.add_argument("--node", action="append", default=[],
                    metavar="NAME=HOST:PORT", required=False,
                    help="register a node (repeatable)")
    ap.add_argument("--port", type=int, default=9911,
                    help="aggregator HTTP port (0 = ephemeral)")
    ap.add_argument("--interval-s", type=float, default=5.0)
    ap.add_argument("--once", action="store_true",
                    help="scrape once, print /fleet/healthz, exit")
    args = ap.parse_args(argv)
    if not args.node:
        ap.error("at least one --node NAME=HOST:PORT is required")
    obs = FleetObserver()
    for spec in args.node:
        name, _, target = spec.partition("=")
        if not target:
            ap.error("--node must be NAME=HOST:PORT, got %r" % spec)
        obs.add_node(name, target=target)
    obs.scrape()
    if args.once:
        print(json.dumps(obs.healthz(), indent=2))
        return 0
    port = obs.serve_http(port=args.port)
    print("fleetobs: serving /fleet/* on 127.0.0.1:%d, scraping %d "
          "nodes every %.1fs" % (port, len(obs.nodes),
                                 args.interval_s))
    obs.start_scraping(args.interval_s)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        obs.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
