"""Tracing — per-stage histograms, per-batch spans, slow-request
exemplars, device profiler hooks (SURVEY.md §5).

The reference traces requests with nginx-opentracing + jaeger/zipkin C++
clients, exposes controller latency as Prometheus histograms, and
profiles the Go side with pprof.  The equivalents here:

  * ``Histogram`` — allocation-free fixed-bucket (log2-scaled µs)
    latency histogram.  The batcher keeps one per pipeline stage
    (queue delay, host prep, device scan, confirm, whole batch,
    per-request end-to-end) and the server renders them in Prometheus
    histogram text format, so p50/p99 per stage are scrapeable without
    any external tooling.
  * ``BatchTrace``/``TraceRing`` — a bounded ring of per-batch span
    records (per-stage split points + the full request-id list) kept by
    the batcher and served at ``/traces``; ``/traces/request?id=``
    resolves a wire req_id to its batch's per-stage spans — the
    "propagate a request-id so a slow verdict is attributable"
    requirement without a tracing daemon.
  * ``SlowRing`` — the K slowest requests (span breakdown + truncated
    input sizes + rules hit), served at ``/debug/slow`` and rendered by
    ``dbg latency``.
  * ``stage_breakdown_from_metrics`` — parses the Prometheus histogram
    text back into per-stage p50/p99 (bench.py emits this as the
    ``stage_breakdown`` object in BENCH json, decomposing the latency
    leg by stage).
  * ``profiled`` — wraps a region in ``torch.profiler`` collection
    (host and CUDA activity, every thread) and writes a Chrome trace
    under ``--trace-dir`` when the region ends, with the flight
    recorder's spans merged in on the trace's clock.
"""

from __future__ import annotations

import heapq
import mmap
import os
import re
import threading
import time
import traceback
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


# ----------------------------------------------------- instrumented locks
# The runtime twin of the static concurrency analyzer (docs/ANALYSIS.md
# "Concurrency analysis"): opt-in (env IPT_DEBUG_LOCKS / --debug-locks /
# enable_debug_locks()).  When OFF — the production default —
# named_lock() returns a plain threading.Lock and the serve plane pays
# nothing.  When ON, every named_lock is an InstrumentedLock that
# records per-thread acquisition order into a global LockRegistry:
# nested-acquisition edges (the runtime lock-order graph, compared
# against concheck's static one), ORDER VIOLATIONS (lock pair observed
# in both orders — the dynamic face of conc.lock-order-cycle), and
# contention counts.  tools/lint.py flips this on for the faultmatrix
# run, so the 15 fault scenarios double as a race stress harness at
# zero extra CI cost.

_DEBUG_LOCKS = os.environ.get("IPT_DEBUG_LOCKS", "") not in ("", "0")


def debug_locks_enabled() -> bool:
    return _DEBUG_LOCKS


def enable_debug_locks(on: bool = True) -> None:
    """Flip lock instrumentation for locks created FROM NOW ON (existing
    plain locks are untouched — callers construct their objects after
    enabling, e.g. the faultmatrix building fresh batchers)."""
    global _DEBUG_LOCKS
    _DEBUG_LOCKS = bool(on)


class LockRegistry:
    """Process-global acquisition-order ledger for instrumented locks."""

    MAX_VIOLATIONS = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.violations: List[dict] = []
        self.acquisitions = 0
        self.contended = 0

    def note_acquire(self, name: str,
                     held: Sequence["InstrumentedLock"]) -> None:
        with self._lock:
            self.acquisitions += 1
            for h in held:
                if h.name == name:
                    continue
                edge = (h.name, name)
                self.edges[edge] = self.edges.get(edge, 0) + 1
                rev = (name, h.name)
                if rev in self.edges:
                    if len(self.violations) < self.MAX_VIOLATIONS:
                        self.violations.append({
                            "pair": [h.name, name],
                            "thread": threading.current_thread().name,
                            "stack": "".join(
                                traceback.format_stack(limit=8)),
                        })

    def note_contention(self) -> None:
        with self._lock:
            self.contended += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "acquisitions": self.acquisitions,
                "contended": self.contended,
                "edges": sorted("%s -> %s" % e for e in self.edges),
                "violations": [dict(v, stack=v["stack"].splitlines()[-4:])
                               for v in self.violations],
                "violation_count": len(self.violations),
            }

    def reset(self) -> None:
        with self._lock:
            self.edges.clear()
            self.violations.clear()
            self.acquisitions = 0
            self.contended = 0

    def assert_consistent_with(self, static_edges: Sequence[str]) -> List[str]:
        """Order-consistency against the static lock-order graph
        (concheck's ``meta.lock_order_edges``): every runtime edge whose
        REVERSE appears statically is a latent deadlock the static
        analyzer must be told about.  Returns the offending edges."""
        static = set(static_edges)
        with self._lock:
            runtime = {"%s -> %s" % e for e in self.edges}
        out = []
        for e in runtime:
            a, _, b = e.partition(" -> ")
            if "%s -> %s" % (b, a) in static:
                out.append(e)
        return out


#: the process-wide registry instrumented locks report into
lock_registry = LockRegistry()

_held_locks = threading.local()


class InstrumentedLock:
    """Drop-in threading.Lock that records acquisition order, order
    violations, and contention into :data:`lock_registry`.  Works as a
    ``threading.Condition`` backing lock (Condition only needs
    acquire/release/locked and falls back gracefully for the rest)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str = "lock", rlock: bool = False):
        self.name = name
        self._inner = threading.RLock() if rlock else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            lock_registry.note_contention()
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        stack = getattr(_held_locks, "stack", None)
        if stack is None:
            stack = _held_locks.stack = []
        lock_registry.note_acquire(self.name, stack)
        stack.append(self)
        return True

    def release(self) -> None:
        stack = getattr(_held_locks, "stack", None)
        if stack is not None:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    break
        self._inner.release()

    def locked(self) -> bool:
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        # RLock has no locked() before 3.14: probe non-blocking (an
        # owner's re-acquire succeeds, reading as unlocked — fine for
        # the debug-surface uses of this method)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def named_lock(name: str) -> "threading.Lock | InstrumentedLock":
    """The ONE lock constructor of the serve plane: a plain
    threading.Lock in production (zero overhead, zero behavior change),
    an :class:`InstrumentedLock` when lock debugging is on."""
    if _DEBUG_LOCKS:
        return InstrumentedLock(name)
    return threading.Lock()


def named_rlock(name: str):
    """Reentrant variant (the rollout state machine's lock: its
    accounting helpers are called both with and without the lock
    held)."""
    if _DEBUG_LOCKS:
        return InstrumentedLock(name, rlock=True)
    return threading.RLock()


# ------------------------------------------------- silent-thread-death
# Runtime counterpart of concheck's lifecycle lint: an uncaught
# exception killing a worker thread used to vanish into stderr.  The
# serve plane installs this hook (Batcher.__init__); /healthz surfaces
# the counts and /metrics exports ipt_thread_uncaught_total{thread=}.

_uncaught_lock = threading.Lock()
_uncaught_counts: Dict[str, int] = {}
_hook_installed = False
_THREAD_SUFFIX_RE = re.compile(r"[-_]\d+$")


def install_thread_excepthook() -> None:
    """Idempotently wrap ``threading.excepthook``: count uncaught
    worker-thread exceptions by normalized thread name (ipt-device-3 →
    ipt-device) and chain to the previous hook so the traceback still
    prints."""
    global _hook_installed
    with _uncaught_lock:
        if _hook_installed:
            return
        _hook_installed = True
        prev = threading.excepthook

        def hook(args) -> None:
            name = getattr(args.thread, "name", None) or "unknown"
            base = _THREAD_SUFFIX_RE.sub("", name) or name
            with _uncaught_lock:
                _uncaught_counts[base] = _uncaught_counts.get(base, 0) + 1
            prev(args)

        threading.excepthook = hook


def thread_uncaught_counts() -> Dict[str, int]:
    with _uncaught_lock:
        return dict(_uncaught_counts)


def reset_thread_uncaught_counts() -> None:
    with _uncaught_lock:
        _uncaught_counts.clear()

#: log2-scaled µs bucket upper bounds: 1µs … ~8.4s, factor-2 resolution
#: (24 finite buckets + the implicit +Inf overflow).  Fixed at import
#: time so observe() never allocates.
DEFAULT_BUCKETS_US: Tuple[int, ...] = tuple(1 << i for i in range(24))

#: canonical stage set the serve plane attributes latency to (the order
#: is the rendering/report order): queue delay before dispatch, host
#: prep (normalize/unpack/row build), device scan, CPU confirm, the
#: whole dispatch cycle, and per-request end-to-end (queue + batch).
STAGES = ("queue", "prep", "scan", "confirm", "batch", "e2e")


def _percentile_from_buckets(bounds: Sequence[int], counts: Sequence[int],
                             p: float) -> float:
    """Percentile estimate from per-bucket counts (NOT cumulative).

    Linear interpolation inside the winning bucket (Prometheus'
    histogram_quantile does the same); the +Inf overflow bucket reports
    its lower bound — an honest floor, never an invented ceiling."""
    total = sum(counts)
    if total <= 0 or not bounds:
        return 0.0
    rank = p * total
    seen = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= rank:
            lo = float(bounds[i - 1]) if i > 0 and i - 1 < len(bounds) \
                else 0.0
            if i >= len(bounds):        # +Inf overflow bucket
                return float(bounds[-1])
            hi = float(bounds[i])
            frac = (rank - seen) / c
            return lo + (hi - lo) * frac
        seen += c
    return float(bounds[-1])


class Histogram:
    """Fixed log-bucket µs histogram: observe is O(log n_buckets) with
    zero allocation (list index increments under a short lock — many
    producer threads, consistent snapshots for the scraper)."""

    __slots__ = ("bounds", "counts", "total", "sum_us", "_lock")

    def __init__(self, bounds: Sequence[int] = DEFAULT_BUCKETS_US):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.total = 0
        self.sum_us = 0
        self._lock = named_lock("Histogram._lock")

    def observe(self, us: float) -> None:
        us_i = int(us)
        i = bisect_left(self.bounds, us_i)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum_us += us_i

    def reset(self) -> None:
        """Zero the distribution (bench legs reset after warmup so the
        scraped breakdown describes ONLY the measured traffic)."""
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.total = 0
            self.sum_us = 0

    def snapshot(self) -> Tuple[List[int], int, int]:
        with self._lock:
            return list(self.counts), self.total, self.sum_us

    def percentile(self, p: float) -> float:
        counts, total, _ = self.snapshot()
        if not total:
            return 0.0
        return _percentile_from_buckets(self.bounds, counts, p)

    @classmethod
    def from_cumulative(cls, bounds: Sequence[int],
                        cumulative: Sequence[float],
                        sum_us: float = 0) -> "Histogram":
        """Rebuild a histogram from Prometheus *cumulative* bucket
        counts — the decode direction of :meth:`prometheus`, used by
        the fleet aggregator to reconstruct per-node histograms from
        scraped ``_bucket`` lines.  ``cumulative`` must include the
        ``+Inf`` bucket last; non-monotonic counts raise (a scrape
        that fails its own shape invariant is skew, not data)."""
        bounds = tuple(int(b) for b in bounds)
        if len(cumulative) != len(bounds) + 1:
            raise ValueError(
                "cumulative bucket count %d does not match %d bounds "
                "+ Inf" % (len(cumulative), len(bounds)))
        h = cls(bounds)
        prev = 0
        counts: List[int] = []
        for c in cumulative:
            ci = int(c)
            if ci < prev:
                raise ValueError("non-monotonic cumulative bucket "
                                 "counts")
            counts.append(ci - prev)
            prev = ci
        h.counts = counts
        h.total = prev
        h.sum_us = int(sum_us)
        return h

    @classmethod
    def merge(cls, hists: Sequence["Histogram"]) -> "Histogram":
        """Bucket-wise sum of histograms sharing identical bounds — the
        fleet aggregation primitive (per-node latency distributions
        merge losslessly because every node uses the same fixed log2
        buckets).  A bounds mismatch raises ValueError; the caller
        (fleetobs) turns that into a skew finding instead of merging
        incomparable distributions."""
        items = list(hists)
        if not items:
            return cls()
        bounds = tuple(items[0].bounds)
        out = cls(bounds)
        for h in items:
            if tuple(h.bounds) != bounds:
                raise ValueError(
                    "histogram bucket bounds mismatch: %d bounds vs %d"
                    % (len(bounds), len(h.bounds)))
            counts, total, sum_us = h.snapshot()
            for i, c in enumerate(counts):
                out.counts[i] += c
            out.total += total
            out.sum_us += sum_us
        return out

    def prometheus(self, name: str, labels: Optional[Dict[str, str]] = None
                   ) -> List[str]:
        """Series lines (no # TYPE header — the caller groups same-name
        series under one header) in Prometheus histogram text format:
        cumulative _bucket{le=...} + _sum + _count."""
        counts, total, sum_us = self.snapshot()
        base = "".join('%s="%s",' % (k, v)
                       for k, v in (labels or {}).items())
        lines = []
        cum = 0
        for i, bound in enumerate(self.bounds):
            cum += counts[i]
            lines.append('%s_bucket{%sle="%d"} %d'
                         % (name, base, bound, cum))
        cum += counts[-1]
        lines.append('%s_bucket{%sle="+Inf"} %d' % (name, base, cum))
        tail = ("{%s}" % base.rstrip(",")) if base else ""
        lines.append("%s_sum%s %d" % (name, tail, sum_us))
        lines.append("%s_count%s %d" % (name, tail, total))
        return lines


@dataclass
class BatchTrace:
    """One dispatch cycle's span record (all µs, wall-clock host side).

    ``request_ids`` carries the FULL id list (wire req_ids as decoded by
    serve/protocol.py), so ``/traces/request?id=`` can resolve any
    recent verdict to its batch — not just a sample."""

    ts: float                 # unix time at dispatch start
    n_requests: int
    n_stream_items: int
    queue_delay_us: int       # oldest request's wait before dispatch
    batch_us: int             # full dispatch cycle
    engine_us: int            # device scan portion (cumulative delta)
    confirm_us: int           # CPU confirm portion (cumulative delta)
    request_ids: List[str] = field(default_factory=list)
    prep_us: int = 0          # host prep (normalize/unpack/row build)

    def stages(self) -> Dict[str, int]:
        """Per-stage µs breakdown; ``other_us`` is the unattributed
        remainder of the dispatch cycle (stream scan work, queue ops)."""
        other = self.batch_us - self.prep_us - self.engine_us \
            - self.confirm_us
        return {
            "queue_us": self.queue_delay_us,
            "prep_us": self.prep_us,
            "scan_us": self.engine_us,
            "confirm_us": self.confirm_us,
            "batch_us": self.batch_us,
            "other_us": max(other, 0),
        }


class TraceRing:
    """Bounded, thread-safe ring of recent batch traces."""

    def __init__(self, capacity: int = 256):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = named_lock("TraceRing._lock")

    def record(self, trace: BatchTrace) -> None:
        with self._lock:
            self._ring.append(trace)

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        if n is not None:
            items = items[-n:]
        return [asdict(t) for t in items]

    def slowest(self, n: int = 10) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        items.sort(key=lambda t: t.batch_us, reverse=True)
        out = []
        for t in items[:n]:
            d = asdict(t)
            d["stages"] = t.stages()
            out.append(d)
        return out

    def find_request(self, req_id: str) -> Optional[dict]:
        """Newest batch containing ``req_id`` → span dict + stage
        breakdown, or None when the id has aged out of the ring."""
        with self._lock:
            items = list(self._ring)
        for t in reversed(items):
            if req_id in t.request_ids:
                d = asdict(t)
                d["stages"] = t.stages()
                return d
        return None


class SlowRing:
    """The K slowest requests seen so far (min-heap by end-to-end µs):
    a request displaces the fastest retained exemplar once the ring is
    full.  O(log K) offer, tiny fixed memory — safe on the hot path."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._heap: List[Tuple[int, int, dict]] = []
        self._seq = 0           # tie-break: dicts don't compare
        self._lock = named_lock("SlowRing._lock")

    def offer(self, e2e_us: int, exemplar: dict) -> None:
        with self._lock:
            self._seq += 1
            item = (int(e2e_us), self._seq, exemplar)
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)

    def threshold(self) -> int:
        """Smallest retained e2e_us once full, else -1 (everything
        accepted).  Lock-free read — callers use it to skip building the
        exemplar dict for fast requests on the dispatch thread; a stale
        value only mis-skips a borderline exemplar (offer re-checks
        under the lock).  The local ref makes the len-check and the
        [0] index consistent against a concurrent reset(), which
        REBINDS _heap (never mutates it empty)."""
        heap = self._heap
        if len(heap) < self.capacity:
            return -1
        return heap[0][0]

    def reset(self) -> None:
        with self._lock:
            self._heap = []   # rebind, never clear() — see threshold()

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """Exemplars, slowest first."""
        with self._lock:
            items = sorted(self._heap, reverse=True)
        if n is not None:
            items = items[:n]
        return [dict(e, e2e_us=us) for us, _, e in items]

    def find_request(self, req_id: str) -> Optional[dict]:
        for e in self.snapshot():
            if e.get("request_id") == req_id:
                return e
        return None


class Ewma:
    """Exponentially weighted moving average — the load signal of the
    brownout ladder (models/pipeline.py LoadController), the batcher's
    queue-wait estimator (admission-time deadline shedding), and the
    per-tenant rate/shed estimators (models/tenant_guard.py).

    ``update`` is a read-modify-write, and Ewmas now live on more than
    one thread boundary (dispatch-thread fold vs submit-thread tenant
    windows), so updates serialize on a tiny per-instance lock —
    concheck flagged the bare RMW (conc.unguarded-mutation, the
    lost-update class); updates are per-cycle/per-window, never
    per-request, so the acquire is noise.  ``get`` stays lock-free: a
    float read is torn-free under the GIL and a stale sample only
    shifts the EWMA by one observation."""

    __slots__ = ("alpha", "value", "_lock")

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.value: Optional[float] = None
        self._lock = named_lock("Ewma._lock")

    def update(self, x: float) -> float:
        with self._lock:
            v = self.value
            self.value = out = x if v is None else self.alpha * x \
                + (1.0 - self.alpha) * v
        return out

    def get(self, default: float = 0.0) -> float:
        v = self.value
        return default if v is None else v

    def reset(self) -> None:
        with self._lock:
            self.value = None


def bounded_counter_series(name: str, label: str,
                           counts: Dict[str, int], cap: int = 30,
                           extra: Optional[Dict[str, str]] = None,
                           ) -> List[str]:
    """Prometheus counter lines for one labeled series with a HARD
    cardinality budget (the detection-plane telemetry policy: per-rule
    detail is JSON-only, Prometheus gets bounded label sets).

    The first ``cap`` label values in SORTED label order are emitted
    verbatim; the tail folds into one ``label="other"`` series carrying
    the summed remainder — a hostile key stream can therefore never
    grow the scrape.  Membership is deterministic BY LABEL, not by
    count: count-ranked membership would reshuffle between scrapes as
    counts race, making the "other" counter non-monotonic (a fold-set
    change reads as a process reset to PromQL rate()).  With a fixed
    label universe per series generation (rule families are fixed per
    ruleset version, L tiers are static) every series is monotonic.
    ``extra`` labels (e.g. the ruleset version) ride every line.  No
    # TYPE header — the caller groups series under one."""
    base = "".join('%s="%s",' % (k, v)
                   for k, v in (extra or {}).items())
    ordered = sorted(counts.items())
    lines = []
    other = 0
    for i, (val, n) in enumerate(ordered):
        if i < cap and val != "other":
            lines.append('%s{%s%s="%s"} %d' % (name, base, label, val, n))
        else:
            other += n
    if other or len(ordered) > cap:
        lines.append('%s{%s%s="other"} %d' % (name, base, label, other))
    return lines


# --------------------------------------------------------------- parsing

_BUCKET_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{(?P<labels>[^}]*)\}'
    r'\s+(?P<value>\d+)\s*$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def stage_breakdown_from_metrics(text: str,
                                 metric: str = "ipt_stage_us",
                                 percentiles: Sequence[float] = (
                                     0.5, 0.9, 0.99),
                                 ) -> Optional[Dict[str, dict]]:
    """Parse Prometheus histogram text → per-stage percentile table.

    Returns ``{stage: {"count": n, "p50_us": x, "p90_us": y,
    "p99_us": z}, ...}`` or None when the metric is absent or malformed
    (non-monotonic cumulative counts, unparsable le) — callers treat
    None as a LOUD diagnostic condition, never a silent pass (a missing
    stage breakdown must be a visible warning)."""
    series: Dict[str, List[Tuple[float, int]]] = {}
    for line in text.splitlines():
        m = _BUCKET_RE.match(line.strip())
        if not m or m.group("name") != metric:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels")))
        stage = labels.get("stage")
        le = labels.get("le")
        if stage is None or le is None:
            return None
        try:
            bound = float("inf") if le == "+Inf" else float(le)
        except ValueError:
            return None
        series.setdefault(stage, []).append((bound, int(m.group("value"))))
    if not series:
        return None
    out: Dict[str, dict] = {}
    for stage, pts in series.items():
        pts.sort(key=lambda bv: bv[0])
        cum = [v for _, v in pts]
        if any(b > a for a, b in zip(cum[1:], cum)):  # must be monotonic
            return None
        bounds = [b for b, _ in pts if b != float("inf")]
        if not bounds:      # only a +Inf bucket survived = malformed
            return None
        counts = [cum[0]] + [b - a for a, b in zip(cum, cum[1:])]
        entry = {"count": cum[-1]}
        for p in percentiles:
            entry["p%s_us" % format(p * 100, "g")] = round(
                _percentile_from_buckets(bounds, counts, p), 1)
        out[stage] = entry
    return out


# ------------------------------------------------ cycle flight recorder
# (docs/OBSERVABILITY.md "Cycle flight recorder").  The serve plane is
# pipelined across threads — per-device lanes with double-buffered
# transfer, confirm workers overlapped with the next cycle's scan — but
# the stage histograms above AGGREGATE away exactly that concurrency
# structure.  The flight recorder keeps the timeline: every thread root
# of the serve plane emits begin/end
# span events into a per-thread single-writer ring (fixed byte cap,
# oldest-evict, drop-counted), stitched by cycle id and request-id hash
# so a request's path is followable across admission → lane → confirm
# worker → verdict.  Exported as Chrome-trace / Perfetto JSON at
# /debug/trace, as a terminal Gantt by `dbg timeline`, and consumed by
# utils/overlap.py for the measured overlap report.
#
# Cost discipline (the <3% clean-path budget): recording is ON by
# default but every event is ONE tuple write into a preallocated ring
# slot — integer event codes, monotonic-ns stamps, no dicts, no string
# formatting; naming/export cost is paid only at snapshot time.
# ``--no-flight-recorder`` reduces record() to a single attribute read.

#: event codes (ints on the hot path; EVENT_NAMES only at export)
EV_CYCLE = 1       # one dispatch cycle, launch → resolve (dispatch)
EV_DRAIN = 2       # admission-queue drain wait (dispatch)
EV_QUEUE = 3       # instant: a tenant sub-queue's max wait this cycle
EV_PREP = 4        # host prep: normalize/unpack/row build+merge
EV_LAUNCH = 5      # one lane share's prep+launch (dispatch), tag=lane
EV_DEVICE = 6      # device dispatch busy (lane worker), tag=lane
EV_COLLECT = 7     # one lane share's scan collection (dispatch), tag=lane
EV_CONFIRM = 8     # one confirm share's walk, tag=worker, arg=n_requests
EV_FINALIZE = 9    # finalize join + single-threaded fold (dispatch)
EV_MIRROR = 10     # rollout shadow mirroring of resolved verdicts
EV_STREAM = 11     # stream-step scan work (pinned lane worker)
EV_OVERSIZED = 12  # oversized side-lane body scan, tag=tenant
EV_SUBMIT = 13     # instant: admission, tag=req-id hash, arg=tenant
EV_VERDICT = 14    # instant: verdict resolved, tag=req-id hash, arg=lane
EV_SHADOW = 15     # shadow-lane candidate scan (shadow thread)
EV_EXPORT = 16     # postanalytics export flush attempt
EV_WATCHDOG = 17   # instant: watchdog released futures, arg=count
EV_STREAM_FEED = 18    # stream chunk feed/flush: incremental decode+normalize
EV_STREAM_WAVE = 19    # one stream scan wave's round trip on the card
EV_STREAM_FINISH = 20  # one stream's finish: rule fold + confirm
EV_ENGINE_SYNC = 21    # the engine's copy back of rule hits (waits on the card)

EVENT_NAMES: Dict[int, str] = {
    EV_CYCLE: "cycle", EV_DRAIN: "drain", EV_QUEUE: "queue_wait",
    EV_PREP: "host_prep", EV_LAUNCH: "lane_launch", EV_DEVICE:
    "device_busy", EV_COLLECT: "lane_collect", EV_CONFIRM:
    "confirm_share", EV_FINALIZE: "finalize_join", EV_MIRROR: "mirror",
    EV_STREAM: "stream_step", EV_OVERSIZED: "oversized",
    EV_SUBMIT: "submit", EV_VERDICT: "verdict", EV_SHADOW: "shadow_scan",
    EV_EXPORT: "export", EV_WATCHDOG: "watchdog_release",
    EV_STREAM_FEED: "stream_feed", EV_STREAM_WAVE: "stream_wave",
    EV_STREAM_FINISH: "stream_finish", EV_ENGINE_SYNC: "engine_sync",
}

#: phases — begin / end / instant (flow endpoints are instants on the
#: submit/verdict codes; the exporter synthesizes Chrome s/f pairs)
PH_B, PH_E, PH_I = 0, 1, 2

#: per-event byte estimate for the ring cap: a 6-int tuple (~104B on
#: CPython) plus its list slot — documented, not measured per-platform
EVENT_BYTES = 112

#: events per cycle are O(lanes + confirm workers + tenants), plus two
#: instants per request (submit/verdict) — the default 256KB ring holds
#: ~2300 events ≈ hundreds of cycles of structure on a quiet box and
#: tens under load, plenty for the overlap report's window
DEFAULT_RING_KB = 256

#: the ring under ``--trace-dir``: a traced run keeps every event of
#: the server's life, so the merged profiler trace names every idle
#: gap.  Reckoned from the busiest ring, the dispatch thread at about
#: 1500 events a second under closed-loop load, over a server life of
#: about 90 s (135k events, ~15 MB at EVENT_BYTES), with twice that
#: for room: ~300k events
TRACE_RING_KB = 32 * 1024


def ring_kb_for(explicit: Optional[int], traced: bool) -> int:
    """The per-thread ring a server runs with: ``--trace-ring-kb`` when
    given, else :data:`TRACE_RING_KB` under ``--trace-dir`` and
    :data:`DEFAULT_RING_KB` without it."""
    if explicit is not None:
        return explicit
    return TRACE_RING_KB if traced else DEFAULT_RING_KB


def request_tag(request_id: str) -> int:
    """Stable-within-process int tag for a wire request id (the flow id
    stitching submit → verdict across threads)."""
    return hash(request_id) & 0x7FFFFFFFFFFFFFFF


class _ThreadRing:
    """One thread's event ring: SINGLE-WRITER by construction (only the
    owning thread records; readers snapshot the slot list, tolerating a
    torn read of at most the newest slot — telemetry, not verdicts)."""

    __slots__ = ("root", "thread_name", "index", "cap", "buf", "head",
                 "dropped", "cycle", "thread", "native_id")

    def __init__(self, root: str, thread_name: str, index: int, cap: int):
        self.root = root
        self.thread_name = thread_name
        self.index = index          # stable tid for the trace export
        self.cap = cap
        self.buf: List[Optional[tuple]] = [None] * cap
        self.head = 0
        self.dropped = 0            # events evicted by the byte cap
        self.cycle = 0              # ambient cycle id for this thread
        #: owner thread — registration prunes DEAD threads' rings past
        #: a soft cap, so short-lived workers (abandoned lanes, test
        #: batchers, swap warmers) cannot grow the registry unbounded
        self.thread = threading.current_thread()
        #: the OS thread id, the ``tid`` the profiler's trace gives
        #: this thread's own events (the ``--trace-dir`` merge)
        self.native_id = threading.get_native_id()

    def record(self, t_ns: int, code: int, phase: int, cycle: int,
               tag: int, arg: int) -> None:
        i = self.head
        buf = self.buf
        if buf[i] is not None:
            # concheck: ok single-writer ring — only the owning thread records
            self.dropped += 1
        buf[i] = (t_ns, code, phase, cycle, tag, arg)
        # concheck: ok single-writer ring — only the owning thread records
        self.head = (i + 1) % self.cap

    def events(self) -> List[tuple]:
        """Chronological copy (oldest first)."""
        buf = list(self.buf)        # GIL-atomic slot copy
        head = self.head
        out = [e for e in buf[head:] if e is not None]
        out += [e for e in buf[:head] if e is not None]
        return out


class FlightRecorder:
    """Process-wide cycle flight recorder.  Threads register (or are
    lazily auto-registered under their normalized thread name) and get a
    private ring; ``record`` is the one hot-path entry.  ``configure``
    re-arms every ring (generation bump — stale thread-locals from
    before a reconfigure re-register on their next event)."""

    #: soft registry cap: past it, registration drops the oldest rings
    #: whose owner thread has exited (live rings are never pruned)
    MAX_RINGS = 128

    def __init__(self, ring_kb: int = DEFAULT_RING_KB,
                 enabled: bool = True):
        self.enabled = enabled
        self.ring_kb = ring_kb
        self._gen = 0
        self._next_tid = 0
        self._lock = named_lock("FlightRecorder._lock")
        self._rings: List[_ThreadRing] = []
        self._tls = threading.local()

    # ------------------------------------------------------- lifecycle

    def configure(self, ring_kb: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        """Re-arm the recorder (serve startup: --trace-ring-kb /
        --no-flight-recorder; tests: isolation between cases).  Existing
        rings are dropped — every thread re-registers lazily."""
        with self._lock:
            if ring_kb is not None:
                self.ring_kb = max(1, int(ring_kb))
            if enabled is not None:
                self.enabled = bool(enabled)
            self._rings = []
            self._gen += 1

    def reset(self) -> None:
        self.configure()

    def _cap(self) -> int:
        return max(64, (self.ring_kb * 1024) // EVENT_BYTES)

    def register_thread(self, root: Optional[str] = None) -> None:
        """Declare the calling thread's root name (the threadmap root:
        dispatch, lane_worker, confirm_worker, ...).  Threads that never
        call this are auto-registered under their normalized thread
        name on first record."""
        if not self.enabled:
            return
        self._register(root)

    def _register(self, root: Optional[str]) -> _ThreadRing:
        name = threading.current_thread().name
        if root is None:
            root = _THREAD_SUFFIX_RE.sub("", name) or name
        with self._lock:
            if len(self._rings) >= self.MAX_RINGS:
                # prune dead threads' rings oldest-first (their events
                # age out of the post-mortem window; live rings stay)
                alive = [r for r in self._rings if r.thread.is_alive()]
                dead = [r for r in self._rings
                        if not r.thread.is_alive()]
                self._rings = alive + dead[-16:]
            ring = _ThreadRing(root, name, self._next_tid, self._cap())
            self._next_tid += 1
            self._rings.append(ring)
            gen = self._gen
        self._tls.ring = ring
        self._tls.gen = gen
        return ring

    def _ring(self) -> _ThreadRing:
        tls = self._tls
        ring = getattr(tls, "ring", None)
        if ring is None:
            return self._register(None)
        if getattr(tls, "gen", -1) != self._gen:
            # re-arm after a configure()/reset(): keep the declared
            # root name — a post-warmup reset must not demote
            # "dispatch" to its raw thread name
            return self._register(ring.root)
        return ring

    # --------------------------------------------------------- hot path

    def record(self, code: int, phase: int, cycle: Optional[int] = None,
               tag: int = 0, arg: int = 0) -> None:
        if not self.enabled:
            return
        ring = self._ring()
        ring.record(time.monotonic_ns(), code, phase,
                    ring.cycle if cycle is None else cycle, tag, arg)

    def begin(self, code: int, cycle: Optional[int] = None,
              tag: int = 0, arg: int = 0) -> None:
        self.record(code, PH_B, cycle, tag, arg)

    def end(self, code: int, cycle: Optional[int] = None,
            tag: int = 0, arg: int = 0) -> None:
        self.record(code, PH_E, cycle, tag, arg)

    def instant(self, code: int, cycle: Optional[int] = None,
                tag: int = 0, arg: int = 0) -> None:
        self.record(code, PH_I, cycle, tag, arg)

    def set_cycle(self, cycle: int) -> None:
        """Ambient cycle id for subsequent events on THIS thread (the
        dispatch thread stamps it per cycle; lane/confirm closures carry
        it across the thread boundary via scoped())."""
        if not self.enabled:
            return
        self._ring().cycle = cycle

    def cycle(self) -> int:
        if not self.enabled:
            return 0
        return self._ring().cycle

    def scoped(self, cycle: int, fn, *args):
        """Run ``fn`` with the calling thread's ambient cycle set —
        the closure-crossing helper for work launched onto lane/confirm
        workers (the cycle id travels with the work, not the thread)."""
        self.set_cycle(cycle)
        return fn(*args)

    # ---------------------------------------------------------- export

    def dropped(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)

    def snapshot(self, cycles: Optional[int] = None) -> dict:
        """Raw event snapshot: ``threads`` (tid/root/name/dropped) +
        ``events`` as (tid, t_ns, code, phase, cycle, tag, arg) tuples,
        time-sorted.  ``cycles=N`` keeps only the last N cycle ids seen
        (untagged cycle-0 events are kept by time-window containment so
        drain/idle context survives the filter)."""
        with self._lock:
            rings = list(self._rings)
        threads = [{"tid": r.index, "root": r.root,
                    "thread": r.thread_name, "dropped": r.dropped,
                    "native_id": r.native_id}
                   for r in rings]
        events: List[tuple] = []
        for r in rings:
            tid = r.index
            events.extend((tid,) + e for e in r.events())
        events.sort(key=lambda e: e[1])
        if cycles is not None and events:
            cids = sorted({e[4] for e in events if e[4] > 0})
            keep = set(cids[-cycles:])
            if keep:
                t_min = min((e[1] for e in events if e[4] in keep),
                            default=0)
                # cycle-0 events (drain, submit/verdict flows, side
                # lanes) keep a 1s grace before the window so a kept
                # verdict's SUBMIT endpoint survives the filter — a
                # flow arrow needs both ends
                t_keep = t_min - 1_000_000_000
                events = [e for e in events
                          if e[4] in keep or (e[4] == 0
                                              and e[1] >= t_keep)]
            else:
                events = []
        return {"enabled": self.enabled, "ring_kb": self.ring_kb,
                "threads": threads, "events": events,
                "dropped": sum(r.dropped for r in rings)}

    def chrome_trace(self, cycles: Optional[int] = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): thread-name
        metadata per registered ring, matched begin/end pairs folded to
        complete ("X") slices with cycle/tag args, instants as "i", and
        request flow stitched as "s"/"f" pairs keyed on the submit/
        verdict request-id hash — load the output straight into
        https://ui.perfetto.dev."""
        snap = self.snapshot(cycles=cycles)
        trace: List[dict] = []
        for t in snap["threads"]:
            trace.append({"ph": "M", "name": "thread_name", "pid": 1,
                          "tid": t["tid"],
                          "args": {"name": "%s/%s (%s)"
                                   % (t["root"], t["tid"], t["thread"])}})
        flows = {EV_SUBMIT: "s", EV_VERDICT: "f"}
        for tid, code, cyc, tag, arg, t0_ns, t1_ns in match_spans(
                snap["events"]):
            trace.append({
                "ph": "X", "pid": 1, "tid": tid,
                "name": EVENT_NAMES.get(code, "ev%d" % code),
                "cat": "serve", "ts": round(t0_ns / 1000.0, 3),
                "dur": round(max((t1_ns - t0_ns) / 1000.0, 0.001), 3),
                "args": {"cycle": cyc, "tag": tag, "arg": arg}})
        for tid, t_ns, code, phase, cyc, tag, arg in snap["events"]:
            if phase != PH_I:
                continue
            ts = t_ns / 1000.0              # chrome ts unit: µs
            name = EVENT_NAMES.get(code, "ev%d" % code)
            ev = {"ph": "i", "pid": 1, "tid": tid, "name": name,
                  "cat": "serve", "ts": round(ts, 3), "s": "t",
                  "args": {"cycle": cyc, "tag": tag, "arg": arg}}
            trace.append(ev)
            if code in flows and tag:
                # flow endpoints ride a minimal slice so Perfetto can
                # anchor the arrow (legacy-JSON flow events bind to an
                # enclosing slice)
                trace.append({"ph": "X", "pid": 1, "tid": tid,
                              "name": name, "cat": "req",
                              "ts": round(ts, 3), "dur": 1,
                              "args": {"cycle": cyc}})
                trace.append({"ph": flows[code], "pid": 1, "tid": tid,
                              "name": "request", "cat": "req",
                              "id": tag, "ts": round(ts, 3),
                              **({"bp": "e"} if code == EV_VERDICT
                                 else {})})
        trace.sort(key=lambda e: e.get("ts", 0))
        return {"traceEvents": trace, "displayTimeUnit": "ms",
                "otherData": {"dropped": snap["dropped"],
                              "ring_kb": snap["ring_kb"]}}


def match_spans(events: Sequence[tuple]) -> List[tuple]:
    """The ONE begin/end pair matcher (chrome_trace and
    utils/overlap.py both consume it — two drifting folds would
    mispair differently): LIFO per (tid, code, tag,
    CYCLE).  The cycle id is part of the key because the mesh loop's
    double buffer begins cycle N's envelope BEFORE ending cycle
    N-1's — a (tid, code, tag)-only fold pairs end(N-1) with begin(N)
    and reports a tiny wrongly-attributed slice exactly in the
    overlapped configuration the recorder exists to measure.  Every
    instrumentation site stamps the SAME cycle on a span's begin and
    end (closures carry it), so the key is stable.  Returns
    ``(tid, code, cycle, tag, arg, t0_ns, t1_ns)`` tuples,
    begin-time-sorted; unmatched begins/ends (ring eviction at the
    window edge) are dropped."""
    open_spans: Dict[tuple, List[tuple]] = {}
    out: List[tuple] = []
    for tid, t_ns, code, phase, cyc, tag, arg in events:
        if phase == PH_B:
            open_spans.setdefault((tid, code, tag, cyc), []).append(
                (t_ns, arg))
        elif phase == PH_E:
            stack = open_spans.get((tid, code, tag, cyc))
            if not stack:
                continue
            t0, arg0 = stack.pop()
            out.append((tid, code, cyc, tag, arg0 or arg, t0, t_ns))
    out.sort(key=lambda s: s[5])
    return out


#: the process-wide flight recorder every serve-plane thread reports
#: into (the lock_registry pattern; serve --trace-ring-kb /
#: --no-flight-recorder configure it at startup)
flight = FlightRecorder()


#: the ``record_function`` event that checks the merge's clock offset
#: against the profiler's own stamps
CLOCK_ANCHOR = "ipt.clock_anchor"

#: how far outside its ``monotonic_ns`` bracket the anchor's profiler
#: stamps may lie, by the merge's offset, before the merge refuses to
#: write spans it would misplace (µs)
ANCHOR_LIMIT_US = 200.0


def _clock_anchor(torch) -> Tuple[int, int, int]:
    """``(m0, m1, offset_ns)``: a ``record_function`` event bracketed by
    ``monotonic_ns`` stamps, and the offset from ``monotonic_ns`` to
    Unix-epoch ns read beside it."""
    a = time.monotonic_ns()
    wall = time.time_ns()
    b = time.monotonic_ns()
    m0 = time.monotonic_ns()
    with torch.profiler.record_function(CLOCK_ANCHOR):
        pass
    m1 = time.monotonic_ns()
    return m0, m1, wall - (a + b) // 2


_BASE_RE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')
_TS_RE = re.compile(rb'"ts"\s*:\s*([0-9.]+)')
_DUR_RE = re.compile(rb'"dur"\s*:\s*([0-9.]+)')


def merge_flight_spans(path: str, recorder: "FlightRecorder",
                       anchor: Tuple[int, int, int]) -> dict:
    """Append the recorder's matched spans to the profiler's Chrome
    trace at ``path``, on the trace's own clock, in place.

    Each span becomes a complete event ``ipt.<name>`` of category
    ``user_annotation`` on the pid and OS thread id of the thread that
    recorded it.  An event's time in the trace is ``baseTimeNanoseconds
    / 1000 + ts`` µs of the Unix epoch (``ts`` alone when the trace has
    no base); a span's ``monotonic_ns`` stamps move onto it by the
    offset read at export.  The offset is checked first against the
    profiler's own stamps of the anchor event (:func:`_clock_anchor`):
    when the anchor is missing, or lies more than
    :data:`ANCHOR_LIMIT_US` outside its monotonic bracket, the file is
    left as the profiler wrote it and ``refused`` says why.  The trace
    is never read whole: its head gives the base, a search of the
    mapped file finds the anchor and the end of ``traceEvents``, and
    the spans are written over that end, which is written back after
    them.  Returns what the merge did: ``spans``, ``dropped`` (events
    the rings evicted), ``anchor_error_us`` (None without an anchor)
    and ``refused`` (None when the spans were written)."""
    m0, m1, offset_ns = anchor
    snap = recorder.snapshot()
    info = {"spans": 0, "dropped": snap["dropped"],
            "anchor_error_us": None, "refused": None}
    with open(path, "r+b") as f:
        m = _BASE_RE.search(f.read(4096))
        base_ns = int(m.group(1)) if m else 0
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            at = mm.rfind(b'"%s"' % CLOCK_ANCHOR.encode())
            if at >= 0:
                near = mm[at:at + 512]
                ts, dur = _TS_RE.search(near), _DUR_RE.search(near)
                if ts and dur:
                    a0 = base_ns + float(ts.group(1)) * 1e3
                    a1 = a0 + float(dur.group(1)) * 1e3
                    info["anchor_error_us"] = max(
                        0.0, m0 + offset_ns - a0, a1 - m1 - offset_ns) / 1e3
            name = mm.rfind(b'"traceName"')
            close = mm.rfind(b"]", 0, name if name >= 0 else len(mm))
            if close < 0:
                raise ValueError("%s holds no traceEvents list" % path)
            tail = mm[close:]
            k = close - 1
            while k >= 0 and mm[k:k + 1].isspace():
                k -= 1
            empty = k >= 0 and mm[k:k + 1] == b"["
        err = info["anchor_error_us"]
        if err is None:
            info["refused"] = "no clock anchor in the trace"
            return info
        if err > ANCHOR_LIMIT_US:
            info["refused"] = ("clock anchor %.1f us outside its bracket "
                               "(limit %.0f us)" % (err, ANCHOR_LIMIT_US))
            return info
        native = {t["tid"]: t["native_id"] for t in snap["threads"]}
        pid = os.getpid()
        shift = offset_ns - base_ns
        f.seek(close)
        f.truncate()
        sep = b"" if empty else b",\n"
        batch: List[str] = []
        for tid, code, cyc, tag, arg, t0_ns, t1_ns in match_spans(
                snap["events"]):
            batch.append(
                '{"ph": "X", "cat": "user_annotation", "name": "ipt.%s", '
                '"pid": %d, "tid": %d, "ts": %.3f, "dur": %.3f, '
                '"args": {"cycle": %d, "tag": %d, "arg": %d}}'
                % (EVENT_NAMES.get(code, "ev%d" % code), pid,
                   native.get(tid, tid), (t0_ns + shift) / 1e3,
                   (t1_ns - t0_ns) / 1e3, cyc, tag, arg))
            if len(batch) >= 8192:
                f.write(sep + ",\n".join(batch).encode())
                sep, batch = b",\n", []
                info["spans"] += 8192
        if batch:
            f.write(sep + ",\n".join(batch).encode())
            info["spans"] += len(batch)
        f.write(b"\n" + tail)
    return info


@contextmanager
def profiled(trace_dir: Optional[str],
             recorder: Optional["FlightRecorder"] = None):
    """``torch.profiler`` region (no-op when trace_dir is falsy).

    Records host activity, and CUDA activity when a card is present,
    for the whole region: the torch ops of every thread, those started
    before the region too (``profile_all_threads``; a torch without it
    raises here, before anything is served).  When the region ends it
    writes one Chrome trace (``serve-<pid>.json``, loadable in
    chrome://tracing or Perfetto) under trace_dir, with the flight
    recorder's spans merged in on the trace's clock
    (:func:`merge_flight_spans`), and prints the export's seconds, the
    spans merged, the recorder's dropped events and the clock check.
    """
    if not trace_dir:
        yield
        return
    import sys

    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    out = os.path.join(trace_dir, "serve-%d.json" % os.getpid())
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.__enter__()
    try:
        yield
    finally:
        anchor = _clock_anchor(torch)
        prof.__exit__(None, None, None)
        t0 = time.monotonic()
        prof.export_chrome_trace(out)
        t1 = time.monotonic()
        info = merge_flight_spans(out, recorder or flight, anchor)
        if info["refused"] is None:
            merged = ("%d flight spans merged, %d flight events dropped; "
                      "clock check: anchor %.1f us outside its bracket"
                      % (info["spans"], info["dropped"],
                         info["anchor_error_us"]))
        else:
            merged = "flight spans NOT merged: %s" % info["refused"]
        print("profiler trace written to %s: export %.1fs, merge %.1fs, %s"
              % (out, t1 - t0, time.monotonic() - t1, merged),
              file=sys.stderr)
