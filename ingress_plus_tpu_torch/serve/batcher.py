"""Deadline batcher — where the latency SLO is won or lost (SURVEY.md §7
hard part #2).

Requests arriving on the serve loop are queued; a dispatch thread drains
the queue into a batch when either (a) max_batch requests are waiting or
(b) the oldest request has waited max_delay.  Batches go through the
DetectionPipeline (device scan + CPU confirm) and verdict futures resolve.

Double-buffered dispatch (the PP stage pipeline): while batch N executes
on device, batch N+1 accumulates — the queue IS the buffer; the dispatch
thread never sleeps while work is pending.

Fail-open (wallarm-fallback): pipeline errors or a dispatch deadline
overrun produce pass-and-flag verdicts, never dropped requests.

Fail-safe plane (docs/ROBUSTNESS.md): admission is BOUNDED — the main
queue has a cap and requests that queue math says would miss
``hard_deadline_s`` are shed fail-open at enqueue, before any device
time is spent on them; the device dispatch runs on a watchdogged lane
with a hang budget backed by a circuit breaker (open = fail open on a
card, the CPU confirm-only path for a CPU pipeline; half-open = single
canary batches); and a monitor thread backstops the dispatch thread
itself.  Every path keeps the one
invariant: an admitted request resolves to exactly one verdict.

Mesh serving (docs/MESH_SERVING.md): with ``n_lanes > 1`` the SAME
admission queue feeds N per-device lanes (serve/lanes.py) — each
drained cycle is sharded across the healthy lanes (scan rows travel
with their requests, balanced by scanned bytes), every lane has its own
watchdog budget and circuit breaker, and host→device transfer is
double-buffered: the dispatch loop launches cycle N on the lanes
asynchronously and preps/pads/packs cycle N+1 while the devices crunch,
finalizing N only when N+1's launch is in flight.  A hung or erroring
card degrades CAPACITY (its share fails open once, its breaker trips,
the splitter routes around it, the half-open canary brings it back),
never the service; the breaker-open route engages only when every lane
is down.

Tenant isolation (docs/ROBUSTNESS.md "Tenant isolation"): admission is
TENANT-FAIR — the queue is per-tenant sub-queues drained by deficit
round robin with byte-weighted quanta (``_TenantFairQueue``), deadline
shedding charges each tenant its OWN backlog (a flooding tenant sheds
its own tail while victims' requests admit), a per-tenant flood guard
(models/tenant_guard.py) quarantines a budget-breaching tenant into its
own brownout (prefilter-only or fail-open per policy), and the GLOBAL
brownout ladder receives a tenant-fair pressure signal so it is
reachable only under aggregate — not single-tenant — overload.  With
one tenant on the box all of this collapses to the single-tenant
behavior.

The port of ``ingress_plus_tpu/serve/batcher.py``: lane devices are
torch devices (one per CUDA card, or the pipeline engine's own device),
each lane launches on its own CUDA stream, and ``device_path_snapshot``
reports ``cuda`` or ``cpu`` with the card's name.  The guarded rollout
(control/rollout.py) hooks in as in the JAX loops: ``self.rollout``, the
canary split and the candidate dispatch (``_detect_candidate``) in both
loops, the off-lock shadow mirror / canary accounting / promotion tick,
and the abort of a staged rollout on a force swap.  On a card, a
candidate canary batch under an open breaker fails open like the
incumbent's (never ``detect_cpu_only``).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import torch

from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline, Verdict
from ingress_plus_tpu_torch.models.tenant_guard import (
    TenantGuard,
    TenantGuardConfig,
)
from ingress_plus_tpu_torch.serve.lanes import (
    CircuitBreaker,
    DeviceHang,
    Lane,
    LanePool,
)
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.serve.stream import StreamEngine, StreamState
from ingress_plus_tpu_torch.serve.unpack import GZIP_MAGIC, unpack_body
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.trace import (
    EV_COLLECT,
    EV_CYCLE,
    EV_DRAIN,
    EV_LAUNCH,
    EV_MIRROR,
    EV_OVERSIZED,
    EV_QUEUE,
    EV_STREAM,
    EV_SUBMIT,
    EV_VERDICT,
    EV_WATCHDOG,
    STAGES,
    BatchTrace,
    Ewma,
    Histogram,
    SlowRing,
    TraceRing,
    flight,
    install_thread_excepthook,
    named_lock,
    request_tag,
)

#: batch-size distribution buckets: 1..4096 requests, power-of-two edges
#: (the engine's Q-pad tiers)
BATCH_SIZE_BUCKETS = tuple(1 << i for i in range(13))


def _safe_set(fut: "Future", value) -> None:
    """set_result that tolerates a concurrent cancel (client vanished
    between our done() check and the set): losing that race must never
    kill the dispatch thread — that would hang every future verdict."""
    try:
        if not fut.done():
            fut.set_result(value)
    except Exception:
        pass


def _fail_open_verdict(request_id: str) -> Verdict:
    return Verdict(request_id=request_id, blocked=False, attack=False,
                   classes=[], rule_ids=[], score=0, fail_open=True)


class TenantFull(queue.Full):
    """A tenant's own sub-queue hit its cap (the global cap has room):
    shed reason "tenant_queue_full" — the flooding tenant's loss, not
    the box's."""


#: DRR cost normalization: one small request ≈ 1 unit, a body adds its
#: scan bytes in units of this divisor — a 16KB body costs ~2 units, so
#: byte-heavy tenants drain proportionally fewer requests per round
QUANTUM_BYTES = 16384


class _TenantFairQueue:
    """Per-tenant admission sub-queues drained by deficit round robin
    (docs/ROBUSTNESS.md "Tenant isolation").

    Each tenant owns a FIFO deque (stream begin/chunk/finish items ride
    their tenant's deque, so per-stream ordering is preserved — streams
    are single-tenant by construction).  ``get`` serves the tenant at
    the head of the active ring while its deficit covers the head
    item's cost (``1 + scan_bytes/QUANTUM_BYTES``); an exhausted tenant
    rotates to the back and the next head earns one quantum x its
    configured weight.  Small requests therefore interleave ~one per
    tenant per round, large bodies consume multiple rounds — byte-
    weighted fairness at request granularity.

    Caps: ``cap`` bounds the whole queue (queue.Full, the
    single-queue contract); ``tenant_cap`` bounds each sub-queue (TenantFull) so one
    tenant cannot own the shared budget.  With a single tenant ever
    seen the structure degenerates to one deque popped FIFO with no
    deficit bookkeeping — the pre-tenant fast path, byte-identical
    drain order.

    Locking mirrors queue.Queue: one lock + a not-empty condition."""

    def __init__(self, cap: int, tenant_cap: int = 0,
                 weights: Optional[Dict[int, float]] = None,
                 quantum: float = 1.0):
        self.cap = cap
        self.tenant_cap = tenant_cap or cap
        self.weights = dict(weights or {})
        self.quantum = quantum
        self._lock = named_lock("_TenantFairQueue._lock")
        self._not_empty = threading.Condition(self._lock)
        self._qs: Dict[int, deque] = {}
        self._ring: deque = deque()          # active tenant ids, DRR order
        self._deficit: Dict[int, float] = {}
        self._size = 0
        #: sticky: a second DISTINCT tenant has been seen — consumers
        #: (ladder-signal fast path) key their single-tenant shortcut
        #: on this, never on a transiently-empty sub-queue set
        self.seen_multi = False
        self._first_tenant: Optional[int] = None

    def qsize(self) -> int:
        return self._size

    def tenant_depth(self, tenant: int) -> int:
        q = self._qs.get(tenant)
        return len(q) if q is not None else 0

    def depths(self) -> Dict[int, int]:
        with self._lock:
            return {t: len(q) for t, q in self._qs.items()}

    def effective_depth(self, tenant: int, exclude=()) -> int:
        """Queue-math depth for a NEW arrival of ``tenant`` under DRR:
        its own backlog plus the slice of other tenants' backlog the
        round robin will interleave before it drains — bounded both by
        what those tenants actually have queued and by their fair share
        against ``own + 1`` items.  ``exclude`` names tenants whose
        backlog should not count against this arrival (quarantined
        tenants: their items are served prefilter-only, a fraction of a
        full-detection item's service time — charging them at full
        weight shed victims the flood never actually delayed).  Single
        tenant: exactly the global depth, exactly the single-queue
        math."""
        with self._lock:
            q = self._qs.get(tenant)
            own = len(q) if q is not None else 0
            n_active = len(self._qs)
            if not own or n_active <= 1:
                return own
            others = self._size - own
            n_others = n_active - 1
            for t in exclude:
                if t == tenant:
                    continue
                oq = self._qs.get(t)
                if oq is not None:
                    others -= len(oq)
                    n_others -= 1
            if others <= 0 or n_others <= 0:
                return own
            return own + min(others, (own + 1) * n_others)

    def _weight(self, tenant: int) -> float:
        return self.weights.get(tenant, 1.0)

    def put_nowait(self, item, tenant: int = 0, cost_bytes: int = 0) -> None:
        cost = 1.0 + cost_bytes / QUANTUM_BYTES
        with self._not_empty:
            if self._size >= self.cap:
                raise queue.Full
            q = self._qs.get(tenant)
            if q is None:
                if self._first_tenant is None:
                    self._first_tenant = tenant
                elif tenant != self._first_tenant:
                    self.seen_multi = True
                q = self._qs[tenant] = deque()
                self._ring.append(tenant)
                # a newly active tenant starts with one round's quantum
                # so light traffic never waits out a full rotation
                self._deficit[tenant] = self.quantum * self._weight(tenant)
            elif len(q) >= self.tenant_cap:
                raise TenantFull
            q.append((item, cost))
            self._size += 1
            self._not_empty.notify()

    def _pop_locked(self):
        if len(self._ring) == 1:
            # single active tenant: plain FIFO, no deficit bookkeeping
            t = self._ring[0]
            q = self._qs[t]
            item, _cost = q.popleft()
            self._size -= 1
            if not q:
                self._ring.clear()
                del self._qs[t]
                self._deficit.pop(t, None)
            return item
        while True:
            t = self._ring[0]
            q = self._qs[t]
            cost = q[0][1]
            if self._deficit[t] >= cost:
                self._deficit[t] -= cost
                item, _cost = q.popleft()
                self._size -= 1
                if not q:
                    self._ring.popleft()
                    del self._qs[t]
                    del self._deficit[t]
                return item
            # head exhausted its round: rotate, grant the next tenant
            # its quantum (weights are floored positive at parse — the
            # rotation always terminates)
            self._ring.rotate(-1)
            nt = self._ring[0]
            self._deficit[nt] += self.quantum * self._weight(nt)

    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if not self._size:
                if timeout is None:
                    while not self._size:
                        self._not_empty.wait()
                else:
                    endtime = time.monotonic() + timeout
                    while not self._size:
                        remaining = endtime - time.monotonic()
                        if remaining <= 0:
                            raise queue.Empty
                        self._not_empty.wait(remaining)
            return self._pop_locked()

    def get_nowait(self):
        with self._not_empty:
            if not self._size:
                raise queue.Empty
            return self._pop_locked()


class _MeshCycle:
    """One in-flight mesh dispatch cycle: launched on the lanes,
    finalized one drain later (the double buffer)."""

    __slots__ = (
        "cid", "t0", "guard", "route", "pipeline", "ro", "cand_items",
        "lane_parts", "fallback_items", "finish_verdicts", "deg_done",
        "n_reqs", "n_finishes", "n_stream_items", "min_ts",
        "max_queue_delay_us", "engine_us0", "confirm_us0", "prep_us0",
        "compiles0", "launch_d_engine", "launch_d_prep",
        "launch_d_compiles", "overlap_drain_s",
        # confirm-overlap phase state (docs/CONFIRM_PLANE.md): shares
        # whose scan collected and confirm launched, the verdicts
        # already resolved during collection, and the collection
        # window's stage deltas (folded into the trace at resolve)
        "pending_fins", "done", "cand_verdicts", "cand_served",
        "collect_d_engine", "collect_d_confirm", "collect_d_prep",
        "collect_d_compiles",
    )

    def __init__(self):
        self.overlap_drain_s = 0.0
        self.cid = 0   # flight-recorder cycle id (stats.batches stamp)
        # the canary share (none unless a rollout ramp splits one off)
        self.ro = None
        self.cand_items: List = []
        self.cand_verdicts: List = []
        self.cand_served = False


class _CycleGuard:
    """One armed dispatch cycle the watchdog monitor backstops: the
    futures to release fail-open if the cycle blows past its grace.
    With the double-buffered mesh loop up to two cycles are armed at
    once (the launched-but-not-finalized one plus the one being
    launched), so guards live in a list instead of a single slot."""

    __slots__ = ("deadline", "items", "fired")

    def __init__(self, deadline: float, items: List):
        self.deadline = deadline
        self.items = items      # [(request_id, future), ...]
        self.fired = False


@dataclass
class BatcherStats:
    submitted: int = 0
    completed: int = 0
    batches: int = 0
    max_batch_seen: int = 0
    queue_delay_us_sum: int = 0
    batch_us_sum: int = 0
    # batches that exceeded hard_deadline_s: verdicts were still delivered
    # (late); the CLIENT side (nginx shim) enforces its own fail-open
    # budget — this counter is the server-side visibility of overruns.
    deadline_overruns: int = 0
    # streaming-body path (config #5)
    streams: int = 0
    stream_chunks: int = 0
    stream_bytes: int = 0
    # non-streamed requests whose body exceeded the batched L tiers and
    # was auto-routed through the stream engine
    oversized_rerouted: int = 0
    # fail-safe plane (docs/ROBUSTNESS.md)
    hangs: int = 0                 # device-lane hang-budget overruns
    cpu_fallback_batches: int = 0  # batches served breaker-open (CPU)
    # breaker-open batches of a pipeline on a card: failed open, never
    # moved to the host (see Batcher._cpu_fallback_ok)
    breaker_fail_open_batches: int = 0
    watchdog_released: int = 0     # futures force-released by the monitor
    #: admission-side counters (submitted / stream ingress) are bumped
    #: by ARBITRARY caller threads (Batcher.submit is a declared
    #: thread-safe API), so those bumps serialize on this lock — the
    #: dispatch-thread-only counters stay lock-free single-writer
    _lock: threading.Lock = field(
        default_factory=lambda: named_lock("BatcherStats._lock"),
        repr=False, compare=False)

    def count_submitted(self) -> None:
        with self._lock:
            self.submitted += 1

    def count_stream_begin(self) -> None:
        with self._lock:
            self.streams += 1

    def count_stream_chunk(self, nbytes: int) -> None:
        with self._lock:
            self.stream_chunks += 1
            self.stream_bytes += nbytes

    def snapshot(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "_lock"}
        if self.batches:
            d["avg_batch"] = self.completed / self.batches
            d["avg_batch_us"] = self.batch_us_sum / self.batches
        if self.completed:
            d["avg_queue_delay_us"] = self.queue_delay_us_sum / self.completed
        return d


class Batcher:
    # bodies longer than the largest batched L tier are auto-routed
    # through the StreamEngine (state-carried chunk scan): without this a
    # non-streamed giant body would be scanned only in its first 16KB —
    # an attacker could simply pad (the reference module scans the whole
    # buffered body the same way†)
    OVERSIZE_THRESHOLD = DetectionPipeline.L_BUCKETS[-1]
    OVERSIZE_CHUNK = 64 << 10

    def __init__(
        self,
        pipeline: DetectionPipeline,
        max_batch: int = 256,
        max_delay_s: float = 0.0005,
        hard_deadline_s: float = 0.25,
        queue_cap: int = 8192,
        hang_budget_s: float = 30.0,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 5.0,
        n_lanes: int = 1,
        lane_devices=None,
        tenant_queue_cap: int = 0,
        tenant_weights: Optional[Dict[int, float]] = None,
        tenant_guard="prefilter_only",
    ):
        self.pipeline = pipeline
        self.stream_engine = StreamEngine(pipeline)
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.hard_deadline_s = hard_deadline_s
        self.queue_cap = queue_cap
        # hang budget: generous by default — the kernels are built and
        # loaded at engine construction, but an unwarmed lane still pays
        # its first table copies and library handles on its first
        # dispatch, and a false hang would trip the breaker on startup
        # (--hang-budget-ms).
        self.hang_budget_s = hang_budget_s
        self.stats = BatcherStats()
        # per-batch span records for /traces (SURVEY.md §5 tracing)
        self.traces = TraceRing()
        # latency-attribution layer: per-stage µs histograms
        # rendered at /metrics as ipt_stage_us{stage=...}, a batch-size
        # distribution, and the K slowest requests served at /debug/slow
        self.hist: dict = {s: Histogram() for s in STAGES}
        self.batch_size_hist = Histogram(bounds=BATCH_SIZE_BUCKETS)
        self.slow = SlowRing(capacity=32)
        # fail-safe plane (docs/ROBUSTNESS.md): BOUNDED admission queue,
        # per-cycle service-time EWMA (the queue math deadline shedding
        # divides by), brownout ladder thresholds derived from the serve
        # deadline, watchdogged device lane + circuit breaker, and a
        # monitor thread backstopping the dispatch thread itself
        # tenant-fair admission (docs/ROBUSTNESS.md "Tenant isolation"):
        # per-tenant DRR sub-queues + the flood guard.  tenant_queue_cap
        # 0 = the global cap (single-tenant behavior unchanged);
        # tenant_guard accepts a policy string ("prefilter_only" |
        # "fail_open"), a TenantGuardConfig, or None/"off"
        self._q = _TenantFairQueue(queue_cap, tenant_cap=tenant_queue_cap,
                                   weights=tenant_weights)
        if tenant_guard in (None, "off"):
            self.tenant_guard: Optional[TenantGuard] = None
        elif isinstance(tenant_guard, TenantGuardConfig):
            self.tenant_guard = TenantGuard(tenant_guard)
        elif isinstance(tenant_guard, TenantGuard):
            self.tenant_guard = tenant_guard
        else:
            self.tenant_guard = TenantGuard(
                TenantGuardConfig(policy=str(tenant_guard)))
        if self.tenant_guard is not None:
            self.tenant_guard.configure_depth(self._q.tenant_cap)
        self._batch_ewma = Ewma(alpha=0.2)
        self._batch_ewma_n = 0   # samples seen; shedding needs a floor
        self.pipeline.load_controller.configure_deadline(hard_deadline_s)
        # per-device lane plane (serve/lanes.py, docs/MESH_SERVING.md):
        # n_lanes == 1 is the classic single-lane fail-safe plane (the
        # pool's primary breaker IS self.breaker); n_lanes > 1 shards
        # each cycle across per-device lanes behind this one admission
        # queue.  lane_devices defaults to every CUDA card when the
        # engine runs on one, else to the engine's own device (lanes
        # on one CPU still isolate faults).
        if lane_devices is None:
            dev = pipeline.engine.device
            if n_lanes > 1 and dev.type == "cuda":
                lane_devices = [torch.device("cuda", i)
                                for i in range(torch.cuda.device_count())]
            else:
                lane_devices = [dev]
        self.lanes = LanePool(n_lanes=n_lanes, devices=lane_devices,
                              failure_threshold=breaker_failures,
                              cooldown_s=breaker_cooldown_s)
        # armed dispatch cycles — the monitor releases a cycle's futures
        # fail-open when it blows past its grace (the double-buffered
        # mesh loop keeps up to two armed at once)
        self._active_guards: List[_CycleGuard] = []
        # a pooled confirm phase adds its own bounded wait to a cycle's
        # worst-case life (join_confirm's shared deadline) — the
        # monitor's grace must cover it or a merely-slow confirm would
        # read as a wedged dispatcher; inline pools add nothing
        confirm_grace = (pipeline.confirm_pool.hang_budget_s
                         if pipeline.confirm_pool.n_workers > 1 else 0.0)
        self._watch_grace = (2.0 * hang_budget_s + hard_deadline_s + 1.0
                             + confirm_grace)
        self._stop = threading.Event()
        self._swap_lock = named_lock("Batcher._swap_lock")
        # guarded-rollout controller (control/rollout.py), attached by
        # the serve layer; None keeps the clean path at two attribute
        # reads per cycle (docs/ROBUSTNESS.md "Guarded rollout")
        self.rollout = None
        # silent-thread-death repair: uncaught exceptions in
        # ANY worker thread count into ipt_thread_uncaught_total{thread=}
        # and surface in /healthz — the runtime counterpart of
        # concheck's lifecycle lint
        install_thread_excepthook()
        self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                          name="ipt-watchdog")
        self._watchdog.start()
        # oversized-body side lane (a 16MB inflate+scan
        # inline under the swap lock head-of-line-blocked every queued
        # request in that batch cycle).  Bounded: a flood of oversized
        # bodies fails open instead of queueing unbounded inflate work.
        self._oversized_q: "queue.Queue" = queue.Queue(maxsize=8)
        # per-tenant occupancy of the side queue (tenant isolation,
        # docs/ROBUSTNESS.md): one tenant may hold at most half the
        # slots, so an oversized-body flood cannot fail-open another
        # tenant's oversized request.  Lock shared by the dispatch
        # thread (submit side) and the oversized worker (release side).
        self._oversized_by_tenant: Dict[int, int] = {}
        self._oversized_lock = named_lock("Batcher._oversized_lock")
        self._oversized_thread = threading.Thread(
            target=self._run_oversized, daemon=True, name="ipt-oversized")
        self._oversized_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ipt-batcher")
        self._thread.start()

    # ------------------------------------------------------------- API

    @property
    def breaker(self) -> CircuitBreaker:
        """The PRIMARY lane's breaker — the single-lane fail-safe
        plane's breaker object, unchanged (the single-lane contract: /readyz, the
        oversized side lane and the bench's robustness block read it).
        Multi-lane consumers read per-lane state from ``lanes``."""
        return self.lanes.primary.breaker

    def device_available(self) -> bool:
        """Readiness view across the lane plane: at least one lane can
        (or wants to, probe_due) take device work."""
        return self.lanes.any_available()

    def reset_latency_observations(self) -> None:
        """Zero the stage histograms, the slow-exemplar ring, AND the
        detection-plane telemetry (RuleStats + device-efficiency group).
        Bench legs call this after warmup so every scraped observation
        layer — stage_breakdown and rule_stats alike — describes ONLY
        the measured traffic, not the synthetic warmup corpus or its
        first-dispatch loads.

        Under the swap lock: the resets rebind the efficiency dicts and
        per-lane stats that the dispatch thread mutates under this same
        lock — a bare reset would race a mid-cycle fold."""
        for h in self.hist.values():
            h.reset()
        self.batch_size_hist.reset()
        self.slow.reset()
        # the flight recorder rides the same post-warmup reset: the
        # overlap report must describe ONLY the measured traffic, not
        # warmup's first-load cycles (rings re-arm lazily)
        flight.reset()
        with self._swap_lock:
            for lane in self.lanes.lanes:
                lane.stats = type(lane.stats)()
            self.pipeline.reset_detection_observations()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def _est_wait_s(self, depth: int) -> float:
        """Queue math for admission-time deadline shedding: batches
        ahead of a new arrival x the EWMA cycle time, plus one cycle
        for the dispatch already in flight.  Zero until the estimator
        has a sample floor — never shed on a cold (or nearly cold,
        first-cycle-seeded) estimator."""
        if self._batch_ewma_n < 8:
            return 0.0
        per_batch = self._batch_ewma.get(0.0)
        if per_batch <= 0.0:
            return 0.0
        batches_ahead = (depth + self.max_batch - 1) // self.max_batch
        return (batches_ahead + 1) * per_batch

    def _shed(self, request: Request, fut: "Future[Verdict]",
              reason: str, tenant: Optional[int] = None) -> "Future[Verdict]":
        """Fail a request open AT ADMISSION (no queue slot, no device
        time): the wallarm-fallback answer to overload — detection
        degrades, traffic does not.  Shed verdicts carry
        ``degraded=True`` and count in stats.degraded alongside the
        ladder's verdicts (Verdict.degraded contract).  ``tenant``
        charges the shed to that tenant's guard counters."""
        st = self.pipeline.stats
        st.count_fail_open()
        st.count_degraded()
        st.count_shed(reason)
        if tenant is not None and self.tenant_guard is not None:
            self.tenant_guard.on_shed(tenant, reason)
        v = _fail_open_verdict(request.request_id)
        v.degraded = True
        _safe_set(fut, v)
        return fut

    def submit(self, request: Request) -> "Future[Verdict]":
        fut: "Future[Verdict]" = Future()
        self.stats.count_submitted()
        lc = self.pipeline.load_controller
        tenant = request.tenant
        # flight recorder: the admission end of the request flow — the
        # verdict end (EV_VERDICT, dispatch thread) closes the arrow
        flight.instant(EV_SUBMIT, cycle=0,
                       tag=request_tag(request.request_id), arg=tenant)
        g = self.tenant_guard
        glevel = 0
        if g is not None:
            # arrival accounting BEFORE any shed decision: the guard's
            # share math must see the whole offered load, not just what
            # admission accepted
            glevel = g.observe_arrival(tenant,
                                       depth=self._q.tenant_depth(tenant))
        if lc.level >= 2:
            # brownout floor: the ladder already decided no scan work
            # is affordable — don't even take a queue slot
            return self._shed(request, fut, "brownout", tenant)
        if glevel >= 2:
            # tenant-guard fail-open policy: the quarantined tenant's
            # traffic sheds at admission, everyone else unaffected
            return self._shed(request, fut, "tenant_flood", tenant)
        depth = self._q.effective_depth(
            tenant, exclude=g.quarantined_ids() if g is not None else ())
        if depth and self._est_wait_s(depth) > self.hard_deadline_s:
            # would miss the deadline by queue math: shed NOW, not
            # after wasting a dispatch slot on a verdict nobody waits
            # for (the client side has long since failed open).  The
            # depth is the TENANT's own DRR backlog (+ fair-share
            # interleave), so a flooding tenant sheds its own tail
            # while a victim with an empty sub-queue always admits.
            return self._shed(request, fut, "deadline", tenant)
        kind = "req_deg" if glevel == 1 else "req"
        try:
            self._q.put_nowait((kind, time.perf_counter(), request, fut),
                               tenant=tenant,
                               cost_bytes=len(request.body)
                               + len(request.uri))
        except TenantFull:
            return self._shed(request, fut, "tenant_queue_full", tenant)
        except queue.Full:
            return self._shed(request, fut, "queue_full", tenant)
        if g is not None:
            g.on_admit(tenant)
        return fut

    # ------------------------------------------- oversized-body reroute
    # All probing/unpacking happens on the DISPATCH thread (in _run) —
    # never on the caller, which is the server's event-loop thread: a
    # 16MB inflate there would stall every other connection.

    def _reroute_plan(self, request: Request):
        """None → normal batched path; ("raw"|"unpack", body, headers) →
        feed through the stream engine instead (no silent 16KB
        truncation).  Runs on the dispatch thread: only the size check
        and the BOUNDED inflate probe (cut just past the tier cap)
        happen here — the full inflate is deferred to the oversized
        worker, off the batch-critical path."""
        body = request.body
        if not body:
            return None
        if len(body) > self.OVERSIZE_THRESHOLD:
            return "raw", body, request.headers
        # a small compressed body can inflate past the tier cap (zip-pad
        # evasion), and extraction segments can push a near-cap body
        # over; probe the unpacked size only when that's possible — the
        # probe is bounded just past the cap, so it never materializes a
        # full 16MB inflate for an in-tier body
        if (body[:2] == GZIP_MAGIC
                or "content-encoding" in (k.lower()
                                          for k in request.headers)
                or 4 * len(body) + 64 > self.OVERSIZE_THRESHOLD):
            probe = unpack_body(body, request.headers, request.parsers_off,
                                max_out=self.OVERSIZE_THRESHOLD + 1)
            if len(probe) > self.OVERSIZE_THRESHOLD:
                return "unpack", body, request.headers
        return None

    def _submit_oversized(self, ts: float, request: Request, plan,
                          fut: "Future[Verdict]") -> None:
        """Hand one oversized request to the side worker; a full side
        queue fails open immediately (bounded memory under a flood of
        maximum-size bodies), as does a tenant already holding half the
        side slots — the side lane is a shared scarce resource and one
        tenant's oversized flood must not fail-open a sibling's
        oversized request (tenant isolation).  ``ts`` is the original
        submit time — the side lane's verdicts feed the e2e histogram
        and slow ring like everyone else's (the likeliest slowest
        requests in the system must not be invisible to /debug/slow)."""
        tenant = request.tenant
        tenant_cap = max(1, self._oversized_q.maxsize // 2)
        ok = False
        with self._oversized_lock:
            if self._oversized_by_tenant.get(tenant, 0) < tenant_cap:
                try:
                    self._oversized_q.put_nowait((ts, request, plan, fut))
                    ok = True
                    self._oversized_by_tenant[tenant] = \
                        self._oversized_by_tenant.get(tenant, 0) + 1
                except queue.Full:
                    pass
        if not ok:
            st = self.pipeline.stats
            st.count_fail_open()
            st.count_shed("oversized_overload")
            if self.tenant_guard is not None:
                self.tenant_guard.on_shed(tenant, "oversized_overload")
            _safe_set(fut, Verdict(
                request_id=request.request_id, blocked=False, attack=False,
                classes=[], rule_ids=[], score=0, fail_open=True))

    def _release_oversized_slot(self, tenant: int) -> None:
        with self._oversized_lock:
            n = self._oversized_by_tenant.get(tenant, 0) - 1
            if n > 0:
                self._oversized_by_tenant[tenant] = n
            else:
                self._oversized_by_tenant.pop(tenant, None)

    def _run_oversized(self) -> None:
        flight.register_thread("oversized")
        while not self._stop.is_set():
            try:
                ts, request, plan, fut = self._oversized_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                flight.begin(EV_OVERSIZED, cycle=0, tag=request.tenant,
                             arg=len(request.body))
                try:
                    self._detect_oversized(ts, request, plan, fut)
                finally:
                    flight.end(EV_OVERSIZED, cycle=0,
                               tag=request.tenant)
            finally:
                self._release_oversized_slot(request.tenant)

    def _detect_oversized(self, ts: float, request: Request, plan,
                          fut: "Future[Verdict]") -> None:
        """Run one oversized request through the stream engine (the
        oversized worker thread).  The swap lock is taken per STEP, not
        for the whole body — batches interleave between chunks, so a
        16MB body adds at most one chunk-scan of latency to any cycle
        (no head-of-line blocking).  The inflate runs entirely
        off-lock.  A ruleset hot-swap mid-body is detected by the stream
        engine's version check at finish and fails open, same as
        in-flight wire streams."""
        kind, body, headers = plan
        self.stats.oversized_rerouted += 1
        if self.breaker.state != CircuitBreaker.CLOSED:
            # oversized scans ride the DEFAULT device (the stream
            # engine is not lane-pinned), whose health the PRIMARY
            # lane's breaker tracks: a suspect default device would
            # wedge this unwatchdogged worker too — fail open now.
            # Healthy sibling lanes don't help here: an any-lane-closed
            # gate would let this worker scan a wedged default device.
            self.pipeline.stats.count_fail_open()
            _safe_set(fut, _fail_open_verdict(request.request_id))
            return
        try:
            if kind == "unpack":
                # full DoS-bounded inflate + extraction, OFF the lock;
                # Content-Encoding must go, or the stream's sniffer
                # would re-inflate plaintext
                body = unpack_body(body, headers, request.parsers_off)
                headers = {k: v for k, v in headers.items()
                           if k.lower() != "content-encoding"}
            meta = replace(request, body=b"", headers=headers)
            with self._swap_lock:
                h = self.stream_engine.begin(meta, body_cap=len(body))
                h.base_hits = self.pipeline.prefilter([meta])[0]
            for i in range(0, len(body), self.OVERSIZE_CHUNK):
                inc = h.feed(body[i:i + self.OVERSIZE_CHUNK])
                with self._swap_lock:
                    self.stream_engine.scan(inc)
            with self._swap_lock:
                self.stream_engine.scan(h.flush())
                v = self.stream_engine.finish(h)
        except Exception:
            self.pipeline.stats.count_fail_open()
            v = Verdict(request_id=request.request_id, blocked=False,
                        attack=False, classes=[], rule_ids=[], score=0,
                        fail_open=True)
        _safe_set(fut, v)
        e2e_us = int((time.perf_counter() - ts) * 1e6)
        self.hist["e2e"].observe(e2e_us)
        flight.instant(EV_VERDICT, tag=request_tag(request.request_id),
                       arg=-1)
        if e2e_us > self.slow.threshold():
            # side-lane: no batch stage spans, flagged oversized instead
            self.slow.offer(e2e_us, self._exemplar(
                request, v, time.time(), 0, oversized=True,
                worker=v.confirm_worker, tenant=request.tenant,
                generation=v.generation))

    # --------------------------------------------- streaming-body API
    # (config #5).  Queue FIFO guarantees begin ≤ chunks ≤ finish order;
    # all state mutation happens on the dispatch thread.

    def begin_stream(self, request: Request) -> StreamState:
        """Register a streaming request: uri/args/headers scan happens
        now (prefilter), body arrives via feed_chunk."""
        handle = self.stream_engine.begin(request)
        self.stats.count_stream_begin()
        g = self.tenant_guard
        if g is not None:
            # streams count toward the tenant's arrival share — a
            # flood sent as MODE_STREAM requests must not be invisible
            # to the guard's budget math
            glevel = g.observe_arrival(
                request.tenant,
                depth=self._q.tenant_depth(request.tenant))
            if glevel >= 1:
                # a quarantined tenant's NEW streams fail open at
                # finish (both policies: the chunk-scan + confirm cost
                # is exactly what the quarantine exists to shed;
                # state-carried prefilter-only streaming is not a
                # thing).  In-flight streams complete normally.
                handle.error = True
                self.pipeline.stats.count_shed("tenant_flood")
                g.on_shed(request.tenant, "tenant_flood")
                return handle
        try:
            self._q.put_nowait(("begin", time.perf_counter(), handle, None),
                               tenant=request.tenant)
        except queue.Full:
            # bounded admission for streams too (TenantFull included):
            # a lost begin means the prefilter never ran — poison the
            # handle so finish resolves fail-open (exactly-one-verdict
            # invariant, no blocking put on the event-loop thread)
            handle.error = True
            self._count_stream_shed(request.tenant)
            return handle
        if g is not None:
            # an enqueued begin IS an admission — without this a
            # stream-only tenant shows admitted=0 next to nonzero
            # shed/quarantine in /tenants (arrival/admit mismatch)
            g.on_admit(request.tenant)
        return handle

    def feed_chunk(self, handle: StreamState, data: bytes) -> None:
        self.stats.count_stream_chunk(len(data))
        if handle.error:
            return
        try:
            self._q.put_nowait(("chunk", time.perf_counter(),
                                (handle, data), None),
                               tenant=handle.request.tenant,
                               cost_bytes=len(data))
        except queue.Full:
            # a dropped chunk would silently unscan part of the body:
            # poison instead, surface as fail-open at finish
            handle.error = True
            self._count_stream_shed(handle.request.tenant)

    def _count_stream_shed(self, tenant: int) -> None:
        self.pipeline.stats.count_shed("stream_overload")
        if self.tenant_guard is not None:
            self.tenant_guard.on_shed(tenant, "stream_overload")

    def finish_stream(self, handle: StreamState) -> "Future[Verdict]":
        fut: "Future[Verdict]" = Future()
        try:
            self._q.put_nowait(("finish", time.perf_counter(), handle, fut),
                               tenant=handle.request.tenant)
        except queue.Full:
            st = self.pipeline.stats
            st.count_fail_open()
            st.count_degraded()
            self._count_stream_shed(handle.request.tenant)
            v = _fail_open_verdict(handle.request.request_id)
            v.degraded = True
            _safe_set(fut, v)
        return fut

    def abort_stream(self, handle: StreamState) -> None:
        """Client went away mid-stream: drop remaining work (bool write
        is atomic; the dispatch thread skips aborted streams)."""
        handle.aborted = True

    def swap_ruleset(self, ruleset, paranoia_level=None) -> None:
        """Hot-swap (sync-node† analog), zero serve gap:

        1. OFF-lock: build a complete new pipeline and dispatch every
           (B, L, Q) shape the old pipeline has served, so post-swap
           traffic never waits on first loads inside the lock (such a
           stall is an attack window right after each ruleset update);
        2. under the lock (which the dispatch thread holds across each
           ``detect``): install the new pipeline after the in-flight
           batch finishes, re-deriving tenant masks against the new rule
           axis so EP routing survives the swap."""
        # swap_fail site BEFORE any build/mutation (fault-matrix
        # invariant: a failed swap leaves the serving generation intact)
        faults.raise_if("swap_fail")
        old = self.pipeline
        # rebuilt(): the same engine kind, impl and device on the new
        # ruleset
        new = DetectionPipeline(
            ruleset, mode=old.mode,
            anomaly_threshold=old.anomaly_threshold,
            fail_open=old.fail_open, paranoia_level=paranoia_level,
            engine=old.engine.rebuilt(ruleset))
        for shape in sorted(getattr(old, "seen_shapes", ())):
            new.warm_shape(*shape)
        # mesh lanes: the incumbent's per-lane shapes warm on the NEW
        # pack too, each lane on its own ephemeral thread so the
        # per-card table copies overlap instead of serializing in front
        # of the swap (docs/MESH_SERVING.md) — ephemeral threads, not
        # the lane workers, so live dispatches are never queued behind
        # a swap-time warm
        lane_shapes: dict = {}
        for lane_idx, buckets, q_pad, head in sorted(
                getattr(old, "seen_lane_shapes", ())):
            if lane_idx < self.lanes.n:
                lane_shapes.setdefault(lane_idx, []).append(
                    (buckets, q_pad, head))
        if lane_shapes:
            def _warm_lane(idx, shapes):
                lane = self.lanes.lane(idx)
                for buckets, q_pad, head in shapes:
                    new.warm_lane_shape(buckets, q_pad, head, lane)

            warmers = [threading.Thread(target=_warm_lane, args=(i, s),
                                        daemon=True,
                                        name="ipt-swapwarm-%d" % i)
                       for i, s in lane_shapes.items()]
            for t in warmers:
                t.start()
            # bounded join: warming is
            # best-effort — a warm wedged past the budget must not hang
            # the swap forever; the unwarmed card just pays its first
            # load at serve time, which the recompile gauge surfaces
            warm_deadline = time.monotonic() + max(
                2.0 * self.hang_budget_s, 60.0)
            for t in warmers:
                t.join(timeout=max(warm_deadline - time.monotonic(),
                                   0.001))
        new.stats = old.stats  # counters span swaps (Prometheus contract)
        # the brownout ladder's pressure signal also spans swaps — a
        # reload under load must not reset the ladder to full detection
        new.load_controller = old.load_controller
        # the confirm pool spans swaps too (docs/CONFIRM_PLANE.md): it
        # is ruleset-free, and the replacement pipeline's own default
        # (inline, thread-free) pool is simply dropped — a hot swap
        # must not orphan N worker threads per reload
        new.confirm_pool = old.confirm_pool
        new.confirm_memo_entries = old.confirm_memo_entries
        # the cross-cycle verdict cache spans swaps like the pool (its
        # keys carry the generation, so old entries can never serve the
        # new pack); dropped entries are hygiene, not soundness
        if getattr(old, "confirm_cache", None) is not None:
            old.confirm_cache.invalidate("hot_swap")
            new.confirm_cache = old.confirm_cache
        # break-glass force swap during a staged rollout: the candidate
        # generation is aborted (quarantined, reason exported) BEFORE the
        # new pack installs — after the fault site and the build, so a
        # swap that fails changes neither plane
        if self.rollout is not None:
            self.rollout.abort("force_swap")
        with self._swap_lock:
            # reload-drift snapshot: freeze the outgoing
            # version's per-rule counters at the instant it stops
            # serving — /rules/drift joins them against the new
            # generation's (fresh) RuleStats by rule id
            new.frozen_rule_stats = self.pipeline.rule_stats.freeze()
            self.pipeline = new
            # in-flight streams carry old-table state words; StreamEngine
            # detects the version change and fails them open at finish
            self.stream_engine.pipeline = new
            self._reapply_tenants()

    def set_tenant_tags(self, tags) -> None:
        """Dynamic EP-routing update (no reload): install the semantic
        tenant→rule-tags table; the (T, R) masks are derived against the
        *current* ruleset between batches."""
        with self._swap_lock:
            self.tenant_tags = dict(tags)
            self._reapply_tenants()

    def _reapply_tenants(self) -> None:
        from ingress_plus_tpu_torch.control.sync import tenant_masks

        tags = getattr(self, "tenant_tags", None)
        self.pipeline.tenant_rule_mask = (
            tenant_masks(self.pipeline.ruleset, tags) if tags else None)

    def _drain_failopen(self, reason: str) -> int:
        """Empty the MAIN queue, resolving every stranded future
        fail-open (begin/chunk items carry no future: their handles are
        poisoned so a later finish resolves fail-open too).  Used at
        shutdown and by the watchdog monitor when the dispatch thread
        is wedged — either way, nobody is going to dispatch these."""
        n = 0
        st = self.pipeline.stats
        while True:
            try:
                kind, _ts, obj, fut = self._q.get_nowait()
            except queue.Empty:
                return n
            if kind == "begin":
                obj.error = True
                continue
            if kind == "chunk":
                obj[0].error = True
                continue
            if kind in ("req", "req_deg"):
                rid, tenant = obj.request_id, obj.tenant
            else:
                rid = obj.request.request_id
                tenant = obj.request.tenant
            st.count_fail_open()
            st.count_shed(reason)
            if self.tenant_guard is not None:
                # the per-tenant sub-queues drain fail-open at shutdown
                # exactly like the main queue did (the stranded-handler
                # contract, one dimension deeper) — attributed per tenant
                self.tenant_guard.on_shed(tenant, reason)
            _safe_set(fut, _fail_open_verdict(rid))
            n += 1

    def close(self) -> None:
        if self.rollout is not None:
            self.rollout.close()
        self._stop.set()
        self._thread.join(timeout=5)
        self._oversized_thread.join(timeout=5)
        self._watchdog.join(timeout=5)
        self.lanes.close()
        self.pipeline.confirm_pool.close()
        # requests still queued at shutdown would strand their
        # connection handlers until the client times out — resolve them
        # fail-open, the same contract the oversized side lane had
        self._drain_failopen("shutdown")
        # items still queued on the side lane would strand their futures
        # (connection handlers block forever) — resolve them fail-open
        #
        while True:
            try:
                _ts, request, _plan, fut = self._oversized_q.get_nowait()
            except queue.Empty:
                break
            self.pipeline.stats.count_fail_open()
            _safe_set(fut, _fail_open_verdict(request.request_id))

    # ------------------------------------------------------------ loop

    def _drain(self, first_timeout: float = 0.05) -> List:
        """Block up to ``first_timeout`` for the first item, then
        collect until max_batch or the first item's deadline.  The
        double-buffered mesh loop drains with a tight first timeout
        while a launched cycle is still in flight — finalizing the
        previous cycle must not wait out a full idle tick."""
        try:
            first = self._q.get(timeout=first_timeout)
        except queue.Empty:
            return []
        batch = [first]
        deadline = first[1] + self.max_delay_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                # deadline hit — but if more are already queued, greedily
                # take them (they're free: no extra waiting)
                try:
                    while len(batch) < self.max_batch:
                        batch.append(self._q.get_nowait())
                except queue.Empty:
                    pass
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _stream_step_guarded(self, begins, chunks, finishes,
                             route: str, lane: Optional[Lane] = None) -> List:
        """Stream scan work rides ONE watchdogged lane (the primary, or
        the first serving lane of a mesh pool — sticky-verdict stream
        state is pinned so chunk scans never interleave across
        devices): a device wedge first hitting a stream cycle must not
        hang the dispatch thread past the hang budget (the monitor's
        much larger grace is the backstop, not the budget).  On a hang:
        this cycle's stream handles are poisoned, finishes resolve
        fail-open here, and THAT lane's breaker trips like any other
        device hang."""
        if not (begins or chunks or finishes):
            return []
        if lane is None:
            lane = self.lanes.primary
        lane.stats.stream_cycles += 1
        cid = flight.cycle()
        try:
            return lane.call(
                lambda: flight.scoped(
                    cid, self._stream_step, begins, chunks, finishes,
                    route != "fallback"),
                self.hang_budget_s)
        except DeviceHang:
            self.stats.hangs += 1
            lane.stats.hangs += 1
            lane.breaker.trip("hang")
            for h in begins:
                h.error = True
            for h, _ in chunks:
                h.error = True
            out = []
            st = self.pipeline.stats
            for h, fut in finishes:
                h.error = True
                st.count_fail_open()
                v = _fail_open_verdict(h.request.request_id)
                _safe_set(fut, v)
                out.append((h, v))
            return out

    @staticmethod
    def _cpu_fallback_ok(p: DetectionPipeline) -> bool:
        """Whether breaker-open batches may ride ``detect_cpu_only``:
        only when the pipeline itself runs on the CPU.  On a card, a
        kernel fault never moves the detection work to the host: the
        batches fail open (counted in ``breaker_fail_open_batches`` and
        the fail-open verdicts), ``/readyz`` reads 503 until the
        half-open canary closes the breaker, and the orchestrator
        routes around or restarts the process."""
        return p.engine.device.type == "cpu"

    def _detect_guarded(self, requests: List[Request],
                        route: str) -> List[Verdict]:
        """One batch through the breaker-routed device path.

        "device"/"canary" → the watchdogged lane runs detect_strict
        with the hang budget; a hang fails the batch open, trips the
        breaker and abandons the lane; an error fails the batch open
        and counts toward the breaker.  "fallback" (breaker open) →
        fails open on a card pipeline (:meth:`_cpu_fallback_ok`), else
        the CPU confirm-only path, no device touched."""
        p = self.pipeline
        lane = self.lanes.primary
        if route == "fallback":
            if not self._cpu_fallback_ok(p):
                self.stats.breaker_fail_open_batches += 1
                p.stats.count_fail_open(len(requests))
                return [_fail_open_verdict(r.request_id) for r in requests]
            self.stats.cpu_fallback_batches += 1
            return p.detect_cpu_only(requests)
        try:
            # per-device telemetry on the single-lane path too (the
            # device="0" series must describe real traffic, and the
            # 1-lane mesh-scale baseline reads busy_us for utilization
            #: these stayed zero); row deltas are safe
            # to sample here — the caller holds the swap lock
            rows0 = p.stats.live_rows
            padded0 = p.stats.padded_rows
            tb0 = time.perf_counter()
            cid = flight.cycle()
            verdicts = lane.call(
                lambda: flight.scoped(cid, p.detect_strict, requests),
                self.hang_budget_s)
            lane.breaker.record_success()
            st = lane.stats
            st.requests += len(requests)
            st.busy_us += int((time.perf_counter() - tb0) * 1e6)
            # max(…, 0): a concurrent reset_detection_observations can
            # zero the live counters mid-call — clamp, never go negative
            st.rows += max(p.stats.live_rows - rows0, 0)
            st.padded_rows += max(p.stats.padded_rows - padded0, 0)
            return verdicts
        except DeviceHang:
            # the stuck batch fails open NOW (the client-side budget is
            # long blown); the zombie lane worker is abandoned
            # (lane.call) and the breaker opens so the next batches take
            # the breaker-open route
            self.stats.hangs += 1
            lane.stats.hangs += 1
            lane.breaker.trip("hang")
        except Exception:
            # batcher-level fail-open regardless of the pipeline's own
            # fail_open flag (the serve plane's contract) — but the
            # breaker gets to COUNT the failure first, which is why this
            # path calls detect_strict rather than detect
            lane.stats.errors += 1
            lane.breaker.record_failure()
        p.stats.count_fail_open(len(requests))
        return [_fail_open_verdict(r.request_id) for r in requests]

    def _detect_candidate(self, requests: List[Request], ro,
                          route: str,
                          lane: Optional[Lane] = None
                          ) -> Tuple[List[Verdict], bool]:
        """Candidate-generation dispatch for the canary ramp
        (control/rollout.py).  Rides a watchdogged lane (the primary,
        or the mesh cycle's serving lane) and follows the cycle's
        breaker route — but failures are attributed to the CANDIDATE:
        they count toward the rollout's rollback triggers and NEVER
        toward the shared breaker, so a bad candidate pack cannot push
        the incumbent path onto its breaker-open route.

        Breaker open: a CPU candidate scans CPU-only (a suspect device
        must not be probed by the canary either); a card candidate's
        batch fails open, counted like the incumbent's
        (``breaker_fail_open_batches``), never as the candidate's.
        Returns (verdicts, counted): ``counted`` is False only for that
        card breaker-open batch, which the canary accounting skips (its
        fail-open verdicts are the incumbent path's fault, not the
        candidate's)."""
        cand = ro.candidate
        if lane is None:
            lane = self.lanes.primary
        if cand is None:
            # rolled back between split and dispatch: serve these
            # through the incumbent — the generation they now belong to
            return self._detect_guarded(requests, route), True
        if route == "fallback":
            if not self._cpu_fallback_ok(cand):
                self.stats.breaker_fail_open_batches += 1
                self.pipeline.stats.count_fail_open(len(requests))
                return [_fail_open_verdict(r.request_id)
                        for r in requests], False
            return cand.detect_cpu_only(requests), True
        try:
            cid = flight.cycle()
            return lane.call(
                lambda: flight.scoped(cid, cand.detect_strict, requests),
                self.hang_budget_s), True
        except DeviceHang:
            self.stats.hangs += 1
            lane.stats.hangs += 1
            ro.record_candidate_failure("hang")
        except Exception:
            ro.record_candidate_failure("error")
        self.pipeline.stats.count_fail_open(len(requests))
        return [_fail_open_verdict(r.request_id) for r in requests], True

    def _arm_guard(self, t0: float, items: List) -> _CycleGuard:
        g = _CycleGuard(t0 + self._watch_grace, items)
        self._active_guards.append(g)
        return g

    def _classify_batch(self, batch: List, t0: float):
        """Shared cycle prologue (single-lane loop AND mesh launch —
        one copy, not two drifting ones): split the drained items by
        kind, book the admission counters, arm the watchdog guard.
        Returns (reqs, deg_reqs, begins, chunks, finishes, guard) —
        ``deg_reqs`` are quarantined tenants' requests ("req_deg"),
        served prefilter-only off the full-detection path."""
        self.stats.batches += 1
        reqs = [(ts, r, fut) for k, ts, r, fut in batch if k == "req"]
        deg_reqs = [(ts, r, fut) for k, ts, r, fut in batch
                    if k == "req_deg"]
        begins = [h for k, _, h, _ in batch if k == "begin"]
        chunks = [pair for k, _, pair, _ in batch if k == "chunk"]
        finishes = [(h, fut) for k, _, h, fut in batch if k == "finish"]
        self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                        len(reqs) + len(deg_reqs))
        for ts, _, _ in reqs:
            self.stats.queue_delay_us_sum += int((t0 - ts) * 1e6)
        for ts, _, _ in deg_reqs:
            self.stats.queue_delay_us_sum += int((t0 - ts) * 1e6)
        items = [(r.request_id, fut) for _ts, r, fut in reqs]
        items += [(r.request_id, fut) for _ts, r, fut in deg_reqs]
        items += [(h.request.request_id, fut) for h, fut in finishes]
        if flight.enabled:
            # flight recorder: one queue-wait instant per tenant
            # sub-queue this cycle (tag=tenant, arg=max wait µs) — the
            # fair-queue dimension the aggregate queue histogram folds
            per_tenant: Dict[int, float] = {}
            for k, ts, obj, _f in batch:
                t = self._item_tenant(k, obj)
                d = t0 - ts
                if d > per_tenant.get(t, -1.0):
                    per_tenant[t] = d
            cid = self.stats.batches
            for t, d in per_tenant.items():
                flight.instant(EV_QUEUE, cycle=cid, tag=t,
                               arg=int(d * 1e6))
        return (reqs, deg_reqs, begins, chunks, finishes,
                self._arm_guard(t0, items))

    @staticmethod
    def _item_tenant(kind: str, obj) -> int:
        if kind == "chunk":
            return obj[0].request.tenant
        if kind in ("begin", "finish"):
            return obj.request.tenant
        return obj.tenant

    def _ladder_signal(self, batch: List, t0: float) -> float:
        """Queue-delay pressure (µs) for the GLOBAL brownout ladder.

        Single tenant ever seen: the oldest item's wait — exactly the
        single-tenant signal.  Multi-tenant: the MIN over non-quarantined
        tenants of each tenant's own max wait.  Under fair admission a
        flooding tenant delays only its OWN sub-queue, so the global
        ladder sees pressure only when EVERY (non-quarantined) tenant
        is delayed — i.e. aggregate overload; a single-tenant flood can
        no longer brown out the box (pinned by test).  The fair min
        does NOT depend on the guard — ``--tenant-guard off`` disables
        quarantining, not fairness.  A cycle whose items all belong to
        quarantined tenants contributes zero: their delay is the
        guard's business, not the ladder's."""
        if not self._q.seen_multi:
            return max(((t0 - ts) * 1e6 for _, ts, _, _ in batch),
                       default=0.0)
        g = self.tenant_guard
        per: Dict[int, float] = {}
        for k, ts, obj, _f in batch:
            t = self._item_tenant(k, obj)
            d = (t0 - ts) * 1e6
            if d > per.get(t, -1.0):
                per[t] = d
        eligible = [d for t, d in per.items()
                    if g is None or not g.is_quarantined(t)]
        if not eligible:
            return 0.0
        return min(eligible)

    def _detect_tenant_degraded(self, deg_reqs: List, done: List,
                                route: str = "device",
                                lane: Optional[Lane] = None) -> None:
        """Serve quarantined tenants' admitted requests prefilter-only
        (the guard's per-tenant brownout rung — caller holds the swap
        lock).  The prefilter still dispatches to the device, so the
        work rides a watchdogged lane exactly like the stream step: a
        hang fails only this share open and trips THAT lane's breaker;
        breaker-open cycles skip the device outright (a quarantined
        tenant does not get to probe a wedged card).  Resolves the
        futures, appends done-entries, books per-tenant degraded
        counters."""
        if not deg_reqs:
            return
        dreqs = [r for _, r, _ in deg_reqs]
        p = self.pipeline
        verdicts: Optional[List[Verdict]] = None
        if route != "fallback":
            if lane is None:
                lane = self.lanes.primary
            try:
                cid = flight.cycle()
                verdicts = lane.call(
                    lambda: flight.scoped(cid, p.detect_tenant_degraded,
                                          dreqs),
                    self.hang_budget_s)
            except DeviceHang:
                self.stats.hangs += 1
                lane.stats.hangs += 1
                lane.breaker.trip("hang")
            except Exception:
                lane.stats.errors += 1
                lane.breaker.record_failure()
        if verdicts is None:
            p.stats.count_fail_open(len(dreqs))
            p.stats.count_degraded(len(dreqs))
            verdicts = []
            for r in dreqs:
                v = _fail_open_verdict(r.request_id)
                v.degraded = True
                verdicts.append(v)
        g = self.tenant_guard
        for (ts, r, fut), v in zip(deg_reqs, verdicts):
            _safe_set(fut, v)
            done.append((ts, r, v, 0))
            if g is not None:
                g.on_degraded(r.tenant)

    def _clear_guard(self, guard: _CycleGuard) -> None:
        try:
            self._active_guards.remove(guard)
        except ValueError:
            pass

    def _run(self) -> None:
        flight.register_thread("dispatch")
        if self.lanes.n > 1:
            self._run_mesh()
            return
        while not self._stop.is_set():
            flight.set_cycle(0)
            flight.begin(EV_DRAIN)
            batch = self._drain()
            flight.end(EV_DRAIN)
            if not batch:
                # idle drain: feed the brownout ladder a zero so the
                # queue-delay EWMA decays and the ladder can step back
                # down once pressure is gone
                self.pipeline.load_controller.observe(0.0)
                continue
            t0 = time.perf_counter()
            # prologue + arm the monitor: if THIS cycle wedges past
            # every budget, the watchdog releases its futures fail-open
            reqs, deg_reqs, begins, chunks, finishes, guard = \
                self._classify_batch(batch, t0)
            # flight recorder: the cycle envelope — every span below
            # stitches to this id (stats.batches, the cycle counter)
            cid = self.stats.batches
            flight.set_cycle(cid)
            flight.begin(EV_CYCLE, cycle=cid,
                         arg=len(reqs) + len(deg_reqs))
            # one breaker decision per cycle: requests AND stream scan
            # work follow it (a wedged device must not be probed twice)
            route = self.breaker.route()
            done: List = []   # (submit_ts, request, verdict) this cycle
            with self._swap_lock:
                # stage-delta capture INSIDE the lock: the oversized
                # side worker also mutates pipeline stats (under this
                # lock, per step) — sampling outside would attribute its
                # work to this batch's stage histograms
                ps = self.pipeline.stats
                engine_us0, confirm_us0 = ps.engine_us, ps.confirm_us
                prep_us0 = ps.prep_us
                compiles0 = ps.engine_compiles
                finish_verdicts = self._stream_step_guarded(
                    begins, chunks, finishes, route)
                # quarantined tenants' share: prefilter-only, before
                # the canary split (the candidate generation must never
                # serve tenant-degraded traffic — its rollback triggers
                # key on verdict quality)
                self._detect_tenant_degraded(deg_reqs, done, route)
                # partition: oversized bodies go through the stream
                # engine inline; everything else batches as usual
                normal = []
                for item in reqs:
                    ts, r, fut = item
                    try:
                        plan = self._reroute_plan(r)
                    except Exception:
                        plan = None   # fall back to the batched path
                    if plan is not None:
                        self._submit_oversized(ts, r, plan, fut)
                    else:
                        normal.append(item)
                # canary generation split (control/rollout.py): during a
                # ramp, the deterministic request-id hash sends this
                # cycle's share of requests through the CANDIDATE
                # pipeline instead — each request is served by exactly
                # one generation; idle rollout = one attribute read
                ro = self.rollout
                cand_items: List = []
                if ro is not None and ro.canary_active:
                    normal, cand_items = ro.split(normal)
                requests = [r for _, r, _ in normal]
                if requests:
                    try:
                        verdicts = self._detect_guarded(requests, route)
                    except Exception:
                        verdicts = [_fail_open_verdict(r.request_id)
                                    for r in requests]
                    for (ts, r, fut), v in zip(normal, verdicts):
                        _safe_set(fut, v)
                        done.append((ts, r, v, 0))
                cand_verdicts: List[Verdict] = []
                cand_served = False
                if cand_items:
                    creqs = [r for _, r, _ in cand_items]
                    try:
                        cand_verdicts, cand_served = self._detect_candidate(
                            creqs, ro, route)
                    except Exception:
                        cand_verdicts = [_fail_open_verdict(r.request_id)
                                         for r in creqs]
                        cand_served = True
                    for (ts, r, fut), v in zip(cand_items, cand_verdicts):
                        _safe_set(fut, v)
                        done.append((ts, r, v, 0))
                # end-delta sample, still under the lock (stats object
                # survives hot-swaps; the side lane can't interleave)
                ps = self.pipeline.stats
                d_engine = ps.engine_us - engine_us0
                d_confirm = ps.confirm_us - confirm_us0
                d_prep = ps.prep_us - prep_us0
                d_compiles = ps.engine_compiles - compiles0
            self._clear_guard(guard)
            flight.end(EV_CYCLE, cycle=cid)
            # rollout hooks OFF the swap lock: shadow mirroring (never
            # on the verdict path — the futures above already resolved),
            # canary accounting, and the deferred-promotion pump (tick
            # needs the swap lock the dispatch thread just released)
            if ro is not None:
                self._rollout_hooks(ro, done, cid,
                                    cand_verdicts if cand_served else None)
            t_end = time.perf_counter()
            took = t_end - t0
            # fail-safe plane signals: cycle-time EWMA feeds the
            # admission queue math; the oldest request's queue delay
            # feeds the brownout ladder.  Cycles that paid a serve-time
            # first load are EXCLUDED from both — a cold start is
            # warmup, not load, and folding its stall into the
            # service-rate estimate would make admission shed (and the
            # ladder brown out) every request behind a first dispatch
            if d_compiles == 0:
                # clamp the service-time sample too: a cycle that blew
                # past 2x the deadline is a stall (a first load, a CPU
                # pause), not the steady-state service rate — a
                # genuinely slow plane still converges well above the
                # shed horizon
                self._batch_ewma.update(
                    min(took, 2.0 * self.hard_deadline_s))
                self._batch_ewma_n += 1
                self.pipeline.load_controller.observe(
                    self._ladder_signal(batch, t0))
            self.stats.batch_us_sum += int(took * 1e6)
            n_served = len(reqs) + len(deg_reqs) + len(finishes)
            if took > self.hard_deadline_s:
                self.stats.deadline_overruns += n_served
            self.stats.completed += n_served
            batch_us = int(took * 1e6)
            trace = BatchTrace(
                ts=time.time(),
                n_requests=len(reqs) + len(deg_reqs),
                n_stream_items=len(begins) + len(chunks) + len(finishes),
                queue_delay_us=int((t0 - min(ts for _, ts, _, _ in batch))
                                   * 1e6),
                batch_us=batch_us,
                engine_us=d_engine,
                confirm_us=d_confirm,
                prep_us=d_prep,
                # only requests this batch actually scanned (`normal` +
                # the tenant-degraded prefilter-only share + stream
                # finishes): an oversized-rerouted id here would make
                # /traces/request attribute the side lane's work to
                # this batch's spans — those ids resolve via their
                # /debug/slow exemplar instead
                request_ids=[r.request_id for _, r, _ in normal]
                + [r.request_id for _, r, _ in cand_items]
                + [r.request_id for _, r, _ in deg_reqs]
                + [h.request.request_id for h, _ in finish_verdicts])
            self.traces.record(trace)
            self._observe(trace, done, finish_verdicts, t0, t_end)

    @staticmethod
    def _rollout_hooks(ro, done, cid: int, cand_verdicts) -> None:
        """A cycle's rollout hooks, off the swap lock: mirror the
        resolved verdicts into the shadow lane, account the candidate's
        canary share (``cand_verdicts`` None: no share it answered), and
        pump a deferred promotion."""
        if ro.shadow_active:
            flight.begin(EV_MIRROR, cycle=cid, arg=len(done))
            for _ts, r, v, _lane in done:
                ro.mirror(r, v)
            flight.end(EV_MIRROR, cycle=cid)
        if cand_verdicts:
            ro.observe_canary(len(cand_verdicts), cand_verdicts)
        ro.tick()

    # ------------------------------------------------- mesh (N lanes)

    def _run_mesh(self) -> None:
        """Double-buffered per-lane dispatch loop (docs/MESH_SERVING.md)
        — the mesh-mode twin of ``_run``.  Software-pipelined with
        depth 1: cycle N's device dispatch is launched asynchronously
        on the lane workers, then THIS thread drains and preps cycle
        N+1 (normalize/pad/pack — the host-CPU cost) while the cards
        crunch, and only then finalizes N (bounded per-lane waits,
        confirm, verdict futures).  Under load the host prep and the
        device scan fully overlap; idle, the pending cycle finalizes
        after at most one batch window.

        With ``--confirm-workers`` > 1 the pipeline deepens one more
        stage (docs/CONFIRM_PLANE.md): collecting cycle N launches its
        confirm on the pool workers and the verdicts resolve one drain
        later — so cycle N's CPU confirm overlaps cycle N+1's device
        scan, exactly the move that overlaps host→device transfer
        above.  The extra stage only engages while a next cycle is in
        flight; an idle tail resolves immediately."""
        pending: Optional[_MeshCycle] = None     # scan in flight
        confirming: Optional[_MeshCycle] = None  # confirm in flight
        while not self._stop.is_set():
            if pending is None and confirming is None:
                flight.set_cycle(0)
                flight.begin(EV_DRAIN)
                batch = self._drain()
                flight.end(EV_DRAIN)
                if not batch:
                    # idle drain: decay the brownout ladder's signal
                    self.pipeline.load_controller.observe(0.0)
                    continue
            else:
                td0 = time.perf_counter()
                # the interleaved drain IS the double-buffer overlap
                # window — the flight recorder's drain-occupancy signal
                flight.begin(EV_DRAIN)
                batch = self._drain(first_timeout=self.max_delay_s)
                flight.end(EV_DRAIN)
                # the interleaved drain wait is the double buffer's
                # idle window, not the in-flight cycles' service time —
                # excluded from their clocks so the queue-math EWMA and
                # the deadline-overrun accounting describe real work
                #
                dt = time.perf_counter() - td0
                if pending is not None:
                    pending.overlap_drain_s += dt
                if confirming is not None:
                    confirming.overlap_drain_s += dt
            cycle = self._launch_cycle(batch) if batch else None
            if confirming is not None:
                # cycle N-1's confirm ran while N launched above —
                # resolve its futures before blocking on N's lanes
                self._resolve_cycle(confirming)
                confirming = None
            if pending is not None:
                self._collect_cycle(pending)
                if cycle is not None and \
                        self.pipeline.confirm_pool.n_workers > 1:
                    # hold the confirm open: it crunches on the pool
                    # workers while the freshly launched cycle's scan
                    # crunches on the cards
                    confirming = pending
                else:
                    self._resolve_cycle(pending)
            pending = cycle
        # shutdown with cycles in flight: their futures must still
        # resolve (exactly-one-verdict outlives the loop)
        for c, full in ((confirming, False), (pending, True)):
            if c is None:
                continue
            try:
                if full:
                    self._collect_cycle(c)
                self._resolve_cycle(c)
            except Exception:
                for rid, fut in c.guard.items:
                    if not fut.done():
                        self.pipeline.stats.count_fail_open()
                        _safe_set(fut, _fail_open_verdict(rid))
                self._clear_guard(c.guard)

    def _launch_cycle(self, batch: List) -> "_MeshCycle":
        """Phase A of a mesh cycle: classify the drained batch, run the
        pinned-lane stream step, reroute oversized bodies, canary-split,
        shard the remaining requests across the serving lanes (balanced
        by scanned bytes, half-open lanes capped to a canary share) and
        LAUNCH each lane's scan asynchronously.  Returns without
        touching any device result — the transfer/compute runs while
        the caller preps the next cycle."""
        t0 = time.perf_counter()
        c = _MeshCycle()
        c.t0 = t0
        reqs, deg_reqs, begins, chunks, finishes, c.guard = \
            self._classify_batch(batch, t0)
        c.cid = self.stats.batches
        flight.set_cycle(c.cid)
        flight.begin(EV_CYCLE, cycle=c.cid,
                     arg=len(reqs) + len(deg_reqs))
        c.n_reqs = len(reqs) + len(deg_reqs)
        c.n_finishes = len(finishes)
        c.n_stream_items = len(begins) + len(chunks) + len(finishes)
        c.min_ts = min(ts for _, ts, _, _ in batch)
        # tenant-fair pressure for the global ladder (observed at
        # resolve): min over non-quarantined tenants, the max signal
        # on the single-tenant fast path
        c.max_queue_delay_us = self._ladder_signal(batch, t0)
        # one breaker decision per lane per cycle; no serving lane at
        # all ⇒ the whole cycle takes the breaker-open route
        targets = self.lanes.routes()
        c.route = "device" if targets else "fallback"
        with self._swap_lock:
            # in-flight cycles finalize on the generation that launched
            # them (the hot-swap contract: in-flight batches finish on
            # the old tables) — capture under the lock
            c.pipeline = self.pipeline
            ps = c.pipeline.stats
            c.engine_us0, c.confirm_us0 = ps.engine_us, ps.confirm_us
            c.prep_us0, c.compiles0 = ps.prep_us, ps.engine_compiles
            # stream scans are NOT lane-pinned on device: the stream
            # engine dispatches to the DEFAULT device, so stream work
            # always rides the PRIMARY lane (which owns it).  Routing
            # it to a healthy sibling when the primary is sick would
            # hang that sibling's worker on the same wedged default
            # device and cascade-trip the whole pool;
            # instead streams degrade fail-open while the primary's
            # breaker is open — batch traffic keeps riding the healthy
            # lanes.
            primary = self.lanes.primary
            stream_route = ("device"
                            if any(ln is primary for ln, _ in targets)
                            else "fallback")   # primary down ⇒ poison
            c.finish_verdicts = self._stream_step_guarded(
                begins, chunks, finishes, stream_route, lane=primary)
            # quarantined tenants' share: prefilter-only on the primary
            # lane (the prefilter rides the default device, like stream
            # work), resolved at launch — never a lane share, never the
            # canary split (same contract as the single-lane loop)
            c.deg_done = []
            self._detect_tenant_degraded(deg_reqs, c.deg_done,
                                         stream_route, lane=primary)
            # the stream step may just have tripped the primary's
            # breaker: drop newly-OPEN lanes from this cycle's targets
            # so no share dispatches to a known-wedged worker
            targets = [(ln, r) for ln, r in targets
                       if ln.breaker.state != CircuitBreaker.OPEN]
            if not targets:
                c.route = "fallback"
            normal = []
            for item in reqs:
                ts, r, fut = item
                try:
                    plan = self._reroute_plan(r)
                except Exception:
                    plan = None   # fall back to the batched path
                if plan is not None:
                    self._submit_oversized(ts, r, plan, fut)
                else:
                    normal.append(item)
            # the canary generation split, as in the single-lane loop
            ro = self.rollout
            c.cand_items = []
            if ro is not None and ro.canary_active:
                normal, c.cand_items = ro.split(normal)
            c.ro = ro
            c.lane_parts = []
            c.fallback_items = []
            if normal and not targets:
                c.fallback_items = normal
            elif normal:
                shares = LanePool.split(
                    normal, targets,
                    weight=lambda it: len(it[1].body) + len(it[1].uri)
                    + 64)
                first_share = True
                for (lane, lroute), part in zip(targets, shares):
                    if not part:
                        continue
                    try:
                        flight.begin(EV_LAUNCH, cycle=c.cid,
                                     tag=lane.index, arg=len(part))
                        try:
                            job = c.pipeline.detect_launch(
                                [r for _, r, _ in part], lane=lane,
                                count_batch=first_share)
                        finally:
                            flight.end(EV_LAUNCH, cycle=c.cid,
                                       tag=lane.index)
                        first_share = False
                    except Exception:
                        # host prep died for this share: fail it open
                        # and count the failure against THIS lane only
                        lane.stats.errors += 1
                        lane.breaker.record_failure()
                        c.pipeline.stats.count_fail_open(len(part))
                        for _ts, r, fut in part:
                            _safe_set(fut,
                                      _fail_open_verdict(r.request_id))
                        continue
                    lane.stats.requests += len(part)
                    lane.stats.rows += job.live_rows
                    lane.stats.padded_rows += job.padded_rows
                    c.lane_parts.append((lane, lroute, part, job))
            c.launch_d_engine = ps.engine_us - c.engine_us0
            c.launch_d_prep = ps.prep_us - c.prep_us0
            c.launch_d_compiles = ps.engine_compiles - c.compiles0
        return c

    def _collect_cycle(self, c: "_MeshCycle") -> None:
        """Phase B1 of a mesh cycle: bounded per-lane SCAN collection
        (wait, mask) + confirm LAUNCH on the pool, per-lane breaker
        accounting, the breaker-open share, and the canary candidate
        share.  Shares whose lane
        wedged or raised resolve fail-open here; everything else's
        verdicts land in :meth:`_resolve_cycle` once the confirm shares
        join."""
        # (submit_ts, request, verdict, lane_idx); seeded with the
        # tenant-degraded share already resolved at launch
        done: List = list(c.deg_done)
        p = c.pipeline
        # ONE hang budget for the whole collection: the lanes dispatched
        # concurrently at launch, so they share the deadline — k
        # simultaneously wedged lanes must stall the dispatch thread
        # for one budget, not k stacked budgets; a
        # healthy lane that finished long ago returns instantly
        # regardless of what its siblings burned
        collect_deadline = time.perf_counter() + self.hang_budget_s
        fins: List = []   # (lane, part, _FinishJob)
        flight.set_cycle(c.cid)
        with self._swap_lock:
            ps = p.stats
            e0, cf0 = ps.engine_us, ps.confirm_us
            pp0, cp0 = ps.prep_us, ps.engine_compiles
            for lane, lroute, part, job in c.lane_parts:
                try:
                    flight.begin(EV_COLLECT, cycle=c.cid,
                                 tag=lane.index)
                    try:
                        fin = p.detect_collect_launch(
                            job, timeout=max(
                                collect_deadline - time.perf_counter(),
                                0.001))
                    finally:
                        flight.end(EV_COLLECT, cycle=c.cid,
                                   tag=lane.index)
                    # success is recorded in _resolve_cycle AFTER the
                    # confirm join: recording here would reset the
                    # breaker's consecutive-failure count every cycle
                    # and a persistent confirm-phase error could never
                    # trip it
                    lane.stats.busy_us += job.busy_us
                    fins.append((lane, part, fin))
                except DeviceHang:
                    # THIS card wedged: its share fails open, its
                    # breaker trips, its zombie worker is abandoned —
                    # the sibling lanes' collections proceed untouched
                    self.stats.hangs += 1
                    lane.stats.hangs += 1
                    lane.breaker.trip("hang")
                    lane.abandon_worker()
                    done += self._fail_open_part(p, part, lane.index)
                except Exception:
                    lane.stats.errors += 1
                    lane.breaker.record_failure()
                    done += self._fail_open_part(p, part, lane.index)
            if c.fallback_items and not self._cpu_fallback_ok(p):
                # every lane down on a card pipeline: fail open, never
                # move the detection work to the host
                self.stats.breaker_fail_open_batches += 1
                done += self._fail_open_part(p, c.fallback_items, -1)
            elif c.fallback_items:
                # every lane down: exact CPU confirm-only verdicts, the
                # single-lane fallback as the mesh's last resort
                self.stats.cpu_fallback_batches += 1
                freqs = [r for _, r, _ in c.fallback_items]
                try:
                    verdicts = p.detect_cpu_only(freqs)
                    for (ts, r, fut), v in zip(c.fallback_items,
                                               verdicts):
                        _safe_set(fut, v)
                        done.append((ts, r, v, -1))
                except Exception:
                    done += self._fail_open_part(p, c.fallback_items, -1)
            cand_verdicts: List[Verdict] = []
            c.cand_served = False
            if c.cand_items:
                creqs = [r for _, r, _ in c.cand_items]
                cand_lane = (c.lane_parts[0][0] if c.lane_parts
                             else self.lanes.primary)
                try:
                    cand_verdicts, c.cand_served = self._detect_candidate(
                        creqs, c.ro, c.route, lane=cand_lane)
                except Exception:
                    cand_verdicts = [_fail_open_verdict(r.request_id)
                                     for r in creqs]
                    c.cand_served = True
                for (ts, r, fut), v in zip(c.cand_items, cand_verdicts):
                    _safe_set(fut, v)
                    done.append((ts, r, v, cand_lane.index))
            c.collect_d_engine = ps.engine_us - e0
            c.collect_d_confirm = ps.confirm_us - cf0
            c.collect_d_prep = ps.prep_us - pp0
            c.collect_d_compiles = ps.engine_compiles - cp0
        c.pending_fins = fins
        c.done = done
        c.cand_verdicts = cand_verdicts

    def _resolve_cycle(self, c: "_MeshCycle") -> None:
        """Phase B2 of a mesh cycle: bounded-join the confirm shares,
        resolve the remaining verdict futures, rollout hooks, and the
        cycle's observability.  With an inline confirm pool this runs
        back-to-back with B1 (the confirm already completed inside the
        launch — the classic mesh loop); with pool workers it runs one
        drain later, the confirm having overlapped the next cycle's
        scan dispatch."""
        done = c.done
        p = c.pipeline
        flight.set_cycle(c.cid)
        with self._swap_lock:
            ps = p.stats
            e0, cf0 = ps.engine_us, ps.confirm_us
            pp0, cp0 = ps.prep_us, ps.engine_compiles
            for lane, part, fin in c.pending_fins:
                try:
                    verdicts = p.detect_collect_join(fin)
                    lane.breaker.record_success()
                    for (ts, r, fut), v in zip(part, verdicts):
                        _safe_set(fut, v)
                        done.append((ts, r, v, lane.index))
                except Exception:
                    # a confirm-phase error is a batch-level failure of
                    # this share, same accounting as the serial path
                    # (the pool already degraded a wedged WORKER to
                    # fail-open per share without raising)
                    lane.stats.errors += 1
                    lane.breaker.record_failure()
                    done += self._fail_open_part(p, part, lane.index)
            d_engine = (c.launch_d_engine + c.collect_d_engine
                        + ps.engine_us - e0)
            d_confirm = c.collect_d_confirm + ps.confirm_us - cf0
            d_prep = c.launch_d_prep + c.collect_d_prep + ps.prep_us - pp0
            d_compiles = (c.launch_d_compiles + c.collect_d_compiles
                          + ps.engine_compiles - cp0)
        self._clear_guard(c.guard)
        flight.end(EV_CYCLE, cycle=c.cid)
        if c.ro is not None:
            self._rollout_hooks(c.ro, done, c.cid,
                                c.cand_verdicts if c.cand_served else None)
        t_end = time.perf_counter()
        took = max(t_end - c.t0 - c.overlap_drain_s, 0.0)
        if d_compiles == 0:
            self._batch_ewma.update(min(took, 2.0 * self.hard_deadline_s))
            self._batch_ewma_n += 1
            self.pipeline.load_controller.observe(c.max_queue_delay_us)
        self.stats.batch_us_sum += int(took * 1e6)
        if took > self.hard_deadline_s:
            self.stats.deadline_overruns += c.n_reqs + c.n_finishes
        self.stats.completed += c.n_reqs + c.n_finishes
        trace = BatchTrace(
            ts=time.time(),
            n_requests=c.n_reqs,
            n_stream_items=c.n_stream_items,
            queue_delay_us=int((c.t0 - c.min_ts) * 1e6),
            batch_us=int(took * 1e6),
            engine_us=d_engine,
            confirm_us=d_confirm,
            prep_us=d_prep,
            request_ids=[r.request_id for _ts, r, _v, _l in done]
            + [h.request.request_id for h, _ in c.finish_verdicts])
        self.traces.record(trace)
        self._observe(trace, done, c.finish_verdicts, c.t0, t_end)

    def _fail_open_part(self, pipeline, part, lane_idx: int) -> List:
        """Resolve one lane share fail-open; returns its done-entries
        so the e2e histogram and slow ring still see these requests."""
        out = []
        pipeline.stats.count_fail_open(len(part))
        for ts, r, fut in part:
            v = _fail_open_verdict(r.request_id)
            _safe_set(fut, v)
            out.append((ts, r, v, lane_idx))
        return out

    def device_path_snapshot(self) -> dict:
        """What the scan plane actually ships per dispatch
        (docs/SCAN_KERNEL.md "Device path"): scan impl, host contract
        (raw uint8 bytes vs host-prepped rows), the backend (``cuda`` or
        ``cpu``) with the card's name, and the per-lane device placement
        — served under /healthz ``robustness.device_path`` so "is the
        raw-byte device path live on the card" is one probe."""
        eng = self.pipeline.engine
        impl = getattr(eng, "scan_impl", "?")
        dev = eng.device
        return {
            "scan_impl": impl,
            "scan_contract": ("raw-bytes" if impl == "pallas3"
                              else "prepped-rows"),
            "backend": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "lane_devices": [
                str(lane.device) if lane.device is not None
                else "default" for lane in self.lanes.lanes],
        }

    def warm_lanes(self, max_batch: Optional[int] = None) -> None:
        """Warm every lane on its own worker thread (the lane twin of
        server.warmup_pipeline): every lane dispatches EVERY Q-pad tier
        up to max_batch (not just its 1/N share of an all-healthy split
        — when siblings die, the rebalanced shares grow toward
        max_batch).  The dispatches run where live ones will: on the
        lane's worker, with the lane's card and stream current, so the
        first live cycle creates no library handle, allocator pool or
        table replica.  Each tier dispatches on all lanes CONCURRENTLY
        (detect_launch is async on each lane's own worker), and the
        recompile gauge keys on (kernel or replica, card), so serve-time
        recompiles stay 0.  Head-sliced twins (docs/SCAN_KERNEL.md) are
        warmed by a bodyless pass when the pack is word-tiered."""
        from ingress_plus_tpu_torch.utils.corpus import generate_corpus

        import dataclasses

        if max_batch is None:
            max_batch = self.max_batch
        reqs = [lr.request for lr in generate_corpus(n=max_batch, seed=1)]
        variants = [reqs]
        slicing = getattr(self.pipeline.engine, "head_slicing_active",
                          None)
        if slicing is not None and slicing():
            variants.append([dataclasses.replace(r, body=b"")
                             for r in reqs])
        from ingress_plus_tpu_torch.models.pipeline import warm_sizes

        for corpus in variants:
            for size in warm_sizes(max_batch):
                jobs = []
                with self._swap_lock:
                    for lane in self.lanes.lanes:
                        jobs.append((lane, self.pipeline.detect_launch(
                            corpus[:size], lane=lane)))
                    for _lane, job in jobs:
                        self.pipeline.detect_collect(job, timeout=None)
        # warmup traffic must not pollute the detection telemetry
        # (under the swap lock, like reset_latency_observations)
        with self._swap_lock:
            self.pipeline.reset_detection_observations()

    def _watch(self) -> None:
        """Monitor thread: last-resort backstop for a wedged DISPATCH
        THREAD (the device lane already bounds the device call; this
        covers everything else a cycle can hang in).  When the current
        cycle blows past ``_watch_grace``, its futures are released
        fail-open so no connection handler strands; while the dispatch
        thread still makes no progress, newly queued work is drained
        fail-open each tick — the one-verdict invariant outlives even
        a dead dispatcher."""
        period = min(max(self.hang_budget_s / 4.0, 0.05), 1.0)
        flight.register_thread("watchdog")
        stuck_at_batches: Optional[int] = None
        while not self._stop.wait(period):
            # NEVER remove from _active_guards here: the dispatch
            # thread is its only mutator — a monitor-side removal could
            # race the dispatcher un-sticking and drop the NEXT cycle's
            # freshly armed guard.  The per-guard fired flag gives
            # fire-once behavior without touching the list.
            for guard in list(self._active_guards):
                if guard.fired or time.perf_counter() <= guard.deadline:
                    continue
                guard.fired = True
                released = 0
                st = self.pipeline.stats
                for rid, fut in guard.items:
                    if not fut.done():
                        st.count_fail_open()
                        _safe_set(fut, _fail_open_verdict(rid))
                        released += 1
                if released:
                    self.stats.watchdog_released += released
                    self.breaker.trip("watchdog")
                    flight.instant(EV_WATCHDOG, cycle=0, arg=released)
                    stuck_at_batches = self.stats.batches
            if stuck_at_batches is not None:
                if self.stats.batches != stuck_at_batches:
                    stuck_at_batches = None   # dispatcher moved again
                else:
                    n = self._drain_failopen("watchdog")
                    self.stats.watchdog_released += n

    @staticmethod
    def _exemplar(request, verdict, ts: float, queue_us: int,
                  body_len: Optional[int] = None, **extra) -> dict:
        """The ONE slow-ring exemplar shape (batched / stream-finish /
        oversized lanes all build it here): span attribution + truncated
        normalized input sizes + rules hit — never request bytes."""
        d = {
            "request_id": request.request_id,
            "ts": ts,
            "queue_us": queue_us,
            "input": {"uri_len": len(request.uri),
                      "body_len": (len(request.body) if body_len is None
                                   else body_len),
                      "n_headers": len(request.headers)},
            "rule_ids": list(verdict.rule_ids[:16]),
            "score": verdict.score,
            "attack": verdict.attack,
            "blocked": verdict.blocked,
            "fail_open": verdict.fail_open,
        }
        d.update(extra)
        return d

    def _observe(self, trace: BatchTrace, done, finish_verdicts,
                 t0: float, t_end: float) -> None:
        """Feed this cycle's spans into the stage histograms and the
        slow-exemplar ring (the latency-attribution layer; never on any
        failure path — purely additive observability)."""
        h = self.hist
        h["batch"].observe(trace.batch_us)
        h["prep"].observe(trace.prep_us)
        h["scan"].observe(trace.engine_us)
        h["confirm"].observe(trace.confirm_us)
        if trace.n_requests:
            self.batch_size_hist.observe(trace.n_requests)
        stages = None                 # built only if something IS slow
        thr = self.slow.threshold()   # skip dict build for fast requests
        rec = flight.enabled
        for ts, r, v, lane_idx in done:
            queue_us = int((t0 - ts) * 1e6)
            e2e_us = int((t_end - ts) * 1e6)
            h["queue"].observe(queue_us)
            h["e2e"].observe(e2e_us)
            if rec:
                # the verdict end of the request flow (EV_SUBMIT is the
                # admission end); arg = the lane that served it
                flight.instant(EV_VERDICT, tag=request_tag(r.request_id),
                               arg=lane_idx)
            if e2e_us <= thr:
                continue
            if stages is None:
                stages = trace.stages()
            # slow-exemplar attribution (docs/MESH_SERVING.md):
            # lane=WHICH device, worker=WHICH confirm
            # worker, tenant=fair-queue tenant, generation=the ruleset
            # generation that produced the verdict
            self.slow.offer(e2e_us, self._exemplar(
                r, v, trace.ts, queue_us, batch=stages, lane=lane_idx,
                worker=v.confirm_worker, tenant=r.tenant,
                generation=v.generation))
        for handle, v in finish_verdicts:
            # streams: end-to-end is begin→finish (the verdict's own
            # clock), not this cycle's queue wait
            e2e_us = int(v.elapsed_us)
            h["e2e"].observe(e2e_us)
            if rec:
                flight.instant(
                    EV_VERDICT,
                    tag=request_tag(handle.request.request_id), arg=-1)
            if e2e_us <= thr:
                continue
            if stages is None:
                stages = trace.stages()
            self.slow.offer(e2e_us, self._exemplar(
                handle.request, v, trace.ts, 0,
                body_len=handle.body_len, batch=stages,
                worker=v.confirm_worker, tenant=handle.request.tenant,
                generation=v.generation,
                stream={"chunks": handle.chunks,
                        "body_len": handle.body_len,
                        "truncated": handle.truncated}))

    def _stream_step(self, begins, chunks, finishes,
                     device_ok: bool = True) -> List:
        """Streaming work for one dispatch cycle (called under the swap
        lock, on the dispatch thread — sole owner of stream state).
        Returns the (handle, verdict) pairs resolved at finish, so the
        caller can attribute their latency.  ``device_ok=False``
        (breaker open): the scan plane is presumed dead — poison this
        cycle's stream work instead of hanging the dispatch thread on
        a wedged device; every finish resolves fail-open."""
        if not (begins or chunks or finishes):
            return []
        flight.begin(EV_STREAM, arg=len(begins) + len(chunks)
                     + len(finishes))
        if not device_ok:
            for h in begins:
                h.error = True
            for h, _ in chunks:
                h.error = True
            for h, _ in finishes:
                h.error = True
        try:
            live = [h for h in begins if not (h.aborted or h.error)]
            if live:
                base = self.pipeline.prefilter([h.request for h in live])
                for i, h in enumerate(live):
                    h.base_hits = base[i]
            items = []
            for h, data in chunks:
                if not (h.aborted or h.error):
                    items.extend(h.feed(data))
            for h, _ in finishes:
                if not (h.aborted or h.error):
                    items.extend(h.flush())
            if items:
                self.stream_engine.scan(items)
        except Exception:
            # fail-open contract: a scan error poisons only the streams
            # in this cycle, each resolves pass-and-flag at finish
            for h in begins:
                h.error = True
            for h, _ in chunks:
                h.error = True
            for h, _ in finishes:
                h.error = True
        out = []
        for h, fut in finishes:
            try:
                v = self.stream_engine.finish(h)
            except Exception:
                self.pipeline.stats.count_fail_open()
                v = Verdict(
                    request_id=h.request.request_id, blocked=False,
                    attack=False, classes=[], rule_ids=[], score=0,
                    fail_open=True,
                    # genuinely slow failed streams must still carry
                    # their real duration into the e2e histogram and
                    # remain slow-ring eligible
                    elapsed_us=int((time.perf_counter() - h.t0) * 1e6))
            _safe_set(fut, v)
            out.append((h, v))
        flight.end(EV_STREAM)
        return out
