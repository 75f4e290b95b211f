"""Per-device serve lanes — the dispatch plane (docs/MESH_SERVING.md).

The single-lane batcher has ONE watchdogged device lane and ONE circuit
breaker: a wedged or erroring dispatch fails its batch open, the breaker
trips, and while it is open batches fail open on a card (a pipeline on
the CPU rides the CPU confirm-only path instead).  That
generalizes here to N per-card instances behind the same admission
queue: each :class:`Lane` owns one ``torch.device``, one CUDA stream,
one single-worker dispatch thread (so a hang on card 3 cannot
head-of-line-block cards 0-2 or the dispatch thread), one
:class:`CircuitBreaker`, and its own fill/hang telemetry
(``ipt_dispatch_fill{device=}`` and friends).

Device state is per thread in PyTorch (the current device, the current
stream, the cuBLAS handle), so each lane worker sets its card and its
lane's stream once, at thread start: every launch the worker makes then
enqueues on the lane's own stream, and two lanes on one card do not
serialize on the default stream.  A wedged CUDA kernel cannot be
cancelled: the worker is abandoned (the share fails open, the breaker
trips) and its replacement gets a fresh stream.

Degradation semantics (the capacity-not-service contract):

* a hung/erroring lane fails only ITS share of the cycle open and trips
  only ITS breaker — the other lanes' sub-batches resolve normally;
* while a lane's breaker is open the splitter simply stops assigning it
  rows (capacity degrades ~1/N, verdict quality does not);
* a half-open lane gets a small canary share; success closes it;
* the breaker-open route (fail open on a card, the CPU confirm-only
  path for a CPU pipeline) engages only when EVERY lane is down — the
  single-lane behavior, now the last resort instead of the first.

Row placement: the splitter shards scan work at REQUEST granularity
(each request's rows travel together), weighted by scanned bytes, so no
cross-lane merge of per-request partials is ever needed and every lane's
executable shapes remain pure functions of its (B, L, Q) — the same
placement-free property the warm-shape replay contract depends on.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.trace import flight, named_lock


class DeviceHang(Exception):
    """A device-lane call exceeded the hang budget."""


class LanePending:
    """Handle for one in-flight lane-worker call: ``wait(timeout)``
    returns the result, re-raises the worker's exception, or raises
    :class:`DeviceHang` — the caller decides what a hang means (the
    batcher fails that lane's share open and abandons the worker)."""

    __slots__ = ("_box", "_ev")

    def __init__(self, box: dict, ev: threading.Event):
        self._box = box
        self._ev = ev

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float]):
        if not self._ev.wait(timeout):
            raise DeviceHang("device dispatch exceeded %.3fs"
                             % (timeout if timeout is not None else -1.0))
        if "error" in self._box:
            raise self._box["error"]
        return self._box.get("result")


class LaneWorker:
    """Single-worker executor for one device's dispatch, so callers can
    bound their wait: a wedged kernel launch times out instead of
    head-of-line-blocking every tenant.  With a CUDA ``device`` the
    worker thread makes that card current and ``stream`` (the lane's
    own) its current stream before it runs anything.

    On timeout the worker is ABANDONED — Python cannot kill a thread
    stuck in native code, so the owner replaces the worker and the
    zombie (at most one per hang) exits when/if the stuck call returns.
    A zombie that un-sticks may still mutate pipeline telemetry
    counters concurrently with live traffic — bounded noise in
    observability, never in verdicts (its batch's futures were already
    resolved fail-open, and the batcher's ``_safe_set`` tolerates the
    late duplicate set)."""

    def __init__(self, seq: int = 0, lane_index: Optional[int] = None,
                 name: str = "ipt-device",
                 device: Optional[torch.device] = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.seq = seq
        self.lane_index = lane_index
        self.device = device
        self.stream = stream
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="%s-%d" % (name, seq))
        self._thread.start()

    def _setup(self) -> None:
        """Thread-local attribution stamped once at worker startup —
        lane-targeted fault injection (utils/faults.py ``lane=``): sites
        fired from this thread attribute to this lane.  Subclasses that
        reuse the bounded-call machinery for non-device work (the
        confirm plane's workers, models/confirm_plane.py) override this
        with their own attribution.  A CUDA lane also pins the card and
        the lane's stream for this thread."""
        if self.lane_index is not None:
            faults.set_current_lane(self.lane_index)
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            if self.stream is not None:
                torch.cuda.set_stream(self.stream)
        flight.register_thread("lane_worker")

    def _run(self) -> None:
        self._setup()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, ev = item
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed to the caller
                box["error"] = e
            ev.set()

    def submit(self, fn: Callable) -> LanePending:
        box: dict = {}
        ev = threading.Event()
        self._q.put((fn, box, ev))
        return LanePending(box, ev)

    def call(self, fn: Callable, timeout: Optional[float]):
        pending = self.submit(fn)
        try:
            return pending.wait(timeout)
        except DeviceHang:
            self._q.put(None)   # the worker exits if it ever un-sticks
            raise

    def close(self, timeout: float = 2.0) -> None:
        self._q.put(None)
        self._thread.join(timeout=timeout)


class CircuitBreaker:
    """Device-path circuit breaker (docs/ROBUSTNESS.md).

    closed → open on a dispatch HANG (immediate: a wedged device does
    not get ``failure_threshold`` more batches to wedge) or on
    ``failure_threshold`` consecutive dispatch errors; open → half_open
    once ``cooldown_s`` has passed; half_open routes a SINGLE canary
    batch to the device — success closes the breaker, another
    failure/hang re-opens it and restarts the cooldown.  One instance
    per lane (docs/MESH_SERVING.md); the breaker-open route engages
    only when every lane's breaker is open."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 5.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = self.CLOSED
        self.failures = 0           # consecutive, reset on success
        self.trips = 0
        self.closes = 0
        self.probes = 0
        self.last_trip_reason: Optional[str] = None
        self._opened_at = 0.0
        self._lock = named_lock("CircuitBreaker._lock")

    def route(self) -> str:
        """Where this lane's share goes: "device" | "canary" |
        "fallback"."""
        with self._lock:
            if self.state == self.CLOSED:
                return "device"
            if self.state == self.OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return "fallback"
                self.state = self.HALF_OPEN
                self.probes += 1
            return "canary"

    def trip(self, reason: str) -> None:
        with self._lock:
            self._trip_locked(reason)

    def _trip_locked(self, reason: str) -> None:
        self.state = self.OPEN
        self._opened_at = time.monotonic()
        self.trips += 1
        self.failures = 0
        self.last_trip_reason = reason

    def record_failure(self, reason: str = "dispatch_error") -> None:
        with self._lock:
            if self.state == self.HALF_OPEN:
                self._trip_locked("canary_" + reason)
                return
            self.failures += 1
            if self.state == self.CLOSED \
                    and self.failures >= self.failure_threshold:
                self._trip_locked(reason)

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state == self.HALF_OPEN:
                self.state = self.CLOSED
                self.closes += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "trips": self.trips,
                "closes": self.closes,
                "probes": self.probes,
                "last_trip_reason": self.last_trip_reason,
                # the OPEN->HALF_OPEN transition only happens on the
                # next batch (route()); probe_due tells traffic-less
                # consumers (/readyz) that the cooldown has elapsed and
                # the breaker WANTS a canary — readiness must come back
                # so the canary can arrive, or an out-of-rotation pod
                # would stay unready forever
                "probe_due": (self.state == self.OPEN
                              and time.monotonic() - self._opened_at
                              >= self.cooldown_s),
            }


@dataclass
class LaneStats:
    """Per-lane dispatch telemetry (the ``device=`` label's backing
    store: ipt_dispatch_fill / ipt_watchdog_hangs_total /
    ipt_lane_* series)."""

    dispatches: int = 0
    requests: int = 0
    hangs: int = 0
    errors: int = 0
    rows: int = 0            # live scan rows dispatched to this device
    padded_rows: int = 0     # post-padding rows (fill denominator)
    busy_us: int = 0         # launch → materialized wall per dispatch
    stream_cycles: int = 0   # stream scan work pinned to this lane

    def fill(self) -> Optional[float]:
        if not self.padded_rows:
            return None
        return self.rows / self.padded_rows

    def snapshot(self) -> dict:
        d = dict(self.__dict__)
        d["dispatch_fill"] = (round(self.fill(), 4)
                              if self.padded_rows else None)
        return d


class Lane:
    """One device's serve lane: a ``torch.device`` (None = the
    pipeline engine's own device), its own CUDA stream on a CUDA
    device, a single-worker dispatch thread, a breaker, and fill/hang
    telemetry."""

    def __init__(self, index: int, device: Any = None,
                 failure_threshold: int = 3, cooldown_s: float = 5.0):
        self.index = index
        self.device = torch.device(device) if device is not None else None
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      cooldown_s=cooldown_s)
        self.stats = LaneStats()
        self._worker_seq = index * 1000
        self.worker = self._new_worker()

    def _new_worker(self) -> LaneWorker:
        """A worker on a fresh stream of the lane's card (a wedged
        predecessor's stream may never drain)."""
        stream = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
        return LaneWorker(self._worker_seq, lane_index=self.index,
                          device=self.device, stream=stream)

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        return self.worker.stream

    @property
    def label(self) -> str:
        return str(self.index)

    def submit(self, fn: Callable) -> LanePending:
        self.stats.dispatches += 1
        return self.worker.submit(fn)

    def call(self, fn: Callable, timeout: Optional[float]):
        """Blocking bounded call (``timeout`` None: unbounded, for
        warmup); a hang abandons the worker."""
        self.stats.dispatches += 1
        try:
            return self.worker.call(fn, timeout)
        except DeviceHang:
            self.abandon_worker()
            raise

    def abandon_worker(self) -> None:
        """Replace a wedged worker thread.  The shutdown sentinel goes
        on the OLD worker's queue first, so the zombie exits when/if
        its stuck call returns instead of blocking on get() forever —
        without it every mesh-path hang would leak a thread for the
        process lifetime (the call() path already queues its own
        sentinel, a duplicate is harmless)."""
        self.worker._q.put(None)
        self._worker_seq += 1
        self.worker = self._new_worker()

    def snapshot(self) -> dict:
        return {
            "lane": self.index,
            "device": str(self.device) if self.device is not None else None,
            "breaker": self.breaker.snapshot(),
            **self.stats.snapshot(),
        }

    def close(self, timeout: float = 2.0) -> None:
        self.worker.close(timeout=timeout)


class LanePool:
    """N per-device lanes behind one admission queue
    (docs/MESH_SERVING.md).  ``devices`` are torch devices — one lane
    each, taken round robin, sigpack tables replicated per device by the
    engine (``DetectionEngine.tables_for``).  With ``devices=None`` every
    lane dispatches to the engine's own device — the machinery still
    isolates faults, only the physical parallelism is absent."""

    def __init__(self, n_lanes: int = 1,
                 devices: Optional[Sequence[Any]] = None,
                 failure_threshold: int = 3, cooldown_s: float = 5.0):
        if n_lanes < 1:
            raise ValueError("n_lanes must be >= 1, got %d" % n_lanes)
        self.lanes: List[Lane] = []
        for i in range(n_lanes):
            dev = None
            if devices:
                dev = devices[i % len(devices)]
            self.lanes.append(Lane(i, device=dev,
                                   failure_threshold=failure_threshold,
                                   cooldown_s=cooldown_s))

    @property
    def n(self) -> int:
        return len(self.lanes)

    @property
    def primary(self) -> Lane:
        return self.lanes[0]

    def lane(self, index: int) -> Lane:
        return self.lanes[index]

    def routes(self) -> List[Tuple[Lane, str]]:
        """One breaker decision per lane per cycle.  Returns the lanes
        willing to take device work this cycle with their route
        ("device" | "canary"); empty ⇒ every lane is down and the
        caller takes the breaker-open route (fail open on a card)."""
        out = []
        for lane in self.lanes:
            r = lane.breaker.route()
            if r != "fallback":
                out.append((lane, r))
        return out

    def any_available(self) -> bool:
        """Readiness view: at least one lane can (or wants to) serve —
        closed, half-open, or open-with-cooldown-elapsed (probe_due:
        the canary that would close it needs traffic routed here)."""
        for lane in self.lanes:
            snap = lane.breaker.snapshot()
            if snap["state"] != CircuitBreaker.OPEN or snap["probe_due"]:
                return True
        return False

    @staticmethod
    def split(items: Sequence[Any],
              targets: Sequence[Tuple[Lane, str]],
              weight: Optional[Callable[[Any], int]] = None,
              canary_cap: int = 4) -> List[List[Any]]:
        """Deterministically shard one cycle's items across the serving
        lanes, balanced by ``weight`` (scanned bytes — padding waste
        concentrates when one lane draws all the long rows).  Half-open
        lanes get at most ``canary_cap`` items: a canary probes the
        device, it does not bet a full share of the cycle on it."""
        if not targets:
            return []
        loads = [0] * len(targets)
        counts = [0] * len(targets)
        out: List[List[Any]] = [[] for _ in targets]
        for item in items:
            w = weight(item) if weight is not None else 1
            best, best_load = None, None
            for i, (_lane, route) in enumerate(targets):
                if route == "canary" and counts[i] >= canary_cap:
                    continue
                if best is None or loads[i] < best_load:
                    best, best_load = i, loads[i]
            if best is None:       # every lane is a saturated canary
                best = loads.index(min(loads))
            out[best].append(item)
            loads[best] += w
            counts[best] += 1
        return out

    def snapshot(self) -> List[dict]:
        return [lane.snapshot() for lane in self.lanes]

    def close(self, timeout: float = 2.0) -> None:
        for lane in self.lanes:
            lane.close(timeout=timeout)
