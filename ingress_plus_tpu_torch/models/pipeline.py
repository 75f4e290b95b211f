"""DetectionPipeline — requests in, verdicts out.

The port of ``ingress_plus_tpu/models/pipeline.py``:

    requests ─normalize─▶ scan rows ─L-buckets─▶ device scan + mapping
             ─▶ prefilter hits ─tenant/paranoia mask─▶ CPU confirm
             ─▶ anomaly scoring, ACL, mode ─▶ Verdict per request

Modes mirror the reference's ``wallarm_mode``: "off", "monitoring"
(detect, never block), "safe_blocking", "block".  ``fail_open`` mirrors
``wallarm-fallback``: any engine error yields pass-and-flag verdicts.

The serve plane's parts are here: the brownout ladder
(:class:`LoadController`), the serve-lane launch/collect split, the
pooled confirm workers and the cross-cycle verdict cache
(``models/confirm_plane.py``), RuleStats telemetry, the fault-injection
sites, and the breaker-open CPU-only path (CPU pipelines only).  Not
ported here: the learned scoring head (``set_scoring_head``; ``scorer``
stays None and the generation tag is the ruleset version).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ingress_plus_tpu_torch.compiler.ruleset import (
    CompiledRuleset,
    N_HEAD_SV,
    VARIANTS,
)
from ingress_plus_tpu_torch.compiler.seclang import CLASSES, STREAMS
from ingress_plus_tpu_torch.models.acl import AclStore
from ingress_plus_tpu_torch.models.confirm import (
    ConfirmRule,
    parse_exclusion_token,
)
from ingress_plus_tpu_torch.models.confirm_plane import (
    ConfirmPool,
    VerdictCache,
    join_confirm,
    launch_confirm,
)
from ingress_plus_tpu_torch.models.engine import DetectionEngine
from ingress_plus_tpu_torch.models.rule_stats import RuleStats
from ingress_plus_tpu_torch.ops.scan import pad_rows
from ingress_plus_tpu_torch.serve.normalize import (
    Request,
    merged_rows_for_requests,
    needed_variants_by_stream,
)
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.device import DeviceLike
from ingress_plus_tpu_torch.utils.trace import (
    EV_DEVICE,
    EV_FINALIZE,
    EV_PREP,
    Ewma,
    flight,
    named_lock,
)

#: wallarm_mode precedence (weakest → strongest).  Wire values (frame
#: mode bits 0-1) are historical — safe_blocking is value 3, BETWEEN
#: monitoring and block in strength — so strength is a lookup.
MODE_STRENGTH = {0: 0, 1: 1, 3: 2, 2: 3}   # off, monitoring, safe_blocking, block
MODE_NAME_STRENGTH = {"off": 0, "monitoring": 1, "safe_blocking": 2,
                      "block": 3}


@dataclass
class Verdict:
    request_id: str
    blocked: bool
    attack: bool
    classes: List[str]
    rule_ids: List[int]
    score: int
    fail_open: bool = False
    #: served under brownout (prefilter-only ladder rung or admission
    #: shed): the verdict is best-effort — degraded verdicts never block
    degraded: bool = False
    #: ruleset version that produced this verdict (dual-generation
    #: accounting for the guarded rollout: during a canary ramp each
    #: request is served by EXACTLY ONE generation, and the stamp is how
    #: that invariant is asserted and how the shadow lane skips diffing
    #: candidate-served verdicts against the candidate itself).  Empty on
    #: fail-open/shed verdicts no generation ever scanned.
    generation: str = ""
    elapsed_us: int = 0
    #: learned-head margin when a scoring head is installed; always
    #: None here (the learned scoring head is not ported)
    learned_score: Optional[float] = None
    #: matched points for the attack export (wallarm "points" analog):
    #: up to 8 dicts {rule_id, var, value} — var is the SecLang variable
    #: ('ARGS:q'), value a bounded post-transform snippet
    matches: List[dict] = field(default_factory=list)
    #: confirm worker that walked this request's candidates
    #: (/debug/slow names the worker): 0 = the inline serial walk,
    #: -1 = no confirm ran (fail-open, prefilter-only, streams)
    confirm_worker: int = -1


@dataclass
class PipelineStats:
    requests: int = 0
    rows: int = 0
    row_bytes: int = 0
    prefilter_rule_hits: int = 0
    confirmed_rule_hits: int = 0
    truncated_rows: int = 0
    fail_open: int = 0
    batches: int = 0
    #: requests shed fail-open at admission, keyed by reason
    #: ("queue_full", "deadline", "brownout", "stream_overload",
    #: "watchdog", "shutdown") — /metrics ipt_shed_total{reason=}
    shed: Dict[str, int] = field(default_factory=dict)
    #: verdicts served degraded (brownout ladder above full detection)
    degraded: int = 0
    #: host prep: normalize/unpack/row build+merge, before any device
    #: dispatch (the "prep" stage of the latency-attribution histograms)
    prep_us: int = 0
    engine_us: int = 0
    confirm_us: int = 0
    # device-efficiency accounting: the padded (B, L)
    # rectangles the engine actually scans vs their live rows/bytes
    # (padding-waste ratio, dispatch fill), per-L-tier bucket occupancy,
    # and serve-time first loads (a kernel or a table replica on a
    # device) that warmup had not covered.
    # live_rows/live_row_bytes duplicate rows/row_bytes under the
    # RESETTABLE group: the cumulative Prometheus counters above span
    # warmup and swaps, while this group is zeroed after warmup
    # (reset_detection_observations) so the ratios describe only
    # measured traffic — the stage-histogram convention.
    live_rows: int = 0
    live_row_bytes: int = 0
    padded_rows: int = 0
    padded_bytes: int = 0
    engine_compiles: int = 0
    bucket_rows: Dict[int, int] = field(default_factory=dict)
    bucket_padded_rows: Dict[int, int] = field(default_factory=dict)
    #: learned-vs-fixed verdict divergence, keyed by direction —
    #: /metrics ipt_scorer_diff_total{kind=}; stays empty while no
    #: learned scoring head exists
    scorer_diff: Dict[str, int] = field(default_factory=dict)
    # confirm plane (docs/CONFIRM_PLANE.md): wedged confirm-worker
    # shares failed open within the pool's hang budget, and the
    # per-cycle flood-memo outcome counters (the memoization half of
    # the fixed-pack A/B attribution)
    confirm_hangs: int = 0
    confirm_memo_hits: int = 0
    confirm_memo_misses: int = 0

    #: the admission-shared counters (fail_open / degraded / shed /
    #: scorer_diff) are bumped from every thread that can fail a
    #: request open — submit callers, the dispatch thread, the
    #: oversized side worker, the watchdog, confirm folds — so those
    #: bumps serialize on this lock.  The per-batch hot counters
    #: (requests, rows, engine_us, ...) stay single-writer under the
    #: batcher's swap lock / bounded-call handoff and are lock-free on
    #: purpose.
    _lock: threading.Lock = field(
        default_factory=lambda: named_lock("PipelineStats._lock"),
        repr=False, compare=False)

    def count_fail_open(self, n: int = 1) -> None:
        with self._lock:
            self.fail_open += n

    def count_degraded(self, n: int = 1) -> None:
        with self._lock:
            self.degraded += n

    def count_scorer_diff(self, kind: str) -> None:
        with self._lock:
            self.scorer_diff[kind] = self.scorer_diff.get(kind, 0) + 1

    def count_shed(self, reason: str) -> None:
        """One admission shed (readers snapshot with dict())."""
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def reset_efficiency(self) -> None:
        """Zero the resettable device-efficiency group only (the
        cumulative counters keep their Prometheus contract)."""
        self.live_rows = 0
        self.live_row_bytes = 0
        self.padded_rows = 0
        self.padded_bytes = 0
        self.engine_compiles = 0
        self.bucket_rows = {}
        self.bucket_padded_rows = {}


@dataclass
class _ScanJob:
    """In-flight per-lane scan (detect_launch → detect_collect): the
    host-prep products plus the pending device dispatch.  ``pending``
    is a serve-lane handle (lanes.LanePending) whose wait() the
    collector bounds; ``result`` is the synchronous no-lane variant."""

    requests: List[Request]
    t0: float
    lane: object = None
    level: int = 0
    head_ok: bool = False
    live_rows: int = 0
    padded_rows: int = 0
    busy_us: int = 0
    pending: object = None
    result: Optional[np.ndarray] = None


@dataclass
class _FinishJob:
    """In-flight finish phase of one lane share (detect_collect_launch
    → detect_collect_join): either immediate ``verdicts`` (empty share,
    brownout rungs) or a pending confirm-plane job ``cjob``."""

    verdicts: Optional[List["Verdict"]] = None
    cjob: object = None
    t0: float = 0.0


def warm_sizes(max_batch: int) -> List[int]:
    """The ONE Q-pad warmup tier ladder — 1, then the pow2 tiers up to
    ``max_batch`` — shared by server.warmup_pipeline,
    Batcher.warm_lanes and the mesh measurement harness.  A drifted
    copy would leave a "warmed" server paying serve-time first loads
    on a shape it never warmed."""
    sizes, q = [1], 4
    while q < max_batch:
        sizes.append(q)
        q *= 2
    if max_batch > 1:
        sizes.append(max_batch)
    return sizes


#: brownout ladder rungs (LoadController.level indexes this):
#: full detection → prefilter-only (skip the confirm lane; verdicts
#: flagged degraded, never blocking) → fail-open (no scan at all)
BROWNOUT_LEVELS = ("full", "prefilter_only", "fail_open")


class LoadController:
    """Brownout degradation ladder (docs/ROBUSTNESS.md).

    Input: per-cycle queue delay (the batcher feeds the oldest queued
    request's wait each dispatch, and zero on idle drains) smoothed by
    an EWMA.  Output: ``level`` —

      0  full detection (scan + confirm)
      1  prefilter-only: confirm lane skipped, verdicts scored from the
         sound prefilter candidates, flagged ``degraded`` and never
         blocking (accuracy-for-throughput, the Approximate-Reduction
         trade from PAPERS.md: a sound approximate verdict beats none)
      2  fail-open: requests pass unscanned (the wallarm-fallback floor)

    Steps UP one rung once the EWMA has stayed above the level's
    threshold for ``up_confirm_s`` (a short confirmation window: a
    cold-start backlog draining for a few hundred ms must not brown
    out the node, sustained overload still escalates within a second);
    steps DOWN one rung only after the signal has fallen below
    ``down_factor`` x the threshold AND ``dwell_s`` has passed since
    the last change — the hysteresis that keeps the ladder from
    flapping at a threshold boundary.

    Single-writer (the batcher's dispatch thread calls ``observe``);
    ``level`` reads are torn-free ints."""

    def __init__(self, up_us: tuple = (62_500, 150_000),
                 down_factor: float = 0.5, dwell_s: float = 2.0,
                 alpha: float = 0.2, up_confirm_s: float = 0.5):
        self.up_us = tuple(up_us)
        self.down_factor = down_factor
        self.dwell_s = dwell_s
        self.up_confirm_s = up_confirm_s
        self.ewma = Ewma(alpha)
        self.level = 0
        self.steps_up = 0
        self.steps_down = 0
        self._last_change = 0.0
        self._over_since: Optional[float] = None
        # per-observation cap: a SINGLE seconds-long stall (post-compile
        # backlog, GC pause) must not catapult the EWMA over every
        # threshold — capped, one spike moves the signal at most
        # alpha x cap, so only SUSTAINED pressure climbs the ladder
        self.obs_cap_us = 2.0 * self.up_us[-1]

    def configure_deadline(self, hard_deadline_s: float) -> None:
        """Derive the rung thresholds from the serve deadline: step to
        prefilter-only at 25% of the deadline spent queueing, to
        fail-open at 60% — admission-time shedding handles the rest."""
        hd_us = hard_deadline_s * 1e6
        self.up_us = (0.25 * hd_us, 0.60 * hd_us)
        self.obs_cap_us = 2.0 * self.up_us[-1]

    def observe(self, queue_delay_us: float,
                now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        v = self.ewma.update(min(queue_delay_us, self.obs_cap_us))
        if self.level < len(self.up_us) and v > self.up_us[self.level]:
            if self._over_since is None:
                self._over_since = now
            if now - self._over_since >= self.up_confirm_s:
                self.level += 1
                self.steps_up += 1
                self._last_change = now
                self._over_since = now   # next rung needs its own window
        else:
            self._over_since = None
            if (self.level > 0
                    and v < self.up_us[self.level - 1] * self.down_factor
                    and now - self._last_change >= self.dwell_s):
                self.level -= 1
                self.steps_down += 1
                self._last_change = now
        return self.level

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "mode": BROWNOUT_LEVELS[self.level],
            "queue_delay_ewma_us": round(self.ewma.get(), 1),
            "up_thresholds_us": [round(u, 1) for u in self.up_us],
            "dwell_s": self.dwell_s,
            "steps_up": self.steps_up,
            "steps_down": self.steps_down,
        }


class DetectionPipeline:
    # Fixed length tiers; rows longer than the last tier are TRUNCATED at
    # 16KB in this batched path (stats.truncated_rows counts them).  The
    # serve layer never lets an oversized body reach here: Batcher.submit
    # auto-routes bodies whose (unpacked) size exceeds the last tier
    # through the StreamEngine's state-carried chunk scan.  Direct
    # library callers of detect() keep the explicit 16KB bound.
    L_BUCKETS = (64, 128, 256, 512, 2048, 16384)

    @staticmethod
    def _pad_q(n: int, floor: int = 4) -> int:
        p = floor
        while p < n:
            p *= 2
        return p

    def __init__(
        self,
        ruleset: CompiledRuleset,
        mode: str = "block",
        anomaly_threshold: Optional[int] = None,
        fail_open: bool = True,
        paranoia_level: Optional[int] = None,
        tenant_rule_mask: Optional[np.ndarray] = None,  # (T, R) bool
        scan_impl: Optional[str] = None,
        acl_store: Optional[AclStore] = None,
        tenant_acl: Optional[Dict[int, str]] = None,
        default_acl: str = "",
        engine: Optional[DetectionEngine] = None,
        confirm_workers: int = 1,
        confirm_hang_budget_s: float = 30.0,
        confirm_memo_entries: int = 4096,
        confirm_cache_entries: int = 0,
        device: DeviceLike = None,
    ):
        # ``device`` None = the CUDA card; ``scan_impl`` None = the
        # device's default (pallas3 on cuda, pair on cpu).  ``engine``:
        # a pre-built engine to serve with (the batcher's hot swap
        # passes ``engine.rebuilt``)
        self.engine = (engine if engine is not None
                       else DetectionEngine(ruleset, scan_impl=scan_impl,
                                            device=device))
        self.mode = mode
        # the learned scoring head is not ported: fixed CRS weights
        self.scoring_head = None
        self.scorer = None
        # wallarm-acl enforcement: hot-swappable store + per-tenant ACL
        # binding (the annotation is per-Ingress = per-tenant);
        # default_acl applies when a tenant has no binding
        self.acl_store = acl_store if acl_store is not None else AclStore()
        self.tenant_acl: Dict[int, str] = dict(tenant_acl or {})
        self.default_acl = default_acl
        # precedence for both knobs: explicit arg > the pack's compiled
        # CRS config (SecAction setvars / 949-style rule) > classic
        # defaults (threshold 5, PL2)
        if anomaly_threshold is None:
            anomaly_threshold = getattr(ruleset, "anomaly_threshold",
                                        None) or 5
        self.anomaly_threshold = anomaly_threshold
        if paranoia_level is None:
            paranoia_level = getattr(ruleset, "paranoia_hint", None) or 2
        self.fail_open = fail_open
        self.stats = PipelineStats()
        # parallel confirm plane (docs/CONFIRM_PLANE.md): workers == 1
        # (the default) runs the classic serial walk inline — no
        # threads, no handoff; the serve plane sizes the pool via
        # --confirm-workers.  The batcher carries ONE pool across hot
        # swaps like the stats object, so a replacement pipeline's own
        # (inline, thread-free) pool is simply dropped.
        self.confirm_pool = ConfirmPool(n_workers=confirm_workers,
                                        hang_budget_s=confirm_hang_budget_s)
        #: per-cycle flood-memo capacity; 0 disables memoization
        self.confirm_memo_entries = int(confirm_memo_entries)
        # cross-cycle verdict cache (docs/RETUNE.md): opt-in (0 = off,
        # the default — per-cycle memo behavior unchanged).
        # Generation-keyed, so a hot swap never needs to invalidate for
        # soundness; swap/rollback still clear it for hygiene.  The
        # batcher carries ONE cache across hot swaps like the stats
        # object and the confirm pool.
        self.confirm_cache = (VerdictCache(int(confirm_cache_entries))
                              if confirm_cache_entries else None)
        # brownout ladder (docs/ROBUSTNESS.md): the serve batcher feeds
        # queue-delay observations and detect() consults the level; a
        # hot-swap carries the controller over with the stats object so
        # a reload under pressure doesn't reset the ladder
        self.load_controller = LoadController()
        self.tenant_rule_mask = tenant_rule_mask
        # bucket-set signatures served so far — a replacement pipeline
        # warms exactly these before it is swapped in
        self.seen_shapes: set = set()
        # per-lane twin of seen_shapes: (lane_index, buckets, Q_pad,
        # head_ok) entries — the batcher's hot-swap replay warms each
        # lane's card too
        self.seen_lane_shapes: set = set()
        # first loads already paid: the engine's exec_keys (a kernel or
        # a table replica per device) — the recompile gauge's ground
        # truth
        self._seen_exec: set = set()
        #: the outgoing generation's counters, frozen at the last
        #: hot-swap (drift's "before"; None until a swap happens)
        self.frozen_rule_stats = None
        self._install(ruleset, paranoia_level)

    # ------------------------------------------------------------- setup

    def _install(self, ruleset: CompiledRuleset, paranoia_level: int) -> None:
        self.ruleset = ruleset
        # the generation stamp verdicts carry: the ruleset version (a
        # learned scorer would extend it; none is ported)
        self.generation_tag = ruleset.version
        self.confirms = [ConfirmRule(m.confirm) for m in ruleset.rules]
        # detection-plane telemetry keyed by THIS generation's rule axis
        # (a swap starts fresh counters; the old ones freeze for drift)
        self.rule_stats = RuleStats(ruleset, self.confirms)
        self.paranoia_mask = ruleset.rule_paranoia <= paranoia_level
        self.needed_sv = set(
            int(sv) for sv in np.nonzero(ruleset.rule_sv_mask.any(axis=0))[0])
        # per-stream needed-variant tuples, resolved once per install —
        # the per-cycle host prep iterates these directly
        self._variants_for = needed_variants_by_stream(self.needed_sv)
        # head-slice qualification bound (docs/SCAN_KERNEL.md): rows
        # whose stream-variant ids all sit below this are uri/args/
        # headers rows and may scan the sliced head words
        self._n_head_sv = N_HEAD_SV
        # runtime ctl exclusions (CRS exclusion-package shape): resolve
        # the compile-time specs to index masks once per install —
        # finalize then applies plain boolean ops per request
        self.ctl_rules = []
        self._ctl_pass_idx = set()
        for ci, spec in sorted(getattr(ruleset, "ctl_specs", {}).items()):
            remove_mask = np.isin(
                ruleset.rule_ids, np.asarray(spec.get("remove_ids", []),
                                             dtype=np.int64))
            target_excl: dict = {}
            for rid_str, toks in spec.get("target_excl", {}).items():
                excl_map: dict = {}
                for tok in toks:
                    parsed = parse_exclusion_token(tok)
                    if parsed is None:
                        continue
                    kinds, sel = parsed
                    for kind in kinds:
                        excl_map.setdefault(kind, set()).add(sel)
                if not excl_map:
                    continue
                for idx in np.nonzero(
                        ruleset.rule_ids == int(rid_str))[0]:
                    merged = target_excl.setdefault(int(idx), {})
                    for kind, sels in excl_map.items():
                        merged.setdefault(kind, set()).update(sels)
            engine = spec.get("engine")
            if engine is None and spec.get("engine_off"):
                engine = "off"                 # legacy checkpoint key
            self.ctl_rules.append(
                (int(ci), remove_mask, target_excl, engine))
            if ruleset.rule_action[ci] == 0:   # pass-action config rule:
                self._ctl_pass_idx.add(int(ci))  # never a detection hit
        if self._ctl_pass_idx:
            # config machinery out of the health views (never-hit /
            # never-candidate) — it can't confirm by design
            self.rule_stats.ignored[sorted(self._ctl_pass_idx)] = True

    def swap_ruleset(self, ruleset: CompiledRuleset,
                     paranoia_level: Optional[int] = None) -> None:
        """Hot-swap (proton.db sync-node analog): atomic from the caller's
        perspective — in-flight batches finish on the old tables."""
        # swap_fail site BEFORE any mutation: a failed swap must leave
        # the serving generation untouched (fault-matrix invariant)
        faults.raise_if("swap_fail")
        self.engine.swap_ruleset(ruleset)
        if paranoia_level is None:   # same precedence as __init__
            paranoia_level = getattr(ruleset, "paranoia_hint", None) or 2
        frozen = self.rule_stats.freeze()
        self._install(ruleset, paranoia_level)
        self.frozen_rule_stats = frozen
        # cross-cycle verdict cache: generation-keyed entries from the
        # old pack can never serve the new one (soundness is in the
        # key), but they are dead weight — drop them at the boundary
        if self.confirm_cache is not None:
            self.confirm_cache.invalidate("swap_ruleset")

    def reset_detection_observations(self) -> None:
        """Zero the detection-plane telemetry (RuleStats counters + the
        resettable device-efficiency group) so it describes only the
        traffic that follows — called after warmup (whose synthetic
        corpus would otherwise pollute per-rule hit rates, and whose
        first loads would read as serve-time recompiles), the same
        convention as Batcher.reset_latency_observations."""
        self.rule_stats.reset()
        self.stats.reset_efficiency()

    def _count_new_executables(self, device=None) -> int:
        """How many first loads a dispatch on ``device`` (None = the
        engine's own) will pay: the engine's ``exec_keys`` this pipeline
        has not dispatched through yet — the live impl's kernel on that
        card and that card's table replica.  The kernels have no
        per-shape executables, so after warmup this stays 0 whatever
        shapes traffic brings.  Also records the keys as seen."""
        new = 0
        for key in self.engine.exec_keys(device):
            if key not in self._seen_exec:
                new += 1
                self._seen_exec.add(key)
        return new

    @staticmethod
    def _zero_buckets(buckets):
        n_sv = len(STREAMS) * len(VARIANTS)
        return tuple(
            (np.zeros((B, L), np.uint8), np.zeros((B,), np.int32),
             np.zeros((B,), np.int32), np.zeros((B, n_sv), np.int8))
            for B, L in buckets)

    def warm_lane_shape(self, buckets, Q_pad: int, head_ok: bool,
                        lane) -> None:
        """Dispatch one recorded bucket set with zero buffers on one
        LANE's card (the batcher's hot-swap replay): builds that card's
        table replica and scanner for this generation.  Runs on the
        CALLING thread, on that card."""
        self._count_new_executables(lane.device)
        self.seen_lane_shapes.add((lane.index, tuple(buckets), Q_pad,
                                   head_ok))
        self.engine.detect_device_multi(self._zero_buckets(buckets), Q_pad,
                                        head_only=head_ok,
                                        device=lane.device)

    def warm_shape(self, buckets, Q_pad: int,
                   head_ok: bool = False) -> None:
        """Dispatch one recorded bucket set with zero buffers (the
        serving swap path).  ``buckets`` is a bucket-set signature — a
        tuple of (B, L) row shapes, exactly a ``seen_shapes`` entry's
        first element.  When this pipeline's pack is word-tiered but the
        replayed entry came from an untiered incumbent (head_ok=False),
        the head-sliced twin is dispatched too."""
        variants = [head_ok]
        if not head_ok and self.engine.head_slicing_active():
            variants.append(True)
        for head in variants:
            self.engine.detect_device_multi(self._zero_buckets(buckets),
                                            Q_pad, head_only=head)
            self._count_new_executables()
            self.seen_shapes.add((tuple(buckets), Q_pad, head))

    # ------------------------------------------------------------ detect

    def detect(self, requests: Sequence[Request]) -> List[Verdict]:
        t0 = time.perf_counter()
        requests = list(requests)
        if not requests:
            return []
        try:
            return self._detect_inner(requests, t0)
        except Exception:
            if not self.fail_open:
                raise
            # fail-open contract (wallarm-fallback): pass + flag
            self.stats.count_fail_open(len(requests))
            return [
                Verdict(request_id=r.request_id, blocked=False, attack=False,
                        classes=[], rule_ids=[], score=0, fail_open=True)
                for r in requests
            ]

    def detect_strict(self, requests: Sequence[Request]) -> List[Verdict]:
        """``detect`` minus the fail-open catch: the serve batcher uses
        this so its circuit breaker can COUNT device failures before
        producing the fail-open verdicts itself — library callers keep
        ``detect``'s swallow-and-flag contract."""
        t0 = time.perf_counter()
        requests = list(requests)
        if not requests:
            return []
        return self._detect_inner(requests, t0)

    def detect_tenant_degraded(self,
                               requests: Sequence[Request]) -> List[Verdict]:
        """Per-tenant brownout rung (models/tenant_guard.py,
        docs/ROBUSTNESS.md "Tenant isolation"): a quarantined tenant's
        admitted traffic is served prefilter-only — sound candidates
        score and flag, ``Verdict.degraded=True``, never blocks — while
        every other tenant keeps full detection.  The global ladder's
        rung 1, scoped to one tenant; the confirm lane (the dominant
        CPU cost a flood would monopolize) is skipped entirely.
        Counts requests but not batches: the admission cycle it rides
        already counted."""
        t0 = time.perf_counter()
        requests = list(requests)
        if not requests:
            return []
        self.stats.requests += len(requests)
        try:
            return self._finalize_prefilter_only(
                requests, self.prefilter(requests), t0)
        except Exception:
            if not self.fail_open:
                raise
            self.stats.count_fail_open(len(requests))
            self.stats.count_degraded(len(requests))
            return [
                Verdict(request_id=r.request_id, blocked=False,
                        attack=False, classes=[], rule_ids=[], score=0,
                        fail_open=True, degraded=True)
                for r in requests
            ]

    def detect_cpu_only(self, requests: Sequence[Request]) -> List[Verdict]:
        """Breaker-open fallback (docs/ROBUSTNESS.md): exact confirm
        semantics with ZERO device dispatch — every masked (request,
        rule) pair becomes a confirm candidate.  Sound because the
        prefilter only ever narrows; slower because the confirm lane
        does the narrowing work itself.

        CPU pipelines only: on a card this raises RuntimeError, so no
        kernel fault can move the detection work to the host (the
        serve batcher fails such batches open instead)."""
        if self.engine.device.type != "cpu":
            raise RuntimeError(
                "detect_cpu_only runs only on a CPU pipeline, not on %s"
                % self.engine.device)
        t0 = time.perf_counter()
        requests = list(requests)
        if not requests:
            return []
        try:
            self.stats.requests += len(requests)
            self.stats.batches += 1
            hits = np.ones((len(requests), self.ruleset.n_rules),
                           dtype=bool)
            # observe_rules=False: the synthetic all-ones candidate
            # matrix would otherwise swamp the per-rule false-candidate
            # ranking (/rules/health) for the whole breaker-open window
            return self.finalize(requests, self.mask_hits(requests, hits),
                                 t0, observe_rules=False)
        except Exception:
            if not self.fail_open:
                raise
            self.stats.count_fail_open(len(requests))
            return [
                Verdict(request_id=r.request_id, blocked=False, attack=False,
                        classes=[], rule_ids=[], score=0, fail_open=True)
                for r in requests
            ]

    def detect_launch(self, requests: Sequence[Request], lane=None,
                      count_batch: bool = True):
        """First half of ``detect_strict`` for one serve lane's share
        of a mesh cycle (docs/MESH_SERVING.md): host prep NOW, on the
        calling dispatch thread (single-writer stats hold), device scan
        ASYNC on the lane's worker thread against tables replicated to
        the lane's device.  Returns a job for :meth:`detect_collect`;
        splitting at the device boundary is what lets the batcher
        overlap the next cycle's pad/pack/normalize with this cycle's
        dispatch (double-buffered transfer) and bound each lane's wait
        independently (per-lane watchdog)."""
        t0 = time.perf_counter()
        requests = list(requests)
        job = _ScanJob(requests=requests, t0=t0, lane=lane)
        if not requests:
            return job
        st = self.stats
        st.requests += len(requests)
        if count_batch:
            # one admission cycle = one batch regardless of how many
            # lane shares it splits into — the mesh batcher counts the
            # cycle's FIRST share only, so stats.batches keeps its
            # single-lane meaning
            st.batches += 1
        job.level = self.load_controller.level
        if job.level >= 2:
            return job        # collect produces fail-open verdicts
        (buckets, bucket_shapes, head_ok, bucket_us,
         live_rows, padded_rows) = self._scan_prep(requests)
        job.head_ok = head_ok
        job.live_rows = live_rows
        job.padded_rows = padded_rows
        if not buckets:
            return job
        Q_pad = self._pad_q(len(requests))
        engine = self.engine
        device = lane.device if lane is not None else None
        st.engine_us += bucket_us   # pad/pack rides the scan stage
        st.engine_compiles += self._count_new_executables(device)
        if lane is not None:
            self.seen_lane_shapes.add(
                (lane.index, bucket_shapes, Q_pad, head_ok))
        else:
            self.seen_shapes.add((bucket_shapes, Q_pad, head_ok))
        # flight recorder: the cycle id travels with the closure onto
        # the lane worker (read HERE on the dispatch thread)
        trace_cycle = flight.cycle()
        trace_lane = lane.index if lane is not None else 0

        def _dispatch():
            tb0 = time.perf_counter()
            flight.set_cycle(trace_cycle)
            flight.begin(EV_DEVICE, cycle=trace_cycle, tag=trace_lane,
                         arg=len(requests))
            try:
                # the copy back (numpy out) happens here, on the lane
                # worker: the dispatch thread never waits on the card
                return engine.detect_device_multi(
                    tuple(buckets), Q_pad, head_only=head_ok,
                    device=device)
            finally:
                # device busy time measured INSIDE the worker: the
                # overlap design means launch→collect wall includes a
                # whole drain window — that must not book as scan time
                job.busy_us = int((time.perf_counter() - tb0) * 1e6)
                flight.end(EV_DEVICE, cycle=trace_cycle, tag=trace_lane)

        if lane is not None:
            job.pending = lane.submit(_dispatch)
        else:
            job.result = _dispatch()
        return job

    def detect_collect_launch(self, job,
                              timeout: Optional[float] = None):
        """First half of :meth:`detect_collect` (docs/CONFIRM_PLANE.md):
        bound-wait the DEVICE result, mask, and LAUNCH the confirm
        phase on the pool — without joining it.  Raises ``DeviceHang``
        (lane wedged past ``timeout``) or the dispatch's own error,
        exactly like ``detect_collect`` did, so the batcher's per-lane
        breaker accounting is unchanged.  Returns a ``_FinishJob`` for
        :meth:`detect_collect_join`; degenerate paths (empty share,
        brownout rungs) resolve to verdicts immediately inside it."""
        requests = job.requests
        fin = _FinishJob()
        if not requests:
            fin.verdicts = []
            return fin
        st = self.stats
        if job.level >= 2:
            st.count_fail_open(len(requests))
            st.count_degraded(len(requests))
            fin.verdicts = [
                Verdict(request_id=r.request_id, blocked=False,
                        attack=False, classes=[], rule_ids=[], score=0,
                        fail_open=True, degraded=True)
                for r in requests
            ]
            return fin
        Q = len(requests)
        rule_hits = np.zeros((self._pad_q(Q), self.ruleset.n_rules),
                             dtype=bool)
        if job.pending is not None:
            rule_hits |= job.pending.wait(timeout)
            st.engine_us += job.busy_us
        elif job.result is not None:
            rule_hits |= job.result
            st.engine_us += job.busy_us
        masked = self.mask_hits(requests, rule_hits[:Q])
        st.prefilter_rule_hits += int(masked.sum())
        if job.level == 1:
            fin.verdicts = self._finalize_prefilter_only(requests, masked,
                                                         job.t0)
            return fin
        fin.t0 = job.t0
        fin.cjob = self.finalize_launch(requests, masked)
        return fin

    def detect_collect_join(self, fin) -> List[Verdict]:
        """Second half of :meth:`detect_collect`: bounded-join the
        confirm shares and fold verdicts.  With ``--confirm-workers``
        > 1 the batcher's mesh loop calls this one drain later than
        the launch, so cycle N's confirm overlaps cycle N+1's scan
        dispatch (docs/CONFIRM_PLANE.md)."""
        if fin.verdicts is not None:
            return fin.verdicts
        return self.finalize_join(fin.cjob, fin.t0)

    def detect_collect(self, job,
                       timeout: Optional[float] = None) -> List[Verdict]:
        """Second half of :meth:`detect_launch`: bound-wait the device
        result, then mask + confirm + score exactly as ``detect``
        would.  Raises ``DeviceHang`` (lane wedged past ``timeout``) or
        the dispatch's own error — ``detect_strict`` semantics, so the
        batcher's per-lane breaker can count failures before producing
        the fail-open verdicts itself."""
        return self.detect_collect_join(
            self.detect_collect_launch(job, timeout))

    def _detect_inner(self, requests: List[Request], t0: float) -> List[Verdict]:
        self.stats.requests += len(requests)
        self.stats.batches += 1
        level = self.load_controller.level
        if level >= 2:
            # brownout floor for requests already queued before the
            # ladder reached fail-open (admission sheds new arrivals):
            # pass + flag, no scan work at all
            self.stats.count_fail_open(len(requests))
            self.stats.count_degraded(len(requests))
            return [
                Verdict(request_id=r.request_id, blocked=False, attack=False,
                        classes=[], rule_ids=[], score=0, fail_open=True,
                        degraded=True)
                for r in requests
            ]
        hits = self.prefilter(requests)
        if level == 1:
            return self._finalize_prefilter_only(requests, hits, t0)
        return self.finalize(requests, hits, t0)

    def _finalize_prefilter_only(self, requests: List[Request],
                                 rule_hits: np.ndarray,
                                 t0: float) -> List[Verdict]:
        """Brownout rung 1: score straight from the sound prefilter
        candidates — the confirm lane (the serve plane's dominant CPU
        cost) is skipped.  Candidates over-approximate confirmed hits,
        so degraded verdicts FLAG but never BLOCK (fail-open bias: an
        unconfirmed candidate must not 403 a legitimate request)."""
        rs = self.ruleset
        verdicts: List[Verdict] = []
        for qi, req in enumerate(requests):
            cand = [int(r) for r in np.nonzero(rule_hits[qi])[0]
                    if int(r) not in self._ctl_pass_idx]
            score = int(rs.rule_score[cand].sum()) if cand else 0
            verdicts.append(Verdict(
                request_id=req.request_id,
                blocked=False,
                attack=bool(cand) and score >= self.anomaly_threshold,
                classes=sorted({CLASSES[rs.rule_class[r]] for r in cand}),
                rule_ids=[int(rs.rule_ids[r]) for r in cand[:32]],
                score=score,
                degraded=True,
            ))
        # candidates still feed the per-rule telemetry (nothing
        # confirmed — an honest zero, not a gap); confirm_us untouched.
        # The learned head does NOT score this rung: it is calibrated on
        # confirmed hits, and candidates over-approximate — fixed
        # weights keep the degraded path's never-blocks contract simple
        self.rule_stats.observe_finalize(rule_hits[:len(requests)], [], [])
        self.stats.count_degraded(len(requests))
        elapsed = int((time.perf_counter() - t0) * 1e6)
        for v in verdicts:
            v.elapsed_us = elapsed
            v.generation = self.generation_tag
        return verdicts

    def _build_scan_buckets(self, requests: List[Request]):
        """Host prep: normalize rows, merge, L-tier bucket/pad/pack.
        Returns ``(buckets, head_ok)``; ``buckets`` is empty when no
        request carries scannable bytes."""
        buckets, _shapes, head_ok, _us, _live, _padded = \
            self._scan_prep(requests)
        return buckets, head_ok

    def _scan_prep(self, requests: List[Request]):
        """Host prep shared by ``prefilter`` (the synchronous single-
        lane path) and ``detect_launch`` (the per-lane path): normalize
        rows, merge, L-tier bucket/pad/pack, and the device-efficiency
        accounting.  Returns ``(buckets, bucket_shapes, head_ok,
        bucket_us, live_rows, padded_rows)``; ``buckets`` is empty when
        no request carries scannable bytes.  stats.prep_us gets the
        normalize/merge cost; the pad/pack cost (``bucket_us``) rides
        the scan stage — the caller adds it to engine_us
        (docs/OBSERVABILITY.md)."""
        tp0 = time.perf_counter()
        flight.begin(EV_PREP)
        if faults.fire("recompile_storm"):
            # injected loss of everything loaded: forget every warm
            # shape and drop the engine's scanners and replicas — the
            # following dispatches pay first loads again
            # (ipt_engine_recompiles_total)
            self.seen_shapes.clear()
            self.seen_lane_shapes.clear()
            self._seen_exec.clear()
            self.engine.drop_compiled()
        # one-pass normalize+merge: shared decode intermediates +
        # identity-first dedup, byte-identical to
        # merge_rows(rows_for_requests(...))
        data_list, req_list, sv_list = merged_rows_for_requests(
            requests, variants_for=self._variants_for)
        Q = len(requests)
        # MeasuredProfile byte axis (docs/RETUNE.md): fold the scanned
        # bytes into the sampled histogram — budgeted, so this is a
        # no-op once a few MiB of traffic shape have been observed
        self.rule_stats.observe_bytes(data_list)
        stats = self.stats
        # stage attribution: everything up to here is host prep (the
        # per-bucket pad/pack below is interleaved with async dispatch
        # and rides the scan stage — documented in docs/OBSERVABILITY.md)
        stats.prep_us += int((time.perf_counter() - tp0) * 1e6)
        flight.end(EV_PREP, arg=len(requests))
        if not data_list:
            return [], (), False, 0, 0, 0
        te0 = time.perf_counter()
        n_sv = len(STREAMS) * len(VARIANTS)
        # rows bucket into fixed L tiers, row counts pad to powers of
        # two, and Q pads likewise: a bounded set of launch shapes
        by_bucket: Dict[int, List[int]] = {}
        for i, d in enumerate(data_list):
            for L in self.L_BUCKETS:
                if len(d) <= L or L == self.L_BUCKETS[-1]:
                    by_bucket.setdefault(L, []).append(i)
                    break
        # head_ok: no row carries a body/response stream-variant ⇒ the
        # sliced head words suffice (docs/SCAN_KERNEL.md).
        head_ok = (self.engine.head_slicing_active()
                   and all(s < self._n_head_sv
                           for sv in sv_list for s in sv))
        buckets = []
        live_rows = padded_rows = 0
        for L, idxs in sorted(by_bucket.items()):
            B_pad = self._pad_q(len(idxs), floor=8)
            stats.truncated_rows += sum(
                1 for i in idxs if len(data_list[i]) > L)
            rows_b = [data_list[i][:L] for i in idxs]
            rows_b += [b""] * (B_pad - len(idxs))
            tokens, lengths = pad_rows(rows_b, max_len=L, round_to=L)
            row_req = np.zeros((B_pad,), np.int32)
            row_req[: len(idxs)] = [req_list[i] for i in idxs]
            row_req[len(idxs):] = self._pad_q(Q) - 1
            row_sv = np.zeros((B_pad, n_sv), dtype=np.int8)
            for j, i in enumerate(idxs):
                row_sv[j, sv_list[i]] = 1
            buckets.append((tokens, lengths, row_req, row_sv))
            nbytes = sum(len(r) for r in rows_b)
            stats.rows += len(idxs)
            stats.row_bytes += nbytes
            stats.live_rows += len(idxs)
            stats.live_row_bytes += nbytes
            stats.padded_rows += B_pad
            stats.padded_bytes += B_pad * tokens.shape[1]
            stats.bucket_rows[L] = \
                stats.bucket_rows.get(L, 0) + len(idxs)
            stats.bucket_padded_rows[L] = \
                stats.bucket_padded_rows.get(L, 0) + B_pad
            live_rows += len(idxs)
            padded_rows += B_pad
        bucket_shapes = tuple((b[0].shape[0], b[0].shape[1])
                              for b in buckets)
        bucket_us = int((time.perf_counter() - te0) * 1e6)
        return (buckets, bucket_shapes, head_ok, bucket_us,
                live_rows, padded_rows)

    def prefilter(self, requests: List[Request]) -> np.ndarray:
        """Scan stage: requests → masked (Q, R) prefilter rule hits.
        Exposed separately so the streaming body path (serve/stream.py)
        can scan a body-less request now and OR in chunk-carried body
        hits at stream end."""
        Q = len(requests)
        stats = self.stats
        (buckets, bucket_shapes, head_ok, bucket_us,
         _live, _padded) = self._scan_prep(requests)
        R = self.ruleset.n_rules
        rule_hits = np.zeros((self._pad_q(Q), R), dtype=bool)
        if buckets:
            te0 = time.perf_counter()
            # lane attribution from the worker's thread-local stamp
            # (utils/faults): canary/tenant-degraded/stream scans ride
            # whichever lane is serving; -1 = a host thread with no
            # lane (warmup, library callers)
            _lane = faults.current_lane()
            _ltag = _lane if _lane is not None else -1
            flight.begin(EV_DEVICE, tag=_ltag, arg=Q)
            # single-mapping dispatch (docs/SCAN_KERNEL.md): each bucket
            # is one kernel launch, the factor→rule mapping runs once
            # per batch
            stats.engine_compiles += self._count_new_executables()
            self.seen_shapes.add((bucket_shapes, self._pad_q(Q), head_ok))
            rule_hits |= self.engine.detect_device_multi(
                tuple(buckets), self._pad_q(Q), head_only=head_ok)
            stats.engine_us += bucket_us + int(
                (time.perf_counter() - te0) * 1e6)
            flight.end(EV_DEVICE, tag=_ltag)
        rule_hits = self.mask_hits(requests, rule_hits[:Q])
        stats.prefilter_rule_hits += int(rule_hits.sum())
        return rule_hits

    def mask_hits(self, requests: List[Request],
                  rule_hits: np.ndarray) -> np.ndarray:
        """Tenant (EP) + paranoia masking, idempotent.

        Tenant ids outside the table fall back to row 0 = full ruleset (a
        wrap onto another tenant's restricted mask would be a scan
        bypass)."""
        if self.tenant_rule_mask is not None:
            tenants = np.asarray([r.tenant for r in requests], dtype=np.int32)
            T = self.tenant_rule_mask.shape[0]
            tenants = np.where((tenants >= 0) & (tenants < T), tenants, 0)
            rule_hits = rule_hits & self.tenant_rule_mask[tenants]
        return rule_hits & self.paranoia_mask[None, :]

    def finalize_launch(self, requests: List[Request],
                        rule_hits: np.ndarray):
        """Start the confirm phase for one batch of already-masked
        prefilter hits (docs/CONFIRM_PLANE.md): the per-request
        candidate walks run on the confirm pool — inline (the classic
        serial path) at ``--confirm-workers 1``, as round-robin request
        shares on the worker threads otherwise.  Returns the job for
        :meth:`finalize_join`."""
        return launch_confirm(self, requests, rule_hits)

    def finalize(self, requests: List[Request], rule_hits: np.ndarray,
                 t0: float, observe_rules: bool = True) -> List[Verdict]:
        """Confirm + scoring stage on already-masked prefilter hits.
        ``observe_rules=False`` skips the per-rule telemetry fold —
        the CPU-fallback path passes a synthetic full candidate matrix
        that must not book as prefilter statistics."""
        return self.finalize_join(self.finalize_launch(requests, rule_hits),
                                  t0, observe_rules=observe_rules)

    def finalize_join(self, cjob, t0: float,
                      observe_rules: bool = True) -> List[Verdict]:
        """Bounded-join the confirm shares, then the SINGLE-THREADED
        fold: telemetry, scoring, ACL, Verdict assembly.  A request
        whose confirm share wedged past the pool's hang budget fails
        open HERE (only that share — siblings' verdicts are exact);
        everything else is the pre-pool serial finalize, verdict for
        verdict."""
        stats = self.stats
        tc0 = time.perf_counter()
        flight.begin(EV_FINALIZE, arg=len(cjob.requests))
        results = join_confirm(self, cjob)
        requests, rule_hits = cjob.requests, cjob.rule_hits
        verdicts: List[Verdict] = []
        rs = self.ruleset
        # per-rule telemetry accumulators for this batch (folded into
        # RuleStats in ONE vectorized update after the loop);
        # excl_rows: requests where a matched runtime-ctl rule removed
        # rules before confirm — those (request, rule) candidates were
        # never confirm-evaluated and must not book as wasted confirms;
        # failed_rows: requests whose confirm share wedged — nothing
        # about them was evaluated, so they book as neither candidates
        # nor wasted confirms
        all_confirmed: List[int] = []
        all_blocked: List[bool] = []
        confirmed_rows: List[List[int]] = []
        excl_rows: List[tuple] = []
        failed_rows: List[int] = []
        ridx_all: List[int] = []
        rns_all: List[int] = []
        for qi, req in enumerate(requests):
            res = results[qi]
            if res is None:
                # this request's confirm share wedged: fail open, the
                # wallarm-fallback answer — detection degrades for the
                # wedged worker's share only, traffic does not
                failed_rows.append(qi)
                stats.count_fail_open()
                confirmed_rows.append([])
                verdicts.append(Verdict(
                    request_id=req.request_id, blocked=False,
                    attack=False, classes=[], rule_ids=[], score=0,
                    fail_open=True))
                continue
            confirmed = res.confirmed
            points = res.points
            detection_only = res.detection_only
            if res.excluded is not None:
                excl_rows.append((qi, res.excluded))
            ridx_all.extend(res.rule_idx)
            rns_all.extend(res.rule_ns)
            score = int(rs.rule_score[confirmed].sum()) if confirmed else 0
            classes = sorted(
                {CLASSES[rs.rule_class[r]] for r in confirmed})
            attack = bool(confirmed) and score >= self.anomaly_threshold
            deny = any(rs.rule_action[r] == 2 for r in confirmed)
            # --- ACL evaluation (wallarm-acl): longest-prefix decision
            # over the tenant-bound (or default) list.  deny blocks
            # outright (subject to mode), allow exempts the source from
            # detection blocking (still monitored), greylist feeds
            # safe_blocking below.  Unknown ACL/IP → None → no effect
            # (fail-open, like wallarm-fallback).
            acl_name = self.tenant_acl.get(
                getattr(req, "tenant", 0), self.default_acl)
            decision = self.acl_store.evaluate(
                acl_name, getattr(req, "client_ip", ""))
            greylisted = getattr(req, "greylisted", False) or \
                decision == "greylist"
            # per-request mode (the wallarm_mode location directive
            # shipped in the frame) can only weaken the global mode,
            # mirroring wallarm-mode-allow-override's default policy.
            # safe_blocking (strength 2) blocks only greylisted sources.
            eff = min(MODE_NAME_STRENGTH.get(self.mode, 3),
                      MODE_STRENGTH.get(getattr(req, "mode", 2), 3))
            mode_blocks = eff >= 3 or (eff == 2 and greylisted)
            blocked = (mode_blocks and (attack or deny)
                       and not detection_only and decision != "allow")
            if decision == "deny" and eff >= 1:
                # ACL denies are enforcement, not detection: any
                # non-off mode blocks them (monitoring only flags)
                classes = sorted(set(classes) | {"acl"})
                blocked = blocked or eff >= 2
                attack = True
            verdicts.append(Verdict(
                request_id=req.request_id,
                blocked=blocked,
                attack=attack,
                classes=classes,
                rule_ids=[int(rs.rule_ids[r]) for r in confirmed],
                score=score,
                matches=points,
            ))
            all_confirmed.extend(confirmed)
            all_blocked.extend([blocked] * len(confirmed))
            confirmed_rows.append(confirmed)
        if observe_rules:
            cand_hits = rule_hits[:len(requests)]
            if excl_rows or failed_rows:
                # copy only when a runtime ctl exclusion actually
                # matched or a confirm share wedged (both rare);
                # ctl-pass config rules are suppressed inside
                # observe_finalize via the RuleStats.ignored mask
                cand_hits = cand_hits.copy()
                for qi, ex in excl_rows:
                    cand_hits[qi, ex] = False
                for qi in failed_rows:
                    cand_hits[qi, :] = False
            self.rule_stats.observe_finalize(
                cand_hits, all_confirmed, all_blocked,
                confirmed_rows=confirmed_rows,
                rule_ns=(ridx_all, rns_all) if ridx_all else None)
        if cjob.memo is not None:
            stats.confirm_memo_hits += cjob.memo.hits
            stats.confirm_memo_misses += cjob.memo.misses
        # confirm stage wall = launch window + this join (share waits +
        # fold).  On the overlapped mesh path the wall BETWEEN launch
        # and join is the double buffer's window, not confirm cost —
        # excluded by construction; the per-rule confirm_ns telemetry
        # (RuleStats) carries the true CPU cost either way.
        stats.confirm_us += cjob.launch_us + int(
            (time.perf_counter() - tc0) * 1e6)
        stats.confirmed_rule_hits += sum(len(v.rule_ids) for v in verdicts)
        flight.end(EV_FINALIZE)

        elapsed = int((time.perf_counter() - t0) * 1e6)
        # worker attribution: the pool round-robins
        # request qi onto worker qi % N (confirm_plane.launch_confirm),
        # so the stamp is derivable without threading state through the
        # walk; 0 = the inline serial walk, wedged shares keep -1
        nw = self.confirm_pool.n_workers
        for qi, v in enumerate(verdicts):
            v.elapsed_us = elapsed
            v.generation = self.generation_tag
            if not v.fail_open:
                v.confirm_worker = (qi % nw) if nw > 1 else 0
        return verdicts
