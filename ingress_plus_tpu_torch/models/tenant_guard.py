"""Per-tenant flood guard — blast-radius isolation for the serve plane
(docs/ROBUSTNESS.md "Tenant isolation").

The reference node serves many applications behind one ingress; the
batcher's overload machinery (queue cap, deadline shedding, brownout ladder) is
GLOBAL, so one flooding tenant used to brown out every tenant on the
box.  Fair admission (serve/batcher.py ``_TenantFairQueue``) confines a
flood's queueing damage to the flooding tenant's own sub-queue; this
module confines its *compute* damage: a tenant that keeps breaching its
admission budget gets its own brownout rung — served prefilter-only
(sound candidates score and flag, never block, ``Verdict.degraded``) or
shed fail-open, per policy — while every other tenant keeps full
detection and the global :class:`~ingress_plus_tpu_torch.models.pipeline.
LoadController` ladder remains the backstop for genuinely systemic
overload.

Breach semantics (evaluated once per ``window_s`` fold, hysteresis like
the global ladder's):

* a tenant breaches when, within one window, it drew more than
  ``max_share`` of all arrivals (weighted budgets ride the DRR weights,
  not this share) AND the flood actually *hurt* — its requests shed, or
  its sub-queue depth crossed the trigger — AND at least two tenants
  were active (with ONE tenant on the box the global ladder is the
  authority: quarantining the only tenant would just be a worse
  brownout, and the single-tenant serve path must stay byte-identical);
* ``up_confirm_windows`` consecutive breaching windows quarantine the
  tenant (fire-slow: one bursty window is traffic, not abuse);
* release only after ``dwell_s`` with no breach — the flap damper.

Tracking is bounded: at most ``max_tracked`` tenants get their own
state; later tenants share the ``OVERFLOW`` bucket, which is counted
but NEVER quarantined (punishing an aggregate of unrelated tenants
would be a cross-tenant outage, the exact failure this module exists to
prevent).

Thread-safety: unlike the stats counters (single-writer by
construction), the guard is driven from every thread that calls
``Batcher.submit`` — which was thread-safe before this layer existed
and must stay so (the tenant-iso bench submits from a flooder thread
and the pacer concurrently).  One small lock serializes the window
fold against concurrent arrival/shed bookkeeping; the hot path is one
uncontended acquire per arrival, the same budget the old
``queue.Queue`` admission paid.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ingress_plus_tpu_torch.post.topk import SpaceSaving
from ingress_plus_tpu_torch.utils.trace import Ewma, named_lock

#: shared bucket for tenants past ``max_tracked`` — counted, never
#: quarantined
OVERFLOW = -1

#: per-tenant brownout rungs (mirrors models/pipeline.BROWNOUT_LEVELS)
GUARD_LEVELS = ("full", "prefilter_only", "fail_open")


def parse_tenant_weights(spec: Optional[str]) -> Dict[int, float]:
    """``--tenant-weights`` parser: ``"1:4,7:0.5"`` → {1: 4.0, 7: 0.5}.
    Weights scale the DRR quantum (serve/batcher.py) — a weight-2
    tenant drains twice the bytes per round.  Clamped to a small
    positive floor: a zero weight would starve the tenant forever (and
    stall the DRR rotation)."""
    out: Dict[int, float] = {}
    if not spec:
        return out
    for part in filter(None, (p.strip() for p in spec.split(","))):
        k, sep, v = part.partition(":")
        if not sep:
            raise ValueError("tenant weight %r is not tenant:weight" % part)
        out[int(k)] = max(float(v), 0.01)
    return out


@dataclass
class TenantGuardConfig:
    #: arrival-share fold window
    window_s: float = 0.25
    #: a tenant over this share of one window's arrivals is a flood
    #: suspect (budget check; the damage checks below must also hold)
    max_share: float = 0.5
    #: windows with fewer total arrivals never breach (idle boxes have
    #: wild shares; a flood by definition has volume)
    min_window_arrivals: int = 32
    #: consecutive breaching windows before quarantine
    up_confirm_windows: int = 2
    #: seconds without a breach before a quarantined tenant releases
    dwell_s: float = 2.0
    #: quarantine serving policy: "prefilter_only" (admitted, scanned,
    #: scored, flagged — confirm lane skipped, never blocks) or
    #: "fail_open" (shed at admission, reason="tenant_flood")
    policy: str = "prefilter_only"
    #: per-tenant state budget; later tenants share OVERFLOW
    max_tracked: int = 1024
    #: sub-queue depth (as a fraction of the per-tenant cap) that counts
    #: as flood damage even before anything sheds
    depth_trigger_frac: float = 0.5


class _TenantState:
    __slots__ = ("admitted", "shed", "degraded", "shed_reasons",
                 "win_arrivals", "win_shed", "win_peak_depth",
                 "rate_ewma", "shed_ewma", "breach_windows",
                 "last_breach", "quarantined_since")

    def __init__(self) -> None:
        self.admitted = 0
        self.shed = 0
        self.degraded = 0
        self.shed_reasons: Dict[str, int] = {}
        self.win_arrivals = 0
        self.win_shed = 0
        self.win_peak_depth = 0
        self.rate_ewma = Ewma(alpha=0.3)     # arrivals/s at fold
        self.shed_ewma = Ewma(alpha=0.3)     # sheds/s at fold
        self.breach_windows = 0
        self.last_breach = 0.0
        self.quarantined_since: Optional[float] = None


class TenantGuard:
    def __init__(self, config: Optional[TenantGuardConfig] = None):
        self.config = config or TenantGuardConfig()
        if self.config.policy not in GUARD_LEVELS[1:]:
            raise ValueError("tenant-guard policy must be %s, got %r"
                             % ("|".join(GUARD_LEVELS[1:]),
                                self.config.policy))
        self._lock = named_lock("TenantGuard._lock")
        self._states: Dict[int, _TenantState] = {}
        self._quarantined: Dict[int, float] = {}   # tenant → since ts
        self._win_touched: Set[int] = set()
        self._win_total = 0
        #: window base, rebased on the FIRST arrival's clock — callers
        #: may inject ``now`` (tests drive a synthetic clock), so the
        #: base must come from the same clock as the observations
        self._win_start: Optional[float] = None
        #: absolute sub-queue depth that reads as flood damage —
        #: derived from the batcher's per-tenant cap (configure_depth)
        self.depth_trigger = 64
        self.quarantines = 0    # cumulative quarantine entries
        self.releases = 0
        #: top shed/degraded tenants (bounded SpaceSaving sketch — the
        #: "top offenders" view survives any tenant cardinality)
        self.top_offenders = SpaceSaving(capacity=32)

    # ------------------------------------------------------- wiring

    def configure_depth(self, tenant_queue_cap: int) -> None:
        self.depth_trigger = max(
            1, int(tenant_queue_cap * self.config.depth_trigger_frac))

    def _track(self, tenant: int) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            if len(self._states) >= self.config.max_tracked:
                tenant = OVERFLOW
                st = self._states.get(OVERFLOW)
                if st is None:
                    st = self._states[OVERFLOW] = _TenantState()
            else:
                st = self._states[tenant] = _TenantState()
        return st

    # ------------------------------------------------------ hot path

    def observe_arrival(self, tenant: int, depth: int = 0,
                        now: Optional[float] = None) -> int:
        """One admission-time arrival for ``tenant`` (its sub-queue at
        ``depth``); returns the tenant's brownout level: 0 full
        detection, 1 prefilter-only, 2 shed fail-open.  Folds the
        window when it has elapsed — submit-thread-driven, no timer."""
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._track(tenant)
            st.win_arrivals += 1
            if depth > st.win_peak_depth:
                st.win_peak_depth = depth
            self._win_total += 1
            self._win_touched.add(tenant if tenant in self._states
                                  else OVERFLOW)
            if self._win_start is None:
                self._win_start = now
            elif now - self._win_start >= self.config.window_s:
                self._fold(now)
        return self.level(tenant)

    def level(self, tenant: int) -> int:
        if tenant not in self._quarantined:
            return 0
        return 1 if self.config.policy == "prefilter_only" else 2

    def is_quarantined(self, tenant: int) -> bool:
        return tenant in self._quarantined

    def quarantined_ids(self) -> Tuple[int, ...]:
        """Snapshot of the quarantined tenant ids (the admission
        queue-math exclusion set — quarantined backlog is prefilter-
        only-cheap and must not shed victims).  Copied under the lock:
        another submit thread may fold the window and resize the dict
        mid-iteration."""
        with self._lock:
            return tuple(self._quarantined)

    def on_admit(self, tenant: int) -> None:
        with self._lock:
            self._track(tenant).admitted += 1

    def on_shed(self, tenant: int, reason: str) -> None:
        with self._lock:
            st = self._track(tenant)
            st.shed += 1
            st.win_shed += 1
            st.shed_reasons[reason] = st.shed_reasons.get(reason, 0) + 1
        self.top_offenders.offer(str(tenant))

    def on_degraded(self, tenant: int, n: int = 1) -> None:
        with self._lock:
            st = self._track(tenant)
            st.degraded += n
        self.top_offenders.offer(str(tenant), inc=n)

    # ----------------------------------------------------- fold/breach

    def _fold(self, now: float) -> None:
        # caller holds self._lock
        cfg = self.config
        win_len = max(now - self._win_start, 1e-6)
        total = self._win_total
        active = sum(1 for t in self._win_touched
                     if self._states[t].win_arrivals)
        for t in self._win_touched | set(self._quarantined):
            st = self._states.get(t)
            if st is None:
                continue
            st.rate_ewma.update(st.win_arrivals / win_len)
            st.shed_ewma.update(st.win_shed / win_len)
            share = st.win_arrivals / total if total else 0.0
            damage = (st.win_shed > 0
                      or st.win_peak_depth >= self.depth_trigger)
            breach = (t != OVERFLOW
                      and active >= 2
                      and total >= cfg.min_window_arrivals
                      and share > cfg.max_share
                      and damage)
            if breach:
                st.breach_windows += 1
                st.last_breach = now
                if (st.quarantined_since is None
                        and st.breach_windows >= cfg.up_confirm_windows):
                    st.quarantined_since = now
                    self._quarantined[t] = now
                    self.quarantines += 1
            else:
                st.breach_windows = 0
                if (st.quarantined_since is not None
                        and now - st.last_breach >= cfg.dwell_s):
                    st.quarantined_since = None
                    self._quarantined.pop(t, None)
                    self.releases += 1
            st.win_arrivals = 0
            st.win_shed = 0
            st.win_peak_depth = 0
        self._win_touched.clear()
        self._win_total = 0
        self._win_start = now

    # ---------------------------------------------------- observability

    def counters(self) -> Dict[str, Dict[str, int]]:
        """Bounded per-tenant counter dicts for the ``ipt_tenant_*``
        Prometheus series (utils/trace.bounded_counter_series folds the
        tail into label="other"; the -1 key is the tracking-overflow
        bucket)."""
        with self._lock:
            states = dict(self._states)
        return {
            "admitted": {str(t): s.admitted for t, s in states.items()
                         if s.admitted},
            "shed": {str(t): s.shed for t, s in states.items() if s.shed},
            "degraded": {str(t): s.degraded for t, s in states.items()
                         if s.degraded},
        }

    def brief(self) -> dict:
        """The /healthz robustness block entry: small and stable."""
        with self._lock:
            return {
                "policy": self.config.policy,
                "tracked": len(self._states),
                "quarantined": sorted(self._quarantined),
                "quarantines": self.quarantines,
                "releases": self.releases,
            }

    def snapshot(self, top: int = 64) -> dict:
        """The /tenants view: config, quarantine state, and the
        busiest per-tenant rows (admitted+shed descending, bounded)."""
        rows: List[dict] = []
        with self._lock:
            # rows build INSIDE the lock: the per-tenant dicts
            # (shed_reasons) are resized by concurrent on_shed calls
            # under this same lock — copying them unlocked raced a
            # mid-flood /tenants scrape into a RuntimeError
            quarantined = sorted(self._quarantined)
            n_tracked = len(self._states)
            for t, s in self._states.items():
                rows.append({
                    "tenant": t,
                    "admitted": s.admitted,
                    "shed": s.shed,
                    "shed_reasons": dict(s.shed_reasons),
                    "degraded": s.degraded,
                    "rate_rps": round(s.rate_ewma.get(0.0), 2),
                    "shed_rps": round(s.shed_ewma.get(0.0), 2),
                    "quarantined": t in quarantined,
                })
        rows.sort(key=lambda r: (-(r["admitted"] + r["shed"]),
                                 r["tenant"]))
        cfg = self.config
        return {
            "policy": cfg.policy,
            "window_s": cfg.window_s,
            "max_share": cfg.max_share,
            "min_window_arrivals": cfg.min_window_arrivals,
            "up_confirm_windows": cfg.up_confirm_windows,
            "dwell_s": cfg.dwell_s,
            "depth_trigger": self.depth_trigger,
            "max_tracked": cfg.max_tracked,
            "tracked": n_tracked,
            "quarantined": quarantined,
            "quarantines": self.quarantines,
            "releases": self.releases,
            "tenants": rows[:top],
        }
