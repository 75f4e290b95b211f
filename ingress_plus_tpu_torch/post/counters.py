"""Node counters — the `/wallarm-status`† counters endpoint analog
(SURVEY.md §3.5): the JSON the reference's collectd sidecar scrapes and
forwards to the cloud.  Served by the serve loop at ``/wallarm-status``.
"""

from __future__ import annotations

import time
from typing import Dict

from ingress_plus_tpu_torch.utils.trace import named_lock


def _bump(d: Dict, key, cap: int, overflow) -> None:
    """Increment ``d[key]`` under a fixed key budget (the overflow
    bucket counts toward it): new keys past the budget fold into
    ``overflow`` — a hostile tenant/class stream can therefore never
    grow the status JSON without limit.  Existing keys keep counting."""
    if key in d:
        d[key] += 1
    elif len(d) < cap - (0 if overflow in d else 1):
        d[key] = 1
    else:
        d[overflow] = d.get(overflow, 0) + 1


class NodeCounters:
    """Monotonic counters, thread-safe, cheap enough for the verdict path
    (single lock, integer adds).  Keyed dicts are cardinality-capped
    (``MAX_*_KEYS`` + an ``other``/-1 overflow bucket)."""

    MAX_CLASS_KEYS = 64        # attack classes are a small closed set
    # tenants are system-bounded at control/sync.py MAX_TENANTS (4096):
    # the budget must cover every legal tenant (+1 for the overflow
    # slot) or late-arriving tenants lose attribution permanently
    # (_bump never evicts); export_events keys the composite
    # "class:tenant" space, so it gets a multiple of that bound
    MAX_TENANT_KEYS = 4096 + 1
    MAX_EXPORT_KEYS = 4 * 4096

    def __init__(self):
        self._lock = named_lock("NodeCounters._lock")
        self.started = time.time()
        self.requests = 0
        self.attacks = 0
        self.blocked = 0
        self.monitored = 0         # attacks seen in monitoring mode
        self.fail_open = 0
        self.by_class: Dict[str, int] = {}
        self.by_tenant: Dict[int, int] = {}   # attacks per tenant
        #: admission-level abuse visibility: which tenants'
        #: verdicts came back shed/fail-open or degraded (tenant-guard
        #: quarantine, overload) — postanalytics' view of the serve
        #: plane's tenant-isolation decisions.  Same cardinality cap +
        #: -1 overflow bucket as by_tenant.
        self.shed_by_tenant: Dict[int, int] = {}
        self.degraded_by_tenant: Dict[int, int] = {}
        #: EXPORTED ATTACK RECORDS by class (unit: aggregated attacks,
        #: not requests — by_class above counts per-request verdicts).
        #: This is the only place brute/dirbust rate detections appear:
        #: they have no per-request verdict, so the serve-path record()
        #: never sees them.  Keyed "class" and "class:tenant".
        self.export_events: Dict[str, int] = {}

    def record(self, *, attack: bool, blocked: bool, fail_open: bool,
               classes, tenant: int, mode: int,
               degraded: bool = False) -> None:
        with self._lock:
            self.requests += 1
            if fail_open:
                self.fail_open += 1
                _bump(self.shed_by_tenant, tenant,
                      self.MAX_TENANT_KEYS, -1)
            if degraded and not fail_open:
                # fail-open already counted above; a degraded-but-served
                # verdict (prefilter-only rung) books here
                _bump(self.degraded_by_tenant, tenant,
                      self.MAX_TENANT_KEYS, -1)
            if attack:
                self.attacks += 1
                if blocked:
                    self.blocked += 1
                elif mode == 1:
                    self.monitored += 1
                for c in classes:
                    _bump(self.by_class, c, self.MAX_CLASS_KEYS, "other")
                _bump(self.by_tenant, tenant, self.MAX_TENANT_KEYS, -1)

    def record_export_events(self, records) -> None:
        """Fold exporter-delivered attack records (incl. brute/dirbust)
        into the per-application counters the reference's collectd
        scrape forwards."""
        with self._lock:
            for r in records:
                cls = r.get("class", "unclassified")
                _bump(self.export_events, cls,
                      self.MAX_EXPORT_KEYS, "other")
                key = "%s:%s" % (cls, r.get("tenant", 0))
                _bump(self.export_events, key,
                      self.MAX_EXPORT_KEYS, "other")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_s": round(time.time() - self.started, 1),
                "requests": self.requests,
                "attacks": self.attacks,
                "blocked": self.blocked,
                "monitored": self.monitored,
                "fail_open": self.fail_open,
                "by_class": dict(self.by_class),
                "by_tenant": {str(k): v for k, v in self.by_tenant.items()},
                "shed_by_tenant": {str(k): v for k, v
                                   in self.shed_by_tenant.items()},
                "degraded_by_tenant": {str(k): v for k, v
                                       in self.degraded_by_tenant.items()},
                "export_events": dict(self.export_events),
            }
