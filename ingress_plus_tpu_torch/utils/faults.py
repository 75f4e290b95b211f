"""Deterministic fault injection for the fail-safe serve plane.

The reference node's contract is that detection degrades before traffic
does (wallarm-fallback, SURVEY.md §5): overload and breakage produce
fail-open verdicts, never queues or 5xx.  That contract is only worth
anything if the failure paths can be *exercised* — a fallback nobody can
trigger in CI is a fallback that breaks silently.  This module is the
trigger: a seeded, fully deterministic ``FaultPlan`` with named
injection sites threaded through the planes that can actually break in
production:

========================  ====================================================
site                      injected where / what it does when it fires
========================  ====================================================
``dispatch_hang``         engine device dispatch sleeps ``delay_s`` (a wedged
                          device / stuck kernel launch) — exercises the
                          batcher's dispatch watchdog + circuit breaker
``dispatch_raise``        engine device dispatch raises ``FaultError`` (a
                          crashed device / poisoned executable) — exercises
                          fail-open verdicts + breaker failure counting
``recompile_storm``       pipeline prefilter drops the engine's scanners and
                          per-device table replicas and forgets its warm
                          shapes — the next dispatches pay first loads again,
                          visible in ``ipt_engine_recompiles_total``
``swap_fail``             ruleset hot-swap raises mid-swap — the outgoing
                          pipeline must keep serving untouched.  Also
                          armed at the guarded rollout's PROMOTE boundary
                          (control/rollout.py): a promotion that dies must
                          auto-roll back to the incumbent
``shadow_diverge``        the rollout shadow lane books a synthetic
                          new-block diff for the mirrored request — drives
                          the verdict-diff rollback trigger without
                          needing a genuinely divergent pack
``lkg_corrupt``           ``load_lkg`` raises while reading the
                          last-known-good pointer (torn/corrupt artifact)
                          — startup must fall back to the configured
                          rules source, never crash-loop
``export_5xx``            the post exporter's HTTP delivery raises (collector
                          returning 5xx) — exercises exponential backoff +
                          spool bounding
``scrape_timeout``        the fleet scraper's node fetch times out
                          (control/fleetobs.py) — the node must be marked
                          stale, excluded from gauge rollups, with counter
                          conservation holding over the reachable subset
``scrape_5xx``            the fleet scraper's node fetch fails hard (node
                          returning 5xx / connection refused) — same stale
                          contract as ``scrape_timeout``, distinct site so
                          plans can stage the two failure shapes separately
``slow_confirm``          pipeline confirm stage sleeps ``delay_s`` per batch
                          (pathological regex / CPU contention) — exercises
                          deadline shedding and the brownout ladder.  Fires
                          inside the confirm plane's share execution
                          (models/confirm_plane.py), so ``worker=K`` targets
                          ONE confirm worker of a multi-worker pool — a
                          wedged worker must fail only its request share
                          open (docs/CONFIRM_PLANE.md) — and ``tenant=T``
                          targets ONE tenant's requests (per-request
                          stamping), the tenant-flood scenarios' hammer
========================  ====================================================

A plan is a set of per-site rules ``site:after=N,times=M,delay_s=X,
prob=P`` joined by ``;`` — e.g. ``dispatch_hang:after=4,times=1,
delay_s=2`` fires exactly once, on the 5th arrival at the dispatch
site, and sleeps 2s.  ``prob`` draws from a seeded RNG, so even
probabilistic plans replay identically.  Configure via the serve CLI
(``--faults``), the environment (``IPT_FAULTS`` / ``IPT_FAULTS_SEED``),
or at runtime through the serve loop's ``/faults`` endpoint (``dbg
faults`` renders it).

The JAX package's ``run_fault_matrix`` harness (every scenario against
a real batcher) is not part of this package: it compiles its own packs
and drives the post plane.  See docs/ROBUSTNESS.md.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

#: the known injection sites (a spec naming anything else is rejected —
#: a typo'd site would otherwise silently never fire)
SITES = ("dispatch_hang", "dispatch_raise", "recompile_storm",
         "swap_fail", "export_5xx", "slow_confirm",
         "shadow_diverge", "lkg_corrupt",
         "scrape_timeout", "scrape_5xx",
         # fleet control plane (docs/SERVING.md):
         # node_kill — harnesses kill one serve node when it fires;
         # node_partition — a fleet scrape raises (node reachable for
         #   serving, unreachable for telemetry);
         # front_backend_refuse — the front's backend connect refuses
         #   (exercises retry-on-connect-failure to a sibling);
         # retune_gate_fail — the retune daemon's gate run is forced
         #   to fail (the incumbent must keep serving everywhere)
         "node_kill", "node_partition", "front_backend_refuse",
         "retune_gate_fail")


class FaultError(RuntimeError):
    """The injected failure raised at raise-type sites."""


@dataclass
class FaultRule:
    """Firing schedule for one site.

    ``after``: skip the first N arrivals; ``times``: fire at most N
    times (None = unlimited); ``delay_s``: sleep duration for
    hang/slow sites; ``prob``: per-arrival firing probability drawn
    from the plan's seeded RNG (1.0 = always); ``lane``: restrict the
    site to ONE serve lane (docs/MESH_SERVING.md) — arrivals from
    other lanes' dispatch threads neither count nor fire, so a plan
    like ``dispatch_hang:lane=1,times=1`` wedges exactly one card
    while its siblings keep serving (the lane-isolation fault
    matrix); ``worker``: the confirm-plane twin of ``lane``
    (docs/CONFIRM_PLANE.md) — restricts the site to ONE confirm
    worker's share execution, so ``slow_confirm:worker=1,times=1``
    wedges exactly one confirm worker while its pool siblings keep
    confirming; ``tenant``: the tenant-isolation twin
    (docs/ROBUSTNESS.md "Tenant isolation") — restricts the site to
    requests of ONE tenant at per-request sites (the confirm plane
    stamps the request's tenant around each confirm walk when a
    tenant-targeted rule is active), so ``slow_confirm:tenant=1``
    makes exactly one tenant's traffic pathologically expensive while
    other tenants' arrivals neither count nor fire."""

    site: str
    after: int = 0
    times: Optional[int] = None
    delay_s: float = 1.0
    prob: float = 1.0
    lane: Optional[int] = None
    worker: Optional[int] = None
    tenant: Optional[int] = None

    @classmethod
    def parse(cls, text: str) -> "FaultRule":
        site, _, argstr = text.strip().partition(":")
        site = site.strip()
        if site not in SITES:
            raise ValueError("unknown fault site %r (known: %s)"
                             % (site, ", ".join(SITES)))
        kw: Dict[str, float] = {}
        for part in filter(None, (p.strip() for p in argstr.split(","))):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in ("after", "times", "delay_s", "prob", "lane",
                         "worker", "tenant"):
                raise ValueError("unknown fault arg %r in %r" % (k, text))
            kw[k] = float(v)
        return cls(site=site,
                   after=int(kw.get("after", 0)),
                   times=int(kw["times"]) if "times" in kw else None,
                   delay_s=float(kw.get("delay_s", 1.0)),
                   prob=float(kw.get("prob", 1.0)),
                   lane=int(kw["lane"]) if "lane" in kw else None,
                   worker=int(kw["worker"]) if "worker" in kw else None,
                   tenant=int(kw["tenant"]) if "tenant" in kw else None)


class FaultPlan:
    """A seeded, replayable set of fault rules.

    Thread-safe: arrival/fired counters and the RNG advance under one
    lock, so a plan replays identically regardless of which serve
    thread reaches a site (determinism holds per-site — ``after`` and
    ``times`` count arrivals at that site in program order)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules: Dict[str, FaultRule] = {r.site: r for r in rules}
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.arrivals: Dict[str, int] = {s: 0 for s in self.rules}
        self.fired: Dict[str, int] = {s: 0 for s in self.rules}

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = [FaultRule.parse(p)
                 for p in filter(None, (s.strip() for s in spec.split(";")))]
        if not rules:
            raise ValueError("empty fault spec")
        return cls(rules, seed=seed)

    def fire(self, site: str) -> Optional[FaultRule]:
        """One arrival at ``site``; returns the rule when it fires."""
        rule = self.rules.get(site)
        if rule is None:
            return None
        if rule.lane is not None and rule.lane != current_lane():
            # lane-targeted rule: another lane's arrival is invisible —
            # it neither counts toward ``after`` nor consumes ``times``
            # (per-lane arrival order is deterministic, so replays hold)
            return None
        if rule.worker is not None \
                and rule.worker != current_confirm_worker():
            # confirm-worker-targeted rule: same invisibility contract
            # as lane targeting, keyed on the confirm plane's
            # thread-local worker id (models/confirm_plane.py)
            return None
        if rule.tenant is not None and rule.tenant != current_tenant():
            # tenant-targeted rule: arrivals while another tenant's (or
            # no) request is being processed are invisible — per-tenant
            # arrival order is deterministic, so replays hold
            return None
        with self._lock:
            n = self.arrivals[site]
            self.arrivals[site] = n + 1
            if n < rule.after:
                return None
            if rule.times is not None and self.fired[site] >= rule.times:
                return None
            if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                return None
            self.fired[site] += 1
            return rule

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [
                    {"site": r.site, "after": r.after, "times": r.times,
                     "delay_s": r.delay_s, "prob": r.prob,
                     "lane": r.lane, "worker": r.worker,
                     "tenant": r.tenant,
                     "arrivals": self.arrivals[r.site],
                     "fired": self.fired[r.site]}
                    for r in self.rules.values()
                ],
            }


# ------------------------------------------------------- active plan
# One process-global plan (serve loop + its worker threads share it).
# The no-plan fast path is a single global read — the injection sites
# sit on hot paths and must cost nothing in production.

_active: Optional[FaultPlan] = None

# thread-local lane attribution: each lane WORKER thread
# (serve/lanes.py LaneWorker) stamps its lane index once at startup, so
# ``lane=``-targeted rules can tell which card's dispatch reached a
# site.  The serve loop / dispatch / test threads read as None.
_lane_local = threading.local()


def set_current_lane(index: Optional[int]) -> None:
    _lane_local.lane = index


def current_lane() -> Optional[int]:
    return getattr(_lane_local, "lane", None)


# thread-local confirm-worker attribution (models/confirm_plane.py):
# each confirm POOL worker thread stamps its index at startup, and the
# inline (single-worker) pool stamps 0 around its share execution — so
# ``worker=``-targeted rules see the same ids either way.
def set_current_confirm_worker(index: Optional[int]) -> None:
    _lane_local.confirm_worker = index


def current_confirm_worker() -> Optional[int]:
    return getattr(_lane_local, "confirm_worker", None)


# thread-local tenant attribution (docs/ROBUSTNESS.md "Tenant
# isolation"): per-request processing stamps the request's tenant
# around the work, so ``tenant=``-targeted rules fire only while that
# tenant's request is in hand.  Stamping is OPT-IN per site via
# ``tenant_targeted`` — an untargeted plan never reaches the
# per-request arrival points, so its site arrival counts (and
# therefore every existing plan's replay) are unchanged.
def set_current_tenant(tenant: Optional[int]) -> None:
    _lane_local.tenant = tenant


def current_tenant() -> Optional[int]:
    return getattr(_lane_local, "tenant", None)


def tenant_targeted(site: str) -> bool:
    """True when the active plan has a tenant-targeted rule at
    ``site`` — per-request stamping code keys on this so untargeted
    plans keep their exact arrival accounting."""
    p = _active
    if p is None:
        return False
    r = p.rules.get(site)
    return r is not None and r.tenant is not None


def install(plan: Optional[FaultPlan]) -> None:
    global _active
    _active = plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _active


def install_from_env(environ=os.environ) -> Optional[FaultPlan]:
    """``IPT_FAULTS``/``IPT_FAULTS_SEED`` → installed plan (or None)."""
    spec = environ.get("IPT_FAULTS")
    if not spec:
        return None
    plan = FaultPlan.from_spec(spec,
                               seed=int(environ.get("IPT_FAULTS_SEED", "0")))
    install(plan)
    return plan


def fire(site: str) -> bool:
    """True when the fault at ``site`` fires this arrival (the caller
    applies the site's semantics itself)."""
    p = _active
    if p is None:
        return False
    return p.fire(site) is not None


def sleep_if(site: str) -> bool:
    """Hang-type site: sleep the rule's ``delay_s`` when it fires."""
    p = _active
    if p is None:
        return False
    r = p.fire(site)
    if r is None:
        return False
    time.sleep(r.delay_s)
    return True


def raise_if(site: str) -> None:
    """Raise-type site: raise ``FaultError`` when it fires."""
    p = _active
    if p is None:
        return
    if p.fire(site) is not None:
        raise FaultError("injected fault: %s" % site)
