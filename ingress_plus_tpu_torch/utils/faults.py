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

``run_fault_matrix()`` is the harness: it drives a real batcher (on the
card, or on the CPU when asked) under every ported scenario plus a
synthetic overload burst and asserts the serve-plane invariant — every
admitted request resolves to exactly one verdict, and no fault becomes
an unhandled exception or a block.  On a card, a breaker-open batch
fails open instead of moving to the host.  The fleet scenarios wait
for their modules (``NOT_PORTED``).  See
docs/ROBUSTNESS.md.
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


# ===================================================== fault matrix
# The harness.  Imports are deliberately inside the functions: this
# module sits in utils/ below the serve plane, and the matrix drives
# the real Batcher/DetectionPipeline.

_MATRIX_RULES = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
"""

ATTACK_URI = "/q?a=1+union+select+2"


def _matrix_ruleset():
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang

    return compile_ruleset(parse_seclang(_MATRIX_RULES))


def _mk_batcher(cr=None, confirm_workers: int = 1,
                confirm_hang_budget_s: float = 30.0, device=None, **kw):
    """A batcher on ``device`` (None = the CUDA card, "cpu" for the
    plain scan), its serve shapes warmed before any plan is active."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    pipeline = DetectionPipeline(cr if cr is not None else _matrix_ruleset(),
                                 mode="block",
                                 confirm_workers=confirm_workers,
                                 confirm_hang_budget_s=confirm_hang_budget_s,
                                 device=device)
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_delay_s", 0.001)
    b = Batcher(pipeline, **kw)
    # warm the serve shapes BEFORE any plan is active: a first load
    # inside a scenario would read as a hang
    from ingress_plus_tpu_torch.serve.normalize import Request

    warm = [Request(uri="/warm?i=%d" % i, request_id="warm%d" % i)
            for i in range(kw["max_batch"])]
    for size in (1, 4, kw["max_batch"]):
        pipeline.detect(warm[:size])
    return b


def _requests(n: int, attack_every: int = 0, tag: str = "r",
              tenant: int = 0):
    from ingress_plus_tpu_torch.serve.normalize import Request

    out = []
    for i in range(n):
        uri = (ATTACK_URI if attack_every and i % attack_every == 0
               else "/benign?i=%d" % i)
        out.append(Request(uri=uri, request_id="%s%d" % (tag, i),
                           tenant=tenant))
    return out


def _collect(futs, timeout_s: float) -> tuple:
    """Resolve every future → (verdicts, violations).  A future that
    never resolves or raises IS the invariant violation."""
    verdicts, violations = [], []
    deadline = time.monotonic() + timeout_s
    for i, f in enumerate(futs):
        try:
            v = f.result(timeout=max(deadline - time.monotonic(), 0.1))
        except Exception as e:  # noqa: BLE001 — the harness must report, not die
            violations.append("request %d: no verdict (%s: %s)"
                              % (i, type(e).__name__, e))
            continue
        verdicts.append(v)
    return verdicts, violations


def _check_breaker_open_card(b, verdicts, violations) -> None:
    """The card's breaker-open invariant (a card pipeline never reaches
    ``detect_cpu_only``, serve/batcher.py ``_cpu_fallback_ok``): the
    wave's breaker-open verdicts failed open (none blocked), at least one
    batch took that route, and nothing moved to the host."""
    if not any(v.fail_open for v in verdicts):
        violations.append("breaker-open wave did not fail open on the "
                          "card")
    if any(v.blocked for v in verdicts if v.fail_open):
        violations.append("a breaker-open verdict blocked")
    if b.stats.breaker_fail_open_batches < 1:
        violations.append("no batch took the breaker-open route")
    if b.stats.cpu_fallback_batches:
        violations.append("%d batches moved to the host on a card"
                          % b.stats.cpu_fallback_batches)


def _check_verdicts(verdicts, violations, n_admitted: int,
                    allow_blocked_attacks: bool = True) -> None:
    if len(verdicts) != n_admitted - len(violations):
        violations.append("verdict count mismatch: %d of %d"
                          % (len(verdicts), n_admitted))
    for v in verdicts:
        if v.blocked and not v.attack:
            violations.append("request %s blocked without an attack "
                              "verdict (fault became a block)"
                              % v.request_id)
        if v.blocked and not allow_blocked_attacks:
            violations.append("request %s blocked under degradation"
                              % v.request_id)


def _scenario_overload(install_plan, device=None) -> dict:
    """Synthetic 10× burst against a slowed confirm stage: bounded
    admission must shed fail-open at enqueue, and every admitted
    request still resolves."""
    install_plan(FaultPlan.from_spec("slow_confirm:times=100,delay_s=0.05"))
    b = _mk_batcher(queue_cap=32, hard_deadline_s=0.15, hang_budget_s=30.0,
                    device=device)
    try:
        reqs = _requests(320, tag="ov")
        futs = [b.submit(r) for r in reqs]
        verdicts, violations = _collect(futs, timeout_s=60)
        _check_verdicts(verdicts, violations, len(reqs))
        shed = dict(b.pipeline.stats.shed)
        if not shed:
            violations.append("10x burst shed nothing — admission "
                              "is not bounded")
        return {"ok": not violations, "violations": violations,
                "verdicts": len(verdicts), "shed": shed,
                "degraded": b.pipeline.stats.degraded,
                "ladder_steps_up": b.pipeline.load_controller.steps_up}
    finally:
        b.close()


def _scenario_dispatch_hang(install_plan, device=None) -> dict:
    """A wedged device dispatch: the watchdog fails the stuck batch
    open within the hang budget, the breaker trips (to the CPU fallback
    on a CPU pipeline; on a card its batches fail open), and a half-open
    canary closes it once the device recovers."""
    b = _mk_batcher(hang_budget_s=0.3, breaker_cooldown_s=0.4,
                    device=device)
    install_plan(FaultPlan.from_spec("dispatch_hang:times=1,delay_s=1.2"))
    try:
        futs = [b.submit(r) for r in _requests(8, tag="h0")]
        verdicts, violations = _collect(futs, timeout_s=30)
        _check_verdicts(verdicts, violations, 8)
        if not any(v.fail_open for v in verdicts):
            violations.append("hung batch did not fail open")
        if b.breaker.trips < 1:
            violations.append("breaker never tripped on the hang")
        # while open: the CPU fallback must still produce REAL verdicts;
        # a card fails the breaker-open batches open instead
        futs = [b.submit(r) for r in _requests(8, attack_every=4, tag="h1")]
        verdicts, v2 = _collect(futs, timeout_s=30)
        violations += v2
        _check_verdicts(verdicts, v2, 8)
        if not b._cpu_fallback_ok(b.pipeline):
            _check_breaker_open_card(b, verdicts, violations)
        elif not any(v.attack for v in verdicts):
            violations.append("CPU fallback lost detection while "
                              "breaker open")
        # recovery: hang exhausted, cooldown passes, canary closes
        deadline = time.monotonic() + 15
        while b.breaker.state != "closed" and time.monotonic() < deadline:
            fs = [b.submit(r) for r in _requests(4, tag="h2")]
            _collect(fs, timeout_s=10)
            time.sleep(0.1)
        if b.breaker.state != "closed":
            violations.append("breaker never recovered through "
                              "half-open (state=%s)" % b.breaker.state)
        return {"ok": not violations, "violations": violations,
                "breaker": b.breaker.snapshot(),
                "hangs": b.stats.hangs,
                "breaker_fail_open_batches":
                    b.stats.breaker_fail_open_batches,
                "cpu_fallback_batches": b.stats.cpu_fallback_batches}
    finally:
        b.close()


def _scenario_dispatch_raise(install_plan, device=None) -> dict:
    """Raising device dispatches: fail-open verdicts, breaker opens on
    consecutive failures, CPU fallback serves (on a card: the
    breaker-open batches fail open), then recovery."""
    b = _mk_batcher(hang_budget_s=30.0, breaker_failures=2,
                    breaker_cooldown_s=0.3, device=device)
    install_plan(FaultPlan.from_spec("dispatch_raise:times=3"))
    try:
        all_violations: List[str] = []
        waves = []
        for wave in range(3):
            futs = [b.submit(r) for r in _requests(4, tag="r%d" % wave)]
            verdicts, violations = _collect(futs, timeout_s=30)
            _check_verdicts(verdicts, violations, 4)
            all_violations += violations
            waves += verdicts
            time.sleep(0.05)
        if not b._cpu_fallback_ok(b.pipeline):
            _check_breaker_open_card(b, waves, all_violations)
        if b.breaker.trips < 1:
            all_violations.append("breaker never opened on consecutive "
                                  "dispatch failures")
        deadline = time.monotonic() + 15
        while b.breaker.state != "closed" and time.monotonic() < deadline:
            _collect([b.submit(r) for r in _requests(4, tag="rr")], 10)
            time.sleep(0.1)
        if b.breaker.state != "closed":
            all_violations.append("breaker stuck %s" % b.breaker.state)
        # closed again: detection works end to end
        vs, viol = _collect([b.submit(r) for r in
                             _requests(4, attack_every=2, tag="rf")], 30)
        all_violations += viol
        if not any(v.attack and not v.fail_open for v in vs):
            all_violations.append("no clean attack verdict after recovery")
        return {"ok": not all_violations, "violations": all_violations,
                "breaker": b.breaker.snapshot(),
                "breaker_fail_open_batches":
                    b.stats.breaker_fail_open_batches,
                "cpu_fallback_batches": b.stats.cpu_fallback_batches}
    finally:
        b.close()


def _scenario_recompile_storm(install_plan, device=None) -> dict:
    """Loss of everything loaded mid-serve (scanners, table replicas,
    warm shapes): dispatches pay fresh first loads but every verdict
    still lands."""
    b = _mk_batcher(hang_budget_s=60.0, device=device)
    install_plan(FaultPlan.from_spec("recompile_storm:times=2"))
    try:
        futs = [b.submit(r) for r in _requests(48, attack_every=8, tag="c")]
        verdicts, violations = _collect(futs, timeout_s=120)
        _check_verdicts(verdicts, violations, 48)
        if not any(v.attack for v in verdicts):
            violations.append("detection lost across the recompile storm")
        return {"ok": not violations, "violations": violations,
                "recompiles": b.pipeline.stats.engine_compiles}
    finally:
        b.close()


def _scenario_swap_fail(install_plan, device=None) -> dict:
    """A hot-swap that dies mid-swap must leave the outgoing ruleset
    serving; the next (clean) swap must succeed."""
    b = _mk_batcher(device=device)
    install_plan(FaultPlan.from_spec("swap_fail:times=1"))
    try:
        violations: List[str] = []
        v0 = b.pipeline.ruleset.version
        from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
        from ingress_plus_tpu_torch.compiler.seclang import parse_seclang

        cr2 = compile_ruleset(parse_seclang(
            'SecRule ARGS "@rx (?i)drop\\s+table" '
            '"id:955000,phase:2,block,severity:CRITICAL,'
            "tag:'attack-sqli'\""))
        try:
            b.swap_ruleset(cr2)
            violations.append("swap_fail fault never raised")
        except FaultError:
            pass
        if b.pipeline.ruleset.version != v0:
            violations.append("failed swap mutated the serving pipeline")
        vs, viol = _collect([b.submit(r) for r in
                             _requests(8, attack_every=4, tag="s0")], 30)
        _check_verdicts(vs, viol, 8)   # appends into viol: fold after
        violations += viol
        if not any(v.attack for v in vs):
            violations.append("old ruleset stopped detecting after the "
                              "failed swap")
        b.swap_ruleset(cr2)   # fault exhausted: clean swap
        if b.pipeline.ruleset.version == v0:
            violations.append("clean swap after the failed one did not "
                              "install")
        return {"ok": not violations, "violations": violations}
    finally:
        b.close()


def _scenario_export_5xx(install_plan, device=None) -> dict:
    """Collector 5xx streak: export errors count, the retry interval
    backs off exponentially (with jitter, capped), and recovery resets
    it.  Off the verdict path by construction: the exporter touches no
    device, so ``device`` is unused."""
    import http.server
    import json as _json

    from ingress_plus_tpu_torch.post.export import Exporter
    from ingress_plus_tpu_torch.post.queue import Hit, HitQueue

    class _OK(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), _OK)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    install_plan(FaultPlan.from_spec("export_5xx:times=3"))
    q = HitQueue(maxlen=1024)
    exp = Exporter(q, http_url="http://127.0.0.1:%d/collect"
                   % httpd.server_address[1], interval_s=0.2)
    violations: List[str] = []
    try:
        waits = []
        for _ in range(3):
            q.put(Hit(ts=time.time(), request_id="e", tenant=0, client="c",
                      method="GET", uri=ATTACK_URI, classes=("sqli",),
                      rule_ids=(942100,), score=5, blocked=True,
                      attack=True, fail_open=False, mode=2))
            exp.flush_once()
            waits.append(exp.next_wait_s())
        if exp.export_errors < 3 or exp.consecutive_failures != 3:
            violations.append("export failures not counted: errors=%d "
                              "consecutive=%d" % (exp.export_errors,
                                                  exp.consecutive_failures))
        if not (waits[0] > exp.interval_s and waits[2] > waits[0]):
            violations.append("backoff did not grow: %s"
                              % _json.dumps(waits))
        if any(w > exp.backoff_max_s for w in waits):
            violations.append("backoff exceeded its ceiling")
        q.put(Hit(ts=time.time(), request_id="e2", tenant=0, client="c",
                  method="GET", uri=ATTACK_URI, classes=("sqli",),
                  rule_ids=(942100,), score=5, blocked=True,
                  attack=True, fail_open=False, mode=2))
        n = exp.flush_once()   # fault exhausted: delivery succeeds
        if n < 1 or exp.consecutive_failures != 0 \
                or exp.next_wait_s() != exp.interval_s:
            violations.append("recovery did not reset the backoff")
        return {"ok": not violations, "violations": violations,
                "waits_s": [round(w, 3) for w in waits]}
    finally:
        exp.close()
        httpd.shutdown()
        httpd.server_close()


def _scenario_slow_confirm(install_plan, device=None) -> dict:
    """Pathological confirm latency: verdicts all land (late, not
    lost) and the brownout ladder has pressure signal to act on."""
    install_plan(FaultPlan.from_spec("slow_confirm:times=6,delay_s=0.05"))
    b = _mk_batcher(hang_budget_s=30.0, device=device)
    try:
        futs = [b.submit(r) for r in _requests(32, attack_every=8, tag="sc")]
        verdicts, violations = _collect(futs, timeout_s=60)
        _check_verdicts(verdicts, violations, 32)
        return {"ok": not violations, "violations": violations,
                "verdicts": len(verdicts)}
    finally:
        b.close()


def _scenario_confirm_worker_hang(install_plan, device=None) -> dict:
    """slow_confirm targeted at confirm worker 1 of a 2-worker pool
    (docs/CONFIRM_PLANE.md): the wedged worker's request share fails
    open within the confirm hang budget, its pool sibling's verdicts
    are untouched (real detection continues in the same cycle), the
    device breaker never trips (a CPU confirm wedge is not a card
    fault), and the pool recovers by replacing the worker — the next
    wave serves clean verdicts end to end."""
    b = _mk_batcher(confirm_workers=2, confirm_hang_budget_s=0.5,
                    device=device)
    install_plan(FaultPlan.from_spec(
        "slow_confirm:worker=1,times=1,delay_s=8.0"))
    try:
        violations: List[str] = []
        # attack_every=3: attack positions land on BOTH round-robin
        # share parities whatever the cycle offset — every-4 could put
        # every attack in the wedged worker's share
        futs = [b.submit(r) for r in _requests(16, attack_every=3,
                                               tag="cw")]
        verdicts, viol = _collect(futs, timeout_s=60)
        _check_verdicts(verdicts, viol, 16)
        violations += viol
        if not any(v.fail_open for v in verdicts):
            violations.append("wedged confirm worker's share did not "
                              "fail open")
        if not any(v.attack and not v.fail_open for v in verdicts):
            violations.append("sibling confirm worker served no real "
                              "verdicts during the wedge")
        if all(v.fail_open for v in verdicts):
            violations.append("the whole cycle failed open — the wedge "
                              "was not isolated to one worker's share")
        if b.breaker.trips:
            violations.append("device breaker tripped on a CPU confirm "
                              "wedge")
        if b.pipeline.stats.confirm_hangs < 1:
            violations.append("confirm_hangs counter never moved")
        pool = b.pipeline.confirm_pool
        if pool.workers_replaced < 1:
            violations.append("wedged confirm worker was never replaced")
        # recovery: fault exhausted, the replaced worker serves clean
        futs = [b.submit(r) for r in _requests(16, attack_every=3,
                                               tag="cwr")]
        verdicts, viol = _collect(futs, timeout_s=60)
        _check_verdicts(verdicts, viol, 16)
        violations += viol
        if any(v.fail_open for v in verdicts):
            violations.append("pool did not recover: post-fault wave "
                              "still failing open")
        if not any(v.attack for v in verdicts):
            violations.append("detection lost after confirm-worker "
                              "recovery")
        return {"ok": not violations, "violations": violations,
                "confirm_hangs": b.pipeline.stats.confirm_hangs,
                "workers_replaced": pool.workers_replaced}
    finally:
        b.close()


# ------------------------------------------- guarded-rollout scenarios
# (control/rollout.py, docs/ROBUSTNESS.md "Guarded rollout").  The
# shared invariant: a fault in ANY rollout phase leaves the INCUMBENT
# generation serving and every admitted request still resolves to
# exactly one verdict.


def _rollout_fixtures(device=None, **kw):
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.control.rollout import (
        _DRILL_CANDIDATE,
        _DRILL_INCUMBENT,
        _drill_config,
        RolloutController,
    )

    cr_inc = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
    cr_cand = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
    b = _mk_batcher(cr=cr_inc, device=device, **kw)
    ro = RolloutController(b, _drill_config())
    b.rollout = ro
    return b, ro, cr_inc, cr_cand


def _drive_rollout(b, ro, terminal, violations, waves: int = 40):
    """Push traffic until the rollout reaches a terminal state; every
    future must resolve (the exactly-one-verdict leg rides here)."""
    deadline = time.monotonic() + 60
    wave = 0
    while ro.state not in terminal and time.monotonic() < deadline:
        futs = [b.submit(r) for r in _requests(24, attack_every=4,
                                               tag="ro%d" % wave)]
        _verdicts, viol = _collect(futs, timeout_s=30)
        violations.extend(viol)
        wave += 1
        if wave > waves:
            break


def _check_incumbent_serving(b, cr_inc, violations, tag: str) -> None:
    if b.pipeline.ruleset.version != cr_inc.version:
        violations.append("incumbent generation not serving (%s)"
                          % b.pipeline.ruleset.version)
    vs, viol = _collect([b.submit(r) for r in
                         _requests(8, attack_every=4, tag=tag)], 30)
    # _check_verdicts appends into viol: it must run BEFORE viol is
    # folded into the scenario's violations, or its findings are lost
    _check_verdicts(vs, viol, 8)
    violations.extend(viol)
    if not any(v.attack and not v.fail_open for v in vs):
        violations.append("incumbent lost detection after the fault")


def _scenario_rollout_promote_fail(install_plan, device=None) -> dict:
    """swap_fail armed at the PROMOTE phase boundary: the candidate
    clears shadow + canary, then the final install raises — the rollout
    must auto-roll back, the incumbent keeps serving, nothing strands."""
    b, ro, cr_inc, cr_cand = _rollout_fixtures(device)
    violations: List[str] = []
    try:
        ro.admit(ruleset=cr_cand)
        install_plan(FaultPlan.from_spec("swap_fail:times=1"))
        from ingress_plus_tpu_torch.control.rollout import LIVE, ROLLED_BACK
        _drive_rollout(b, ro, (LIVE, ROLLED_BACK), violations)
        if ro.state != ROLLED_BACK:
            violations.append("promote-boundary fault did not roll back "
                              "(state=%s)" % ro.state)
        if not ro.rollback_reason.startswith("promote_failed"):
            violations.append("rollback reason %r does not attribute the "
                              "promote fault" % ro.rollback_reason)
        _check_incumbent_serving(b, cr_inc, violations, "rpf")
        return {"ok": not violations, "violations": violations,
                "state": ro.state, "reason": ro.rollback_reason}
    finally:
        b.close()


def _scenario_rollout_shadow_diverge(install_plan, device=None) -> dict:
    """Injected shadow divergence: the candidate 'blocks' mirrored
    requests the incumbent passed — the verdict-diff trigger must kill
    the rollout while the incumbent never stops serving."""
    b, ro, cr_inc, cr_cand = _rollout_fixtures(device)
    violations: List[str] = []
    try:
        ro.admit(ruleset=cr_cand)
        install_plan(FaultPlan.from_spec("shadow_diverge:times=100"))
        from ingress_plus_tpu_torch.control.rollout import (
            LIVE,
            ROLLED_BACK,
        )
        _drive_rollout(b, ro, (LIVE, ROLLED_BACK), violations)
        if ro.state != ROLLED_BACK:
            violations.append("shadow divergence did not roll back "
                              "(state=%s)" % ro.state)
        if ro.rollback_reason != "verdict_diff":
            violations.append("expected verdict_diff trigger, got %r"
                              % ro.rollback_reason)
        if ro.diff.get("new_block", 0) < 1:
            violations.append("diff counters never accumulated")
        _check_incumbent_serving(b, cr_inc, violations, "rsd")
        return {"ok": not violations, "violations": violations,
                "diff": dict(ro.diff)}
    finally:
        b.close()


def _scenario_lkg_corrupt(install_plan, device=None) -> dict:
    """Corrupt last-known-good store at startup: load_lkg must return
    None (fall back to the configured rules source), never raise — and
    once the fault clears, the persisted pack loads intact."""
    import tempfile

    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.control.rollout import (
        _DRILL_INCUMBENT,
        load_lkg,
        persist_lkg,
    )

    violations: List[str] = []
    with tempfile.TemporaryDirectory(prefix="ipt-lkg-") as d:
        cr = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
        persist_lkg(cr, d)
        install_plan(FaultPlan.from_spec("lkg_corrupt:times=1"))
        try:
            got = load_lkg(d)
        except Exception as e:  # noqa: BLE001 — the violation we test for
            violations.append("corrupt LKG raised %s instead of falling "
                              "back" % type(e).__name__)
            got = None
        if got is not None:
            violations.append("lkg_corrupt fault never fired")
        # fallback serving: the configured pack still serves verdicts
        b = _mk_batcher(cr=cr, device=device)
        try:
            vs, viol = _collect([b.submit(r) for r in
                                 _requests(8, attack_every=4, tag="lk")], 30)
            _check_verdicts(vs, viol, 8)   # before folding: it appends
            violations.extend(viol)
            if not any(v.attack for v in vs):
                violations.append("fallback pack lost detection")
        finally:
            b.close()
        # fault exhausted: the LKG store is intact and loads
        again = load_lkg(d)
        if again is None or again.version != cr.version:
            violations.append("LKG store did not survive the corrupt "
                              "read (loaded %s)"
                              % (again.version if again else None))
    return {"ok": not violations, "violations": violations}


# ------------------------------------------------ lane-isolation
# (serve/lanes.py, docs/MESH_SERVING.md).  The mesh invariant: a fault
# targeted at ONE lane degrades that lane's capacity only — sibling
# lanes keep serving real verdicts, no global breaker-open route
# engages (neither the CPU fallback nor, on a card, failing open),
# every admitted request still gets exactly one verdict, and the sick
# lane recovers through its own half-open canary.


def _mk_lane_batcher(n_lanes: int = 2, device=None, **kw):
    """A multi-lane batcher warmed with REAL traffic of the shapes the
    scenarios drive (pre-plan): a first load inside a scenario would
    read as a lane hang on a busy host.  On one card every lane shares
    it, each on its own CUDA stream."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    pipeline = DetectionPipeline(_matrix_ruleset(), mode="block",
                                 device=device)
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_delay_s", 0.001)
    b = Batcher(pipeline, n_lanes=n_lanes, **kw)
    for wave in range(3):
        futs = [b.submit(r) for r in
                _requests(16, attack_every=4, tag="lw%d" % wave)]
        _collect(futs, timeout_s=120)
    for size in (1, 4):
        futs = [b.submit(r) for r in _requests(size, tag="ls%d" % size)]
        _collect(futs, timeout_s=120)
    return b


def _lane_states(b) -> dict:
    return {ln.index: ln.breaker.state for ln in b.lanes.lanes}


def _check_lane_isolation(b, sick: int, violations) -> None:
    """Shared asserts: only the sick lane tripped, siblings closed, no
    global CPU fallback, and fresh traffic still detects attacks."""
    for ln in b.lanes.lanes:
        if ln.index == sick:
            if ln.breaker.trips < 1:
                violations.append("lane %d breaker never tripped on its "
                                  "targeted fault" % sick)
        elif ln.breaker.trips > 0:
            violations.append("HEALTHY lane %d breaker tripped (%s) — "
                              "the fault leaked across lanes"
                              % (ln.index, ln.breaker.last_trip_reason))
    if b.stats.cpu_fallback_batches or b.stats.breaker_fail_open_batches:
        violations.append("global breaker-open route engaged with "
                          "healthy lanes available")
    vs, viol = _collect([b.submit(r) for r in
                         _requests(12, attack_every=3, tag="li")], 60)
    _check_verdicts(vs, viol, 12)
    violations.extend(viol)
    if not any(v.attack and not v.fail_open for v in vs):
        violations.append("healthy lanes lost detection after the "
                          "single-lane fault")


def _drive_lane_recovery(b, sick: int, violations,
                         deadline_s: float = 20.0) -> None:
    deadline = time.monotonic() + deadline_s
    while b.lanes.lane(sick).breaker.state != "closed" \
            and time.monotonic() < deadline:
        _collect([b.submit(r) for r in _requests(8, tag="lr")], 30)
        time.sleep(0.1)
    if b.lanes.lane(sick).breaker.state != "closed":
        violations.append("sick lane %d never recovered half-open "
                          "(state=%s)" % (sick,
                                          b.lanes.lane(sick).breaker.state))


def _scenario_lane_dispatch_hang(install_plan, device=None) -> dict:
    """dispatch_hang targeted at lane 1 of a 2-lane mesh: lane 1's
    share fails open once and ITS breaker trips; lane 0 serves every
    cycle uninterrupted; lane 1 recovers through its half-open
    canary."""
    # generous hang budget: a loaded 1-core host can starve an HONEST
    # lane dispatch for a second-plus, and a contention-tripped healthy
    # lane would fail the isolation assert
    b = _mk_lane_batcher(hang_budget_s=3.0, breaker_cooldown_s=0.5,
                         device=device)
    install_plan(FaultPlan.from_spec(
        "dispatch_hang:lane=1,times=1,delay_s=8.0"))
    try:
        violations: List[str] = []
        futs = [b.submit(r) for r in _requests(24, attack_every=4,
                                               tag="lh")]
        verdicts, viol = _collect(futs, timeout_s=60)
        _check_verdicts(verdicts, viol, 24)
        violations += viol
        if not any(v.fail_open for v in verdicts):
            violations.append("hung lane's share did not fail open")
        if not any(v.attack and not v.fail_open for v in verdicts):
            violations.append("sibling lane served no real verdicts "
                              "during the hang")
        _check_lane_isolation(b, sick=1, violations=violations)
        _drive_lane_recovery(b, sick=1, violations=violations)
        return {"ok": not violations, "violations": violations,
                "lanes": _lane_states(b), "hangs": b.stats.hangs}
    finally:
        b.close()


def _scenario_lane_dispatch_raise(install_plan, device=None) -> dict:
    """dispatch_raise targeted at lane 1: consecutive errors open only
    lane 1's breaker (failure_threshold=2), siblings keep serving, no
    global fallback, half-open recovery once the fault exhausts."""
    b = _mk_lane_batcher(breaker_failures=2, breaker_cooldown_s=0.3,
                         device=device)
    install_plan(FaultPlan.from_spec("dispatch_raise:lane=1,times=2"))
    try:
        violations: List[str] = []
        for wave in range(3):
            futs = [b.submit(r) for r in
                    _requests(8, attack_every=4, tag="le%d" % wave)]
            verdicts, viol = _collect(futs, timeout_s=60)
            _check_verdicts(verdicts, viol, 8)
            violations += viol
            time.sleep(0.05)
        _check_lane_isolation(b, sick=1, violations=violations)
        _drive_lane_recovery(b, sick=1, violations=violations)
        return {"ok": not violations, "violations": violations,
                "lanes": _lane_states(b),
                "errors": [ln.stats.errors for ln in b.lanes.lanes]}
    finally:
        b.close()


# ------------------------------------------------ tenant isolation
# (serve/batcher.py fair admission + models/tenant_guard.py,
# docs/ROBUSTNESS.md "Tenant isolation").  The multi-tenant invariant:
# one tenant's flood degrades only THAT tenant — victims keep real,
# un-degraded verdicts in the same cycles, the GLOBAL brownout ladder
# never climbs, and the hostile tenant recovers once the flood stops.


def _scenario_tenant_flood(install_plan, device=None) -> dict:
    """Hostile tenant 1 floods (8x volume, tenant-targeted slow
    confirm makes its confirmed traffic genuinely expensive): fair
    admission + the tenant guard must confine the blast radius.
    Victim tenant 0's verdicts stay real and un-degraded in the SAME
    waves the hostile tenant sheds/degrades; the hostile tenant is
    quarantined (and only it); the global ladder records zero steps
    up; after the flood the hostile tenant returns to full
    detection."""
    from ingress_plus_tpu_torch.models.tenant_guard import TenantGuardConfig

    install_plan(FaultPlan.from_spec(
        "slow_confirm:tenant=1,times=48,delay_s=0.01"))
    b = _mk_batcher(
        queue_cap=256, hard_deadline_s=0.4, hang_budget_s=30.0,
        device=device,
        tenant_queue_cap=16,
        tenant_guard=TenantGuardConfig(
            window_s=0.15, up_confirm_windows=1, dwell_s=0.6,
            min_window_arrivals=16))
    violations: List[str] = []
    try:
        victim_bad = hostile_curbed = victim_real_attacks = 0
        for wave in range(8):
            vfuts = [b.submit(r) for r in _requests(
                6, attack_every=3, tag="tf%dv" % wave, tenant=0)]
            hfuts = [b.submit(r) for r in _requests(
                48, tag="tf%dh" % wave, tenant=1)]
            vs_v, viol_v = _collect(vfuts, timeout_s=60)
            vs_h, viol_h = _collect(hfuts, timeout_s=60)
            violations += viol_v + viol_h
            for v in vs_v:
                if v.fail_open or v.degraded:
                    victim_bad += 1
                if v.attack and not v.fail_open and not v.degraded:
                    victim_real_attacks += 1
            hostile_curbed += sum(1 for v in vs_h
                                  if v.fail_open or v.degraded)
        if victim_bad:
            violations.append("victim tenant saw %d shed/degraded "
                              "verdicts during the flood — isolation "
                              "leaked" % victim_bad)
        if not victim_real_attacks:
            violations.append("victim tenant's attacks were not "
                              "detected during the flood")
        if not hostile_curbed:
            violations.append("flooding tenant was never shed or "
                              "degraded — admission is not tenant-fair")
        lc = b.pipeline.load_controller
        if lc.steps_up:
            violations.append("GLOBAL brownout ladder climbed (%d "
                              "steps) on a single-tenant flood — the "
                              "ladder must be reachable only from "
                              "aggregate pressure" % lc.steps_up)
        g = b.tenant_guard
        if g.quarantines < 1:
            violations.append("tenant guard never quarantined the "
                              "flooding tenant")
        if g.is_quarantined(0):
            violations.append("victim tenant was quarantined")
        # recovery: flood over, fault exhausted — after the dwell the
        # hostile tenant serves full-detection verdicts again
        deadline = time.monotonic() + 20
        recovered = False
        while time.monotonic() < deadline:
            vs, viol = _collect([b.submit(r) for r in _requests(
                4, attack_every=2, tag="tfr", tenant=1)], 30)
            violations += viol
            if vs and all(not v.fail_open and not v.degraded
                          for v in vs) and any(v.attack for v in vs):
                recovered = True
                break
            time.sleep(0.2)
        if not recovered:
            violations.append("flooding tenant never recovered to "
                              "full detection after the flood")
        return {"ok": not violations, "violations": violations,
                "hostile_curbed": hostile_curbed,
                "victim_real_attacks": victim_real_attacks,
                "quarantines": g.quarantines,
                "ladder_steps_up": lc.steps_up,
                "shed": dict(b.pipeline.stats.shed)}
    finally:
        b.close()


def _scenario_tenant_flood_canary(install_plan, device=None) -> dict:
    """A tenant flood DURING a staged rollout must not trip the
    candidate's rollback triggers: quarantined traffic is split out
    before the canary split, shed verdicts never reach the shadow
    mirror, and tenant-degraded verdicts are skipped by the diff the
    same way fail-open ones are — the rollout reaches LIVE while the
    hostile tenant sheds alone."""
    from ingress_plus_tpu_torch.models.tenant_guard import TenantGuardConfig

    b, ro, cr_inc, cr_cand = _rollout_fixtures(
        device, tenant_queue_cap=16,
        tenant_guard=TenantGuardConfig(
            window_s=0.15, up_confirm_windows=1, dwell_s=5.0,
            min_window_arrivals=16))
    install_plan(FaultPlan.from_spec(
        "slow_confirm:tenant=1,times=32,delay_s=0.01"))
    violations: List[str] = []
    try:
        ro.admit(ruleset=cr_cand)
        from ingress_plus_tpu_torch.control.rollout import LIVE, ROLLED_BACK
        deadline = time.monotonic() + 60
        wave = 0
        hostile_curbed = 0
        while ro.state not in (LIVE, ROLLED_BACK) \
                and time.monotonic() < deadline and wave <= 40:
            futs = [b.submit(r) for r in _requests(
                24, attack_every=4, tag="tc%d" % wave)]
            futs += [b.submit(r) for r in _requests(
                48, tag="tch%d" % wave, tenant=1)]
            vs, viol = _collect(futs, timeout_s=30)
            violations.extend(viol)
            hostile_curbed += sum(1 for v in vs
                                  if v.fail_open or v.degraded)
            wave += 1
        if ro.state != LIVE:
            violations.append("rollout did not reach LIVE under a "
                              "tenant flood (state=%s, rollback=%r) — "
                              "the flood tripped a candidate trigger"
                              % (ro.state, ro.rollback_reason))
        if not hostile_curbed:
            violations.append("the flood was never shed or degraded — "
                              "the scenario exercised nothing")
        if b.tenant_guard.is_quarantined(0):
            violations.append("victim tenant was quarantined")
        return {"ok": not violations, "violations": violations,
                "state": ro.state, "waves": wave,
                "hostile_curbed": hostile_curbed,
                "quarantines": b.tenant_guard.quarantines}
    finally:
        b.close()

SCENARIOS = {
    "overload_burst": _scenario_overload,
    "dispatch_hang": _scenario_dispatch_hang,
    "dispatch_raise": _scenario_dispatch_raise,
    "recompile_storm": _scenario_recompile_storm,
    "swap_fail": _scenario_swap_fail,
    "export_5xx": _scenario_export_5xx,
    "slow_confirm": _scenario_slow_confirm,
    "confirm_worker_hang": _scenario_confirm_worker_hang,
    "rollout_promote_fail": _scenario_rollout_promote_fail,
    "rollout_shadow_diverge": _scenario_rollout_shadow_diverge,
    "lkg_corrupt": _scenario_lkg_corrupt,
    "lane_dispatch_hang": _scenario_lane_dispatch_hang,
    "lane_dispatch_raise": _scenario_lane_dispatch_raise,
    "tenant_flood": _scenario_tenant_flood,
    "tenant_flood_during_canary": _scenario_tenant_flood_canary,
}

#: scenarios of the JAX package's matrix whose modules this package does
#: not have yet, with what they wait for: reported, never run or passed
NOT_PORTED = {
    "fleet_scrape": "the fleet observer (control/fleetobs.py)",
    "fleet_node_kill": "the front (serve/front.py) and fleet control",
    "fleet_rollout_node_death": "fleet control (control/fleetctl.py)",
    "fleet_partition_daemon": "the retune daemon (control/retuned.py)",
}


def run_fault_matrix(only: Optional[List[str]] = None,
                     device=None) -> dict:
    """Run every ported fault scenario on a batcher on ``device`` (None
    = the CUDA card, "cpu" for the plain scan); returns a report with
    per-scenario ok/violations.  The caller gates on ``passed``, which
    covers the ported scenarios only: ``not_ported`` lists the rest, and
    one named in ``only`` is reported as a failure.

    The previously active plan is restored afterwards — the matrix is
    safe to run inside a process that also serves (tests do)."""
    saved = active()
    report: Dict[str, dict] = {}
    try:
        for name, fn in SCENARIOS.items():
            if only and name not in only:
                continue
            clear()
            t0 = time.monotonic()
            try:
                res = fn(install, device)
            except Exception as e:  # noqa: BLE001 — a scenario crash IS a finding
                res = {"ok": False,
                       "violations": ["scenario raised %s: %s"
                                      % (type(e).__name__, e)]}
            res["seconds"] = round(time.monotonic() - t0, 2)
            report[name] = res
    finally:
        install(saved)
    for name in only or ():
        if name in NOT_PORTED:
            report[name] = {"ok": False, "violations": [
                "not ported: needs %s" % NOT_PORTED[name]]}
    return {"passed": bool(report) and all(r["ok"]
                                           for r in report.values()),
            "scenarios": report,
            "not_ported": sorted(set(NOT_PORTED) - set(report))}
