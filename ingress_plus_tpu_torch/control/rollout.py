"""Guarded ruleset rollout — admission-gated staged swaps (docs/ROBUSTNESS.md).

The port of ``ingress_plus_tpu/control/rollout.py``.  The one-shot
hot-swap (`/configuration/ruleset?mode=force`) puts any pack that merely
loads in front of 100% of live traffic instantly — a pack with dead
regexes, an over-blocking rewrite or a latency-regressing compile would
ship with no gate, no ramp and no way back.  The sync-node† contract
(continuous ruleset delivery into a node serving live traffic) only
holds if a rollout can never take detection quality or availability
down with it.

``RolloutController`` owns a staged state machine:

    IDLE ──admit()──▶ ADMITTED ─▶ SHADOW ─▶ CANARY ─▶ LIVE
                 │                   │          │
                 ▼                   ▼          ▼
              REJECTED           REJECTED   ROLLED_BACK

* **Admission gate** — before a candidate touches any traffic it must
  pass (1) the static analyzers that work on a compiled pack (the
  rulecheck subset: prefilter-soundness audit, regex hazards incl.
  confirm-unparsable dead rules, transform-lane consistency — severity
  gated by ``fail_on``, baseline-suppressed like the CI gate), (2) a
  compile smoke on the live serving-engine geometry (same engine kind,
  impl and device, the live pipeline's warm shapes), and (3) a
  golden-corpus replay (attack corpus + hand-authored benign fixtures)
  whose verdict diff vs the incumbent is thresholded: new
  false-negatives and new benign blocks each gate independently.  A
  rejected pack changes NOTHING — the incumbent keeps serving and the
  caller gets a structured rejection report (stage, reason, artifact);
  ``ipt_swap_rejected_total{reason=}``.

* **Shadow phase** — the candidate runs on a sampled mirror of real
  admitted traffic in a side lane, never the verdict path.  The lane is
  budget-capped (bounded queue + CPU-time token budget) so shadow work
  can never starve the serving cycles.  The live verdict diff
  accumulates as ``ipt_rollout_diff_total{kind=new_block|lost_hit|
  score_delta}``.

* **Canary ramp** — a per-request generation split (deterministic
  request-id hash, so a request's generation never flaps) ramps through
  ``steps`` (1% → 10% → 50% → 100% by default).  Rollback triggers are
  evaluated per step: candidate confirm-error spike, runtime-dead jump
  (the rule-drift signal), candidate dispatch failures/hangs, candidate
  fail-open events, or verdict diff beyond threshold → automatic
  rollback to the incumbent; the failed pack is quarantined and the
  reason exported.  The incumbent never stopped serving its share, so
  rollback is simply "stop routing to the candidate".

* **Last-known-good** — every pack that reaches LIVE is persisted
  atomically (version-named artifact, write-then-rename, then an
  atomically replaced ``LKG`` pointer file) into ``lkg_dir``, in the
  same files the JAX package writes, so either package restarts from
  the other's LKG.  On startup the server prefers the LKG artifact over
  a possibly mid-rollout pack, so a crash during rollout restarts
  serving the last pack that actually survived traffic (``load_lkg``;
  the ``lkg_corrupt`` fault site exercises the corrupt-pointer
  fallback).

On a card the replay and the shadow lane scan on the CANDIDATE's own
kernels: the prefilter through the live impl's kernel on the
candidate's tables, then the full confirm (``detect_cpu_only`` refuses
a card pipeline); the shadow's scan ignores the serving brownout ladder,
as ``detect_cpu_only`` does on the CPU (``_shadow_scan``).  The
replay's incumbent twin gets an engine of its own
(``live.engine.rebuilt``), so admission shares no engine, scanner, CUDA
stream or launch tally with the serving lane; the admission thread and
the shadow worker each make the card current and launch on a CUDA
stream of their own, tallied under the rollout launch scope
(``ops/cuda_build.launch_scope``).  The diff counts equal the CPU
path's: the prefilter only narrows, and the static gate has certified
it.  A CPU pipeline keeps the JAX semantics exactly (``detect_cpu_only``
on both sides, the twin sharing the live engine).

Break-glass: ``/configuration/ruleset?mode=force`` keeps the old
one-shot semantics (an active rollout is aborted first).
``run_swap_drill()`` drives the three canonical rollouts on a batcher.
A learned scoring head rolls out through the same stages
(``admit_scoring``): its candidate is the live pack with the new head
bound, and a promoted head becomes the scorer LKG (``LKG_SCORER``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from queue import Empty, Full, Queue
from typing import Dict, List, Optional, TYPE_CHECKING, Tuple

import torch

if TYPE_CHECKING:
    from ingress_plus_tpu_torch.serve.batcher import Batcher

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.ops.cuda_build import ROLLOUT_SCOPE, launch_scope
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.trace import (
    EV_SHADOW,
    flight,
    named_rlock,
)

#: rollout phases (ipt_rollout_state exports the index)
STATES = ("idle", "admitted", "shadow", "canary", "live", "rejected",
          "rolled_back")

IDLE, ADMITTED, SHADOW, CANARY, LIVE, REJECTED, ROLLED_BACK = STATES


class RolloutRejected(Exception):
    """A candidate pack failed a rollout gate; nothing changed.

    Carries the structured rejection report the serve endpoint returns
    verbatim (stage, reason, artifact, detail)."""

    def __init__(self, stage: str, reason: str, artifact: str = "",
                 detail=None):
        super().__init__("%s: %s" % (stage, reason))
        self.report = {"stage": stage, "reason": reason,
                       "artifact": artifact, "detail": detail}


@dataclass
class RolloutConfig:
    """Knobs for the guarded rollout (serve CLI: --rollout-*, --lkg-dir).

    The admission thresholds default to zero tolerance: a candidate that
    loses ANY golden-corpus attack or blocks ANY benign fixture the
    incumbent passes is rejected — relaxing that is an explicit operator
    decision, not a default."""

    #: static-gate severity (the rulecheck --fail-on analog)
    fail_on: str = "error"
    #: canary traffic fractions, ramped in order; last step should be 1.0
    steps: Tuple[float, ...] = (0.01, 0.10, 0.50, 1.0)
    #: candidate-served requests required per step before advancing
    step_min_requests: int = 200
    #: mirrored requests required before shadow promotes to canary
    shadow_min_requests: int = 64
    #: fraction of admitted traffic mirrored into the shadow lane
    shadow_sample: float = 0.25
    #: bounded shadow queue — overflow drops (counted), never blocks
    shadow_queue_cap: int = 256
    #: CPU-time budget for the shadow worker as a fraction of wall time;
    #: over budget the mirror drops instead of scanning (the serving
    #: cycles share these cores and must win)
    shadow_cpu_budget: float = 0.25
    #: golden-corpus replay size (attacks; benign fixtures ride along)
    corpus_n: int = 192
    #: admission replay thresholds (counts, not fractions: zero default)
    max_new_fn: int = 0
    max_new_benign_blocks: int = 0
    #: live rollback triggers (shadow + canary)
    max_confirm_errors: int = 0
    max_runtime_dead_jump: int = 0
    max_candidate_failures: int = 0
    max_candidate_fail_open: int = 0
    #: live verdict-diff rollback: (new_block + lost_hit) / compared
    max_diff_frac: float = 0.02
    #: mirrored verdicts required before the diff fraction can trigger
    diff_min_compared: int = 50
    #: scoring-head admission: minimum fraction of the head's rule-id
    #: map found in the live pack (a head trained against a different
    #: pack generation scores with silently-missing features below this)
    scorer_min_coverage: float = 0.90
    #: last-known-good artifact directory (None disables persistence)
    lkg_dir: Optional[str] = None


def validate_overrides(raw: dict) -> dict:
    """Validate per-rollout config overrides (the admit payload's knob
    surface).  Everything is checked BEFORE any state mutates — a bad
    value raises ValueError and the rollout config is untouched (an
    unvalidated steps list reaching ``split()`` would kill the dispatch
    thread)."""
    out: dict = {}
    for k, v in raw.items():
        if k == "steps":
            try:
                steps = tuple(float(s) for s in v)
            except (TypeError, ValueError):
                raise ValueError("steps must be a list of numbers")
            if not steps or any(not 0.0 < s <= 1.0 for s in steps) \
                    or list(steps) != sorted(steps) or steps[-1] != 1.0:
                raise ValueError(
                    "steps must ascend within (0, 1] and end at 1.0")
            out[k] = steps
        elif k in ("step_min_requests", "shadow_min_requests"):
            iv = int(v)
            if iv < 1:
                raise ValueError("%s must be >= 1" % k)
            out[k] = iv
        elif k == "shadow_sample":
            fv = float(v)
            if not 0.0 <= fv <= 1.0:
                raise ValueError("shadow_sample must be in [0, 1]")
            out[k] = fv
        else:
            raise ValueError("unknown rollout override %r" % k)
    return out


def _hash_frac(request_id: str) -> float:
    """Deterministic [0, 1) per request id.  Monotone ramp: the set of
    ids below fraction f1 is a subset of those below f2 > f1, so growing
    the step only MOVES traffic incumbent→candidate, never back."""
    return (zlib.crc32(request_id.encode("utf-8", "surrogateescape"))
            & 0xFFFFFFFF) / 4294967296.0


def _runtime_dead(pipeline) -> int:
    rs = pipeline.rule_stats
    return int(((rs.candidates > 0) & rs.broken).sum())


# ----------------------------------------------------------- LKG store
# Version-named artifacts + an atomically replaced pointer file: a crash
# at ANY instant leaves the pointer naming a complete artifact pair (the
# new pair lands under a new name before the pointer moves).

LKG_POINTER = "LKG"


def persist_lkg(cr: CompiledRuleset, lkg_dir: str | Path,
                keep: int = 2) -> Path:
    """Atomically persist ``cr`` as the last-known-good pack."""
    d = Path(lkg_dir)
    d.mkdir(parents=True, exist_ok=True)
    version = cr.version or cr.fingerprint()
    base = d / ("pack-%s" % version)
    tmp = d / (".tmp-%s" % version)
    cr.save(tmp)   # writes .npz + .json
    os.replace(tmp.with_suffix(".npz"), base.with_suffix(".npz"))
    os.replace(tmp.with_suffix(".json"), base.with_suffix(".json"))
    ptr_tmp = d / (LKG_POINTER + ".tmp")
    ptr_tmp.write_text(json.dumps({"artifact": base.name,
                                   "version": version}))
    os.replace(ptr_tmp, d / LKG_POINTER)
    # retire old generations (never the one just written)
    packs = sorted((p for p in d.glob("pack-*.json") if p.stem != base.stem),
                   key=lambda p: p.stat().st_mtime)
    for p in packs[:max(0, len(packs) - (keep - 1))]:
        p.unlink(missing_ok=True)
        p.with_suffix(".npz").unlink(missing_ok=True)
    return base


def load_lkg(lkg_dir: str | Path) -> Optional[CompiledRuleset]:
    """Load the last-known-good pack, or None when there is none or it
    is unreadable (corrupt pointer/artifact — the caller falls back to
    its configured rules source; serving must start either way)."""
    d = Path(lkg_dir)
    ptr = d / LKG_POINTER
    if not ptr.is_file():
        return None
    try:
        faults.raise_if("lkg_corrupt")
        meta = json.loads(ptr.read_text())
        return CompiledRuleset.load(d / meta["artifact"])
    except Exception:
        return None


# ------------------------------------------------------- the controller


def _shadow_scan(cand, request, on_card: bool):
    """The candidate's full verdict on one mirrored request.  On a card:
    the prefilter on the candidate's own kernels, then the full confirm
    — whatever the serving brownout ladder's level (the candidate shares
    the incumbent's controller, and a degraded or failed-open candidate
    verdict diffed against a full incumbent one would read as
    divergence).  The CPU path, ``detect_cpu_only``, ignores the ladder
    too.  The CPU budget is spent on the host clock around the call."""
    if not on_card:
        return cand.detect_cpu_only([request])[0]
    t0 = time.perf_counter()
    cand.stats.requests += 1
    cand.stats.batches += 1
    return cand.finalize([request], cand.prefilter([request]), t0)[0]


class RolloutController:
    """Owns the staged rollout state machine; attached to a Batcher as
    ``batcher.rollout``.  The batcher's dispatch thread consults only
    two torn-free bool flags on its clean path (``shadow_active`` /
    ``canary_active``) — an idle controller costs two attribute reads
    per cycle.  State transitions serialize on ``_lock``; the candidate
    pipeline is installed/cleared only under the batcher's swap lock so
    the dispatch thread never sees a half-built generation."""

    def __init__(self, batcher: "Batcher",
                 config: Optional[RolloutConfig] = None):
        self.batcher = batcher
        # _base_config is the attached default; each admit() derives its
        # EFFECTIVE config from it (base + that push's overrides), so an
        # override never leaks into the next rollout
        self._base_config = config or RolloutConfig()
        self.config = self._base_config
        self.state = IDLE
        self.candidate = None            # DetectionPipeline | None
        self.candidate_version = ""
        #: what kind of artifact is rolling out: "ruleset" | "scorer"
        self.candidate_kind = ""
        #: the candidate pipeline's generation tag (ruleset version, or
        #: ruleset+head for a scoring rollout) — what its verdicts are
        #: stamped with; the mirror's self-diff skip keys on THIS, not
        #: on candidate_version (a scoring candidate's version is the
        #: head's, but its verdicts carry the combined tag)
        self.candidate_generation = ""
        self.candidate_artifact = ""     # source path ("" = in-memory)
        self._candidate_cr = None        # CompiledRuleset for LKG persist
        self._candidate_head = None      # ScoringHead for scorer LKG
        self.step_idx = 0
        self.step_served = 0
        self.started_at = 0.0
        self.rollback_reason = ""
        # flags the dispatch thread reads without the lock
        self.shadow_active = False
        self.canary_active = False
        # counters (exported at /metrics and /rollout)
        self.swap_rejected: Dict[str, int] = {}
        self.diff: Dict[str, int] = {"new_block": 0, "lost_hit": 0,
                                     "score_delta": 0}
        self.shadow_mirrored = 0
        self.shadow_compared = 0
        self.shadow_dropped = 0
        self.candidate_requests = 0      # canary-served total
        self.candidate_failures = 0      # dispatch errors/hangs
        self.candidate_fail_open = 0
        self.rollbacks = 0
        self.promotions = 0
        self.last_admission: Optional[dict] = None
        #: host seconds of the last admission's stages (static gate,
        #: compile smoke, replay) — clock readings, not part of the
        #: admission report
        self.admission_seconds: Dict[str, float] = {}
        self.history: List[dict] = []    # bounded event log
        # REENTRANT: the accounting helpers below (_event,
        # count_rejected, the shadow/canary counters) serialize on this
        # lock and are called both bare and from under it (bare counter
        # bumps would race the shadow thread)
        self._lock = named_rlock("RolloutController._lock")
        # shadow lane: bounded queue + one CPU worker + token budget
        self._shadow_q: "Queue" = Queue(maxsize=self.config.shadow_queue_cap)
        self._shadow_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._budget_s = 0.0             # earned CPU seconds (token bucket)
        self._budget_at = time.monotonic()
        self._dead_baseline = 0          # incumbent runtime-dead at admit
        self._admitting = False          # one admission at a time
        # promotion is DEFERRED to tick(): _evaluate can run on the
        # dispatch thread while it holds the batcher's swap lock, and
        # promote() needs that same (non-reentrant) lock — the batcher
        # calls tick() once per cycle after releasing it
        self._promote_pending = False
        # the admission thread's own CUDA stream on a card (created at
        # the first card admission; admissions are serialized)
        self._admit_stream = None

    # ------------------------------------------------------- accounting

    def _event(self, kind: str, **kw) -> None:
        with self._lock:
            self.history.append({"ts": time.time(), "event": kind, **kw})
            del self.history[:-64]

    def count_rejected(self, reason: str) -> None:
        """Also used by the serve endpoint for force-mode load failures
        (the ``ipt_swap_rejected_total{reason="load"}`` satellite)."""
        with self._lock:
            self.swap_rejected[reason] = \
                self.swap_rejected.get(reason, 0) + 1

    def _reject(self, stage: str, reason: str, detail=None) -> None:
        self.count_rejected(reason)
        with self._lock:
            self.state = REJECTED
            self._clear_candidate()
        self._event("rejected", stage=stage, reason=reason)
        raise RolloutRejected(stage, reason, self.candidate_artifact, detail)

    def _clear_candidate(self) -> None:
        """Under _lock: drop the candidate generation.  Flags first —
        the dispatch thread must stop routing before the pipeline ref
        goes (it re-reads ``self.candidate`` per cycle either way)."""
        self.shadow_active = False
        self.canary_active = False
        # a rolled-back candidate's verdict-cache entries (shadow /
        # canary traffic) must not outlive it — quarantine hygiene
        if self.candidate is not None and \
                getattr(self.candidate, "confirm_cache", None) is not None:
            self.candidate.confirm_cache.invalidate("rollback")
        self.candidate = None
        self._candidate_cr = None
        self._candidate_head = None

    # -------------------------------------------------------- admission

    def admit(self, artifact_path: Optional[str] = None,
              ruleset: Optional[CompiledRuleset] = None,
              paranoia_level: Optional[int] = None,
              overrides: Optional[dict] = None) -> dict:
        """Run the full admission gate and start the shadow phase.

        Raises ``RolloutRejected`` (nothing changed) on any gate
        failure; returns the admission report on success.  ``overrides``
        (validated per-rollout config knobs: steps, step_min_requests,
        shadow_min_requests, shadow_sample) are applied only once the
        in-progress check has passed — a rejected concurrent admit must
        never mutate the ACTIVE rollout's config."""
        if ruleset is None and artifact_path is None:
            raise ValueError("admit() needs an artifact path or a ruleset")
        overrides = validate_overrides(overrides or {})
        with self._lock:
            if self.state in (SHADOW, CANARY) or self._admitting:
                raise RolloutRejected(
                    "admission", "rollout_in_progress", self.candidate_artifact,
                    {"active_candidate": self.candidate_version})
            self._admitting = True
            # effective config for THIS rollout only: base + overrides
            # (a fresh copy even with no overrides, so a previous
            # push's knobs never survive into this one)
            from dataclasses import replace as _dc_replace
            self.config = _dc_replace(self._base_config, **overrides)
        try:
            with self._admission_device():
                return self._admit_inner(artifact_path, ruleset,
                                         paranoia_level)
        finally:
            with self._lock:
                self._admitting = False

    def _admit_inner(self, artifact_path, ruleset, paranoia_level) -> dict:
        with self._lock:
            self.candidate_artifact = str(artifact_path or "")
            self.admission_seconds = {}
        t0 = time.perf_counter()
        # stage 1: load ----------------------------------------------------
        if ruleset is None:
            try:
                ruleset = CompiledRuleset.load(artifact_path)
            except Exception as e:
                self._reject("load", "load",
                             {"error": "%s: %s" % (type(e).__name__, e)})
        live = self.batcher.pipeline
        if ruleset.version and ruleset.version == live.ruleset.version:
            self._reject("load", "already_live",
                         {"version": ruleset.version})
        # stage 2: static gate (the compiled-pack rulecheck subset) --------
        t0 = self._stage_time("load", t0)
        findings = self._static_gate(ruleset)
        t0 = self._stage_time("static", t0)
        if findings:
            self._reject("static", "rulecheck", {
                "findings": [{"check": f.check, "severity": f.severity,
                              "rule_id": f.rule_id, "message": f.message}
                             for f in findings[:16]],
                "count": len(findings)})
        # stage 3: compile smoke on the live engine geometry ---------------
        try:
            candidate = self._build_candidate(ruleset, paranoia_level)
        except Exception as e:
            self._reject("compile", "compile_smoke",
                         {"error": "%s: %s" % (type(e).__name__, e)})
        t0 = self._stage_time("compile", t0)
        # stage 4: golden-corpus replay diff -------------------------------
        replay = self._replay_diff(live, candidate)
        self._stage_time("replay", t0)
        if replay["new_fns"] > self.config.max_new_fn:
            self._reject("replay", "new_fns", replay)
        if replay["benign_new_blocks"] > self.config.max_new_benign_blocks:
            self._reject("replay", "benign_blocks", replay)
        # admitted: adopt the node-wide pressure/counter planes (the
        # cumulative Prometheus counters span generations by design; the
        # brownout ladder is a node signal, not a generation's), zero the
        # replay out of the per-rule telemetry, then open the shadow lane
        candidate.reset_detection_observations()
        candidate.stats = live.stats
        candidate.load_controller = live.load_controller
        report = {
            "state": SHADOW,
            "candidate": ruleset.version,
            "incumbent": live.ruleset.version,
            "artifact": self.candidate_artifact,
            "replay": replay,
        }
        self._enter_admitted(candidate, ruleset.version, "ruleset",
                             report, cr=ruleset)
        self._event("admitted", candidate=ruleset.version)
        return report

    def _stage_time(self, stage: str, t0: float) -> float:
        """Record one admission stage's host seconds; returns now."""
        t1 = time.perf_counter()
        with self._lock:
            self.admission_seconds[stage] = t1 - t0
        return t1

    def _enter_admitted(self, candidate, version: str, kind: str,
                        report: dict, cr=None, head=None) -> None:
        """Shared ADMITTED-state install for both artifact kinds
        (ruleset packs and scoring heads): every per-rollout counter
        and baseline resets in ONE place under the lock, then the
        shadow lane opens — a counter added for one kind can never
        leak stale values into the other's next rollout."""
        live = self.batcher.pipeline
        with self._lock:
            self.state = ADMITTED
            self.candidate = candidate
            self._candidate_cr = cr
            self._candidate_head = head
            self.candidate_version = version
            self.candidate_kind = kind
            self.candidate_generation = candidate.generation_tag
            self.step_idx = 0
            self.step_served = 0
            self.candidate_requests = 0
            self.candidate_failures = 0
            self.candidate_fail_open = 0
            self.shadow_mirrored = self.shadow_compared = 0
            self.shadow_dropped = 0
            self.diff = {"new_block": 0, "lost_hit": 0, "score_delta": 0}
            self.rollback_reason = ""
            self._promote_pending = False
            self.started_at = time.time()
            self._dead_baseline = _runtime_dead(live)
            self.last_admission = report
            self._start_shadow_locked()

    def _admission_device(self):
        """The admission thread's device context: on a card, the card
        current, the controller's own CUDA stream current (work on the
        legacy default stream would serialize with the serving lane's)
        and every launch tallied under ``ROLLOUT_SCOPE``; on the CPU,
        nothing."""
        dev = self.batcher.pipeline.engine.device
        stack = contextlib.ExitStack()
        if dev.type == "cuda":
            if self._admit_stream is None:
                self._admit_stream = torch.cuda.Stream(dev)
            stack.enter_context(torch.cuda.device(dev))
            stack.enter_context(torch.cuda.stream(self._admit_stream))
            stack.enter_context(launch_scope(ROLLOUT_SCOPE))
        return stack

    def _static_gate(self, ruleset: CompiledRuleset) -> list:
        """The rulecheck checks that run on a COMPILED pack (no SecLang
        source needed): prefilter soundness, regex hazards (incl. the
        confirm-unparsable silently-dead class), transform lanes.
        Baseline suppression mirrors the CI gate: the artifact's own
        baseline when shipped next to it, else the bundled CRS one."""
        from ingress_plus_tpu_torch.analysis import BUNDLED_RULES
        from ingress_plus_tpu_torch.analysis.findings import (
            Baseline,
            _SEV_RANK,
        )
        from ingress_plus_tpu_torch.analysis.lanecheck import check_lanes
        from ingress_plus_tpu_torch.analysis.prefilter_audit import (
            audit_prefilter,
        )
        from ingress_plus_tpu_torch.analysis.redos import check_regex_hazards

        findings = []
        findings += audit_prefilter(ruleset.rules, ruleset.tables)
        findings += check_regex_hazards(ruleset.rules)
        findings += check_lanes(ruleset.rules)
        baseline = None
        if self.candidate_artifact:
            cand = Path(self.candidate_artifact).parent \
                / "rulecheck-baseline.json"
            if cand.is_file():
                baseline = cand
        if baseline is None:
            bundled = BUNDLED_RULES / "rulecheck-baseline.json"
            baseline = bundled if bundled.is_file() else None
        if baseline is not None:
            Baseline.load(baseline).apply(findings)
        rank = _SEV_RANK.get(self.config.fail_on, 0)
        return [f for f in findings
                if not f.suppressed and _SEV_RANK[f.severity] <= rank]

    def _build_candidate(self, ruleset: CompiledRuleset,
                         paranoia_level: Optional[int]):
        """Compile smoke: the candidate pipeline on the SAME engine kind,
        impl and device as the live one, warmed on the live pipeline's
        served shapes, then one real detect — the candidate's table
        uploads and scanners are built HERE, on the admission thread,
        never in front of canary traffic."""
        from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
        from ingress_plus_tpu_torch.utils.corpus import generate_corpus

        live = self.batcher.pipeline
        candidate = DetectionPipeline(
            ruleset, mode=live.mode,
            anomaly_threshold=None,   # pack config > incumbent's value
            fail_open=live.fail_open, paranoia_level=paranoia_level,
            # enforcement state rides along: the ACL store is SHARED
            # (live /configuration/acl pushes apply to both generations
            # mid-rollout), bindings are copied at admission — a canary
            # must never un-deny a blocked source
            acl_store=live.acl_store,
            tenant_acl=dict(live.tenant_acl),
            default_acl=live.default_acl,
            # an installed learned head rides a ruleset rollout (rule-id
            # remap re-binds it to the candidate pack's axis) — a pack
            # promote must not silently drop the scoring model
            scoring_head=live.scoring_head,
            engine=live.engine.rebuilt(ruleset))
        # tenant (EP) rule subsets re-derived against the CANDIDATE's
        # rule axis (the same derivation a promote/swap runs)
        tags = getattr(self.batcher, "tenant_tags", None)
        if tags:
            from ingress_plus_tpu_torch.control.sync import tenant_masks
            candidate.tenant_rule_mask = tenant_masks(ruleset, tags)
        for shape in sorted(getattr(live, "seen_shapes", ())):
            candidate.warm_shape(*shape)
        smoke = [lr.request for lr in generate_corpus(n=4, seed=7)]
        verdicts = candidate.detect_strict(smoke)
        if len(verdicts) != len(smoke):
            raise RuntimeError("smoke detect returned %d verdicts for %d "
                               "requests" % (len(verdicts), len(smoke)))
        return candidate

    def _replay_diff(self, live, candidate) -> dict:
        """Golden-corpus replay: attack corpus + benign fixtures through
        both generations.  On a CPU pipeline: the CPU confirm lane only
        (``detect_cpu_only`` is parity-tested exact), the incumbent a
        detached twin sharing the live ENGINE (unused on that path).  On
        a card: ``detect_strict`` on both generations' kernels, the twin
        on an engine of its own (``live.engine.rebuilt``) — never the
        serving lane's engine, scanner or stream.  Never the live stats
        either way: admission must not pollute the serving
        telemetry."""
        from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
        from ingress_plus_tpu_torch.utils.benign_fixtures import (
            fixture_requests,
        )
        from ingress_plus_tpu_torch.utils.corpus import generate_corpus

        # a card pipeline never reaches detect_cpu_only (the batcher's
        # rule for its breaker-open route, serve/batcher.py)
        on_card = not self.batcher._cpu_fallback_ok(live)
        twin = DetectionPipeline(
            live.ruleset, mode="block",
            anomaly_threshold=live.anomaly_threshold,
            # the twin IS the incumbent scorer: a scoring-head rollout
            # diffs learned-vs-learned (or learned-vs-fixed) exactly as
            # live traffic would see it
            scoring_head=live.scoring_head,
            engine=(live.engine.rebuilt(live.ruleset) if on_card
                    else live.engine))
        # the card path scans through the prefilter (the twin's and the
        # candidate's own kernels); the CPU path skips it
        twin_detect = twin.detect_strict if on_card else twin.detect_cpu_only
        cand_detect = (candidate.detect_strict if on_card
                       else candidate.detect_cpu_only)
        labeled = generate_corpus(n=self.config.corpus_n,
                                  attack_fraction=0.5, seed=20260804)
        benign = fixture_requests()
        new_fns: List[str] = []
        new_blocks: List[str] = []
        benign_new_blocks: List[str] = []
        lost, gained, score_delta = 0, 0, 0
        B = 64
        reqs = [lr.request for lr in labeled]
        for i in range(0, len(reqs), B):
            chunk = reqs[i:i + B]
            vi = twin_detect(chunk)
            vc = cand_detect(chunk)
            for lr, a, b in zip(labeled[i:i + B], vi, vc):
                if a.attack and not b.attack:
                    lost += 1
                    if lr.is_attack:
                        new_fns.append(a.request_id)
                if b.attack and not a.attack:
                    gained += 1
                if b.blocked and not a.blocked:
                    new_blocks.append(a.request_id)
                if a.score != b.score:
                    score_delta += 1
        for i in range(0, len(benign), B):
            chunk = benign[i:i + B]
            vi = twin_detect(chunk)
            vc = cand_detect(chunk)
            for a, b in zip(vi, vc):
                if b.blocked and not a.blocked:
                    benign_new_blocks.append(a.request_id)
        return {
            "corpus_requests": len(reqs),
            "benign_fixtures": len(benign),
            "new_fns": len(new_fns),
            "new_fn_ids": new_fns[:8],
            "new_blocks": len(new_blocks),
            "lost_attack_verdicts": lost,
            "gained_attack_verdicts": gained,
            "score_deltas": score_delta,
            "benign_new_blocks": len(benign_new_blocks),
            "benign_new_block_ids": benign_new_blocks[:8],
        }

    # ------------------------------------------- scoring-head admission

    def admit_scoring(self, artifact_path: Optional[str] = None,
                      head=None, overrides: Optional[dict] = None) -> dict:
        """Admission gate for a LEARNED SCORING HEAD artifact
        (docs/LEARNED_SCORING.md): same staged machinery as a ruleset
        rollout — the candidate generation is the live pack with the
        new head bound, so shadow diffing, the canary ramp, every
        rollback trigger, and LKG recovery apply unchanged.  Stages:

        1. load    — artifact parse + content-hash verification
                     (ScoringHead.load rejects corrupt/tampered files)
        2. schema  — shape/finiteness validation + already-live check
        3. coverage— rule-id-map coverage against the LIVE pack
                     (``scorer_min_coverage``)
        4. compile — candidate pipeline build (same pack: on the CPU
                     it shares the live engine, on a card it gets an
                     engine of its own) + smoke detect
        5. replay  — golden-corpus diff vs the INCUMBENT scorer
                     (zero-new-FN / zero-new-benign-block defaults)

        On a card every stage that scans runs on the admission thread's
        device context (``_admission_device``) and the candidate's own
        kernels, as a pack admission does.
        """
        if head is None and artifact_path is None:
            raise ValueError("admit_scoring() needs an artifact path "
                             "or a ScoringHead")
        overrides = validate_overrides(overrides or {})
        with self._lock:
            if self.state in (SHADOW, CANARY) or self._admitting:
                raise RolloutRejected(
                    "admission", "rollout_in_progress",
                    str(artifact_path or ""),
                    {"active_candidate": self.candidate_version})
            self._admitting = True
            from dataclasses import replace as _dc_replace
            self.config = _dc_replace(self._base_config, **overrides)
        try:
            with self._admission_device():
                return self._admit_scoring_inner(artifact_path, head)
        finally:
            with self._lock:
                self._admitting = False

    def _admit_scoring_inner(self, artifact_path, head) -> dict:
        from ingress_plus_tpu_torch.learn.head import (
            LearnedScorer,
            ScoringHead,
        )

        with self._lock:
            self.candidate_artifact = str(artifact_path or "")
            self.admission_seconds = {}
        t0 = time.perf_counter()
        # stage 1: load (content hash verified inside load) -----------------
        if head is None:
            try:
                head = ScoringHead.load(artifact_path)
            except Exception as e:
                self._reject("load", "scorer_load",
                             {"error": "%s: %s" % (type(e).__name__, e)})
        # stage 2: schema + already-live -------------------------------------
        try:
            head.validate()
        except ValueError as e:
            self._reject("schema", "scorer_schema", {"error": str(e)})
        live = self.batcher.pipeline
        if live.scoring_head is not None \
                and head.version == live.scoring_head.version:
            self._reject("load", "already_live",
                         {"version": head.version})
        t0 = self._stage_time("load", t0)
        # stage 3: rule-id-map coverage against the live pack ----------------
        scorer = LearnedScorer(head, live.ruleset)
        if scorer.coverage < self.config.scorer_min_coverage:
            self._reject("coverage", "scorer_coverage", {
                "coverage": round(scorer.coverage, 4),
                "required": self.config.scorer_min_coverage,
                "ruleset": live.ruleset.version})
        t0 = self._stage_time("coverage", t0)
        # stage 4: candidate build + smoke -----------------------------------
        try:
            candidate = self._build_scoring_candidate(head)
        except Exception as e:
            self._reject("compile", "compile_smoke",
                         {"error": "%s: %s" % (type(e).__name__, e)})
        t0 = self._stage_time("compile", t0)
        # stage 5: golden-corpus replay vs the incumbent scorer --------------
        replay = self._replay_diff(live, candidate)
        self._stage_time("replay", t0)
        if replay["new_fns"] > self.config.max_new_fn:
            self._reject("replay", "new_fns", replay)
        if replay["benign_new_blocks"] > self.config.max_new_benign_blocks:
            self._reject("replay", "benign_blocks", replay)
        candidate.reset_detection_observations()
        candidate.stats = live.stats
        candidate.load_controller = live.load_controller
        report = {
            "state": SHADOW,
            "kind": "scorer",
            "candidate": head.version,
            "incumbent": live.generation_tag,
            "artifact": self.candidate_artifact,
            "coverage": round(scorer.coverage, 4),
            "threshold": round(float(head.threshold), 6),
            "replay": replay,
        }
        self._enter_admitted(candidate, head.version, "scorer",
                             report, head=head)
        self._event("admitted", candidate=head.version,
                    rollout_kind="scorer")
        return report

    def _build_scoring_candidate(self, head):
        """Candidate pipeline for a scoring rollout: the LIVE pack with
        the new head bound.  A scorer changes only the host finalize
        step, so the seen-shape sets are adopted from the incumbent:
        candidate dispatches must not book phantom recompiles in the
        efficiency gauges.  On a CPU pipeline the engine is SHARED (same
        ruleset, same tables); on a card the candidate scans on an
        engine of its own (``live.engine.rebuilt``: its tables and
        scanner), never the serving lane's."""
        from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
        from ingress_plus_tpu_torch.utils.corpus import generate_corpus

        live = self.batcher.pipeline
        candidate = DetectionPipeline(
            live.ruleset, mode=live.mode,
            anomaly_threshold=live.anomaly_threshold,
            fail_open=live.fail_open,
            acl_store=live.acl_store,
            tenant_acl=dict(live.tenant_acl),
            default_acl=live.default_acl,
            engine=(live.engine if self.batcher._cpu_fallback_ok(live)
                    else live.engine.rebuilt(live.ruleset)),
            scoring_head=head)
        candidate.tenant_rule_mask = live.tenant_rule_mask
        candidate.seen_shapes = set(live.seen_shapes)
        candidate.seen_lane_shapes = set(live.seen_lane_shapes)
        candidate._seen_exec = set(live._seen_exec)
        smoke = [lr.request for lr in generate_corpus(n=4, seed=7)]
        verdicts = candidate.detect_strict(smoke)
        if len(verdicts) != len(smoke):
            raise RuntimeError("smoke detect returned %d verdicts for %d "
                               "requests" % (len(verdicts), len(smoke)))
        return candidate

    # ----------------------------------------------------- shadow phase

    def _start_shadow_locked(self) -> None:
        self.state = SHADOW
        self._budget_s = 0.0
        self._budget_at = time.monotonic()
        if self._shadow_thread is None:
            self._shadow_thread = threading.Thread(
                target=self._shadow_run, daemon=True, name="ipt-shadow")
            self._shadow_thread.start()
        self.shadow_active = True

    def mirror(self, request, live_verdict) -> None:
        """Offer one live (request, verdict) pair to the shadow lane.
        Called by the batcher AFTER the real verdict resolved — never on
        the verdict path.  Sampled by the same deterministic hash as the
        canary split; overflow drops and counts, never blocks."""
        if not self.shadow_active:
            return
        if _hash_frac(request.request_id) >= self.config.shadow_sample:
            return
        gen = getattr(live_verdict, "generation", "")
        # only FULL incumbent verdicts are diffable: a fail-open or
        # degraded verdict (empty generation / brownout prefilter-only)
        # was never fully scanned by any generation — diffing it against
        # a candidate full scan would book the candidate's CORRECT
        # blocks as divergence and roll back a good pack because the
        # INCUMBENT lane faulted
        if live_verdict.fail_open or live_verdict.degraded or not gen:
            return
        # canary-served candidate verdicts must not diff against the
        # candidate itself (generation stamp from models/pipeline.py;
        # candidate_generation is the candidate PIPELINE's tag)
        if gen == self.candidate_generation:
            return
        try:
            self._shadow_q.put_nowait((request, live_verdict))
            with self._lock:
                self.shadow_mirrored += 1
        except Full:
            with self._lock:
                self.shadow_dropped += 1

    def _shadow_run(self) -> None:
        cfg = self.config
        flight.register_thread("shadow")
        on_card = not self.batcher._cpu_fallback_ok(self.batcher.pipeline)
        if on_card:
            # a lane worker's setup: the card and a stream of this
            # thread's own current for the thread's life; launches
            # tallied under ROLLOUT_SCOPE
            dev = self.batcher.pipeline.engine.device
            torch.cuda.set_device(dev)
            torch.cuda.set_stream(torch.cuda.Stream(dev))
        with launch_scope(ROLLOUT_SCOPE):
            self._shadow_loop(cfg, on_card)

    def _shadow_loop(self, cfg, on_card: bool) -> None:
        while not self._stop.is_set():
            try:
                request, live_v = self._shadow_q.get(timeout=0.1)
            except Empty:
                continue
            cand = self.candidate
            if cand is None or not self.shadow_active:
                continue
            # CPU token budget: earn budget_frac of elapsed wall time,
            # spend measured scan seconds; broke → drop (counted)
            now = time.monotonic()
            with self._lock:
                self._budget_s = min(
                    self._budget_s + (now - self._budget_at) *
                    cfg.shadow_cpu_budget, 1.0)
                self._budget_at = now
                broke = self._budget_s <= 0.0
                if broke:
                    self.shadow_dropped += 1
            if broke:
                continue
            t0 = time.monotonic()
            flight.begin(EV_SHADOW, cycle=0)
            try:
                if faults.fire("shadow_diverge"):
                    # injected divergence: the candidate "blocks" a
                    # request the incumbent passed (CI rollback drill)
                    with self._lock:
                        self.diff["new_block"] += 1
                        self.shadow_compared += 1
                else:
                    cv = _shadow_scan(cand, request, on_card)
                    self._diff_verdicts(live_v, cv)
            except Exception:
                with self._lock:
                    self.candidate_failures += 1
            finally:
                flight.end(EV_SHADOW, cycle=0)
            with self._lock:
                self._budget_s -= time.monotonic() - t0
            self._evaluate()
            self.tick()

    def _diff_verdicts(self, live_v, cand_v) -> None:
        with self._lock:
            self.shadow_compared += 1
            if cand_v.blocked and not live_v.blocked:
                self.diff["new_block"] += 1
            if live_v.attack and not cand_v.attack:
                self.diff["lost_hit"] += 1
            if cand_v.score != live_v.score:
                self.diff["score_delta"] += 1

    # ----------------------------------------------------- canary phase

    def split(self, items: list) -> tuple:
        """Partition a cycle's (ts, request, fut) items into (incumbent,
        candidate) by the deterministic hash at the current step
        fraction.  Dispatch-thread only."""
        if not self.canary_active:
            return items, []
        steps = self.config.steps
        # clamped read: steps and step_idx are written by other threads;
        # a torn pair must degrade to a wrong fraction, never an
        # IndexError that kills the dispatch thread
        frac = steps[min(self.step_idx, len(steps) - 1)]
        inc, cand = [], []
        for item in items:
            (cand if _hash_frac(item[1].request_id) < frac
             else inc).append(item)
        return inc, cand

    def observe_canary(self, n_served: int, verdicts) -> None:
        """Per-cycle canary accounting + trigger evaluation (dispatch
        thread, after the candidate sub-batch resolved)."""
        with self._lock:
            self.candidate_requests += n_served
            self.step_served += n_served
            for v in verdicts:
                if v.fail_open:
                    self.candidate_fail_open += 1
        self._evaluate()

    def record_candidate_failure(self, reason: str) -> None:
        """A candidate dispatch raised or hung (batcher's guarded call).
        Candidate failures never feed the SHARED breaker — the incumbent
        path must keep its own failure signal clean; they trigger
        rollback instead."""
        with self._lock:
            self.candidate_failures += 1
        self._event("candidate_failure", reason=reason)
        self._evaluate()

    def _triggers(self) -> Optional[str]:
        cfg = self.config
        cand = self.candidate
        if cand is None:
            return None
        if self.candidate_failures > cfg.max_candidate_failures:
            return "candidate_dispatch_failures"
        if self.candidate_fail_open > cfg.max_candidate_fail_open:
            return "candidate_fail_open"
        if int(cand.rule_stats.confirm_errors.sum()) \
                > cfg.max_confirm_errors:
            return "confirm_error_spike"
        if _runtime_dead(cand) - self._dead_baseline \
                > cfg.max_runtime_dead_jump:
            return "runtime_dead_jump"
        if self.shadow_compared >= cfg.diff_min_compared:
            bad = self.diff["new_block"] + self.diff["lost_hit"]
            if bad / self.shadow_compared > cfg.max_diff_frac:
                return "verdict_diff"
        return None

    def _evaluate(self) -> None:
        """Evaluate triggers + phase advancement.  Cheap when nothing is
        pending; serialized transitions under _lock.  May run on the
        dispatch thread WHILE it holds the batcher's swap lock, so the
        one transition that needs that lock (promotion) is only FLAGGED
        here and performed by ``tick()`` off-lock."""
        if not (self.shadow_active or self.canary_active):
            return
        reason = self._triggers()
        if reason is not None:
            self.rollback(reason)
            return
        with self._lock:
            if self.state == SHADOW \
                    and self.shadow_compared >= self.config.shadow_min_requests:
                self.state = CANARY
                self.step_idx = 0
                self.step_served = 0
                self.canary_active = True
                self._event("canary_started",
                            fraction=self.config.steps[0])
                return
            if self.state == CANARY \
                    and self.step_served >= self.config.step_min_requests:
                if self.step_idx + 1 < len(self.config.steps):
                    self.step_idx += 1
                    self.step_served = 0
                    self._event("canary_step",
                                fraction=self.config.steps[self.step_idx])
                else:
                    self._promote_pending = True

    def tick(self) -> None:
        """Deferred-transition pump: the batcher calls this once per
        dispatch cycle AFTER releasing the swap lock; the shadow worker
        calls it between diffs.  No-op unless a promotion is pending."""
        if self._promote_pending:
            with self._lock:
                pending, self._promote_pending = self._promote_pending, False
            if pending:
                self.promote()

    # ------------------------------------------------ promote / rollback

    def promote(self) -> None:
        """Install the candidate as the live generation (the staged
        twin of ``Batcher.swap_ruleset``: the candidate pipeline is
        already built, warm, and carrying its canary-phase RuleStats).
        The ``swap_fail`` fault site guards the boundary — a failure
        here must leave the incumbent serving (fault-matrix invariant),
        recorded as a rollback."""
        cand = self.candidate
        if cand is None:
            return
        b = self.batcher
        try:
            faults.raise_if("swap_fail")
            with b._swap_lock:
                prev = b.pipeline
                prev_stream = b.stream_engine.pipeline
                try:
                    cand.frozen_rule_stats = prev.rule_stats.freeze()
                    # cross-cycle verdict cache: carried like the pool
                    # (generation-keyed — old entries are unreachable
                    # by construction; the drop is hygiene)
                    if getattr(prev, "confirm_cache", None) is not None:
                        prev.confirm_cache.invalidate("promote")
                        cand.confirm_cache = prev.confirm_cache
                    b.pipeline = cand
                    b.stream_engine.pipeline = cand
                    b._reapply_tenants()
                except Exception:
                    # half-installed candidate: restore the incumbent
                    # BEFORE reporting rollback — state must never say
                    # ROLLED_BACK while the candidate is serving
                    b.pipeline = prev
                    b.stream_engine.pipeline = prev_stream
                    try:
                        b._reapply_tenants()
                    except Exception:
                        pass
                    raise
                with self._lock:
                    self.state = LIVE
                    self.canary_active = False
                    self.shadow_active = False
        except Exception as e:
            self.rollback("promote_failed:%s" % type(e).__name__)
            return
        with self._lock:
            self.promotions += 1
            cr, self._candidate_cr = self._candidate_cr, None
            head, self._candidate_head = self._candidate_head, None
            self.candidate = None
        self._event("live", candidate=self.candidate_version,
                    rollout_kind=self.candidate_kind)
        if self.config.lkg_dir and cr is not None:
            try:
                persist_lkg(cr, self.config.lkg_dir)
                self._event("lkg_persisted", version=cr.version)
            except OSError as e:
                # LKG is recovery insurance, not a serving dependency
                self._event("lkg_persist_failed", error=str(e))
        if self.config.lkg_dir and head is not None:
            from ingress_plus_tpu_torch.learn.head import persist_lkg_scorer

            try:
                persist_lkg_scorer(head, self.config.lkg_dir)
                self._event("scorer_lkg_persisted", version=head.version)
            except OSError as e:
                self._event("lkg_persist_failed", error=str(e))

    def rollback(self, reason: str) -> None:
        """Back to the incumbent: stop routing to the candidate (it
        never owned more than its ramp share), quarantine the pack,
        export the reason.  The incumbent's counters and drift-freeze
        state were never touched — there is nothing to restore."""
        with self._lock:
            if self.state not in (SHADOW, CANARY, ADMITTED):
                return
            self.state = ROLLED_BACK
            self.rollback_reason = reason
            self._clear_candidate()
            self.rollbacks += 1
        self.count_rejected("rollback_" + reason.partition(":")[0])
        self._quarantine(reason)
        self._event("rolled_back", reason=reason,
                    candidate=self.candidate_version)

    def abort(self, reason: str = "manual") -> bool:
        """Operator/break-glass abort of an in-flight rollout."""
        with self._lock:
            active = self.state in (ADMITTED, SHADOW, CANARY)
        if active:
            self.rollback(reason)
        return active

    def _quarantine(self, reason: str) -> None:
        if not self.config.lkg_dir:
            return
        try:
            qdir = Path(self.config.lkg_dir) / "quarantine"
            qdir.mkdir(parents=True, exist_ok=True)
            (qdir / ("%s.json" % (self.candidate_version or "unknown"))
             ).write_text(json.dumps({
                 "version": self.candidate_version,
                 "artifact": self.candidate_artifact,
                 "reason": reason,
                 "ts": time.time(),
                 "diff": dict(self.diff),
             }, indent=2))
        except OSError:
            pass   # quarantine is advisory; rollback already happened

    # ---------------------------------------------------------- teardown

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            self._clear_candidate()
        if self._shadow_thread is not None:
            self._shadow_thread.join(timeout=2)
            with self._lock:
                self._shadow_thread = None

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        with self._lock:
            frac = (self.config.steps[self.step_idx]
                    if self.canary_active else
                    (1.0 if self.state == LIVE else 0.0))
            return {
                "state": self.state,
                "candidate": self.candidate_version or None,
                "kind": self.candidate_kind or None,
                "artifact": self.candidate_artifact or None,
                "incumbent": self.batcher.pipeline.ruleset.version,
                "step": self.step_idx,
                "steps": list(self.config.steps),
                "fraction": frac,
                "step_served": self.step_served,
                "step_min_requests": self.config.step_min_requests,
                "shadow": {
                    "active": self.shadow_active,
                    "mirrored": self.shadow_mirrored,
                    "compared": self.shadow_compared,
                    "dropped": self.shadow_dropped,
                    "sample": self.config.shadow_sample,
                },
                "diff": dict(self.diff),
                "candidate_requests": self.candidate_requests,
                "candidate_failures": self.candidate_failures,
                "candidate_fail_open": self.candidate_fail_open,
                "rollbacks": self.rollbacks,
                "promotions": self.promotions,
                "rollback_reason": self.rollback_reason or None,
                "swap_rejected": dict(self.swap_rejected),
                "lkg_dir": self.config.lkg_dir,
                "last_admission": self.last_admission,
                "admission_s": dict(self.admission_seconds),
                "history": self.history[-16:],
            }


# ========================================================== swap drill
# Prove the state machine on a real batcher — a good pack reaches LIVE
# through every phase, a rulecheck-dirty pack is REJECTED with zero
# traffic impact, and a forced mid-canary failure auto-rolls back to the
# incumbent — all while every admitted request resolves to exactly one
# verdict.

_DRILL_INCUMBENT = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
"""

#: the candidate adds one rule — a strict superset whose pattern hits
#: nothing in the golden corpus or the benign fixtures, so the replay
#: diff is clean (a "drop table" rule here was correctly REJECTED by the
#: benign gate: the fixtures carry legitimate SQL-in-prose)
_DRILL_CANDIDATE = _DRILL_INCUMBENT + """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)xp_drillshell\\(" \
    "id:955100,phase:2,block,severity:CRITICAL,tag:'attack-rce'"
"""

#: dead-regex fixture (the 941290/941300 shape): the pattern is
#: confirm-unparsable -> rulecheck flags the rule silently DEAD at
#: error severity -> the admission static gate must reject the pack
_DRILL_BROKEN = _DRILL_INCUMBENT + """
SecRule ARGS "@rx (?:\\\\u00[0-7]){4,}" \
    "id:999999,phase:2,block,severity:CRITICAL,tag:'attack-generic'"
"""


def _drill_config(lkg_dir: Optional[str] = None) -> RolloutConfig:
    return RolloutConfig(
        steps=(0.25, 1.0), step_min_requests=8, shadow_min_requests=4,
        shadow_sample=1.0, corpus_n=32, diff_min_compared=4,
        lkg_dir=lkg_dir)


def _drill_traffic(batcher, n: int, tag: str, timeout_s: float = 60.0):
    """Push n requests (every 4th an attack) and resolve every future —
    the exactly-one-verdict invariant check rides on the resolve."""
    from ingress_plus_tpu_torch.utils.faults import _collect, _requests

    reqs = _requests(n, attack_every=4, tag=tag)
    futs = [batcher.submit(r) for r in reqs]
    return _collect(futs, timeout_s)


def run_swap_drill(lkg_dir: Optional[str] = None, device=None) -> dict:
    """Drive the three canonical rollouts end to end on a batcher on
    ``device`` (None = the CUDA card; "cpu" for the plain scan);
    returns a report whose ``passed`` a caller asserts."""
    import tempfile

    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.utils.faults import _mk_batcher

    tmp = None
    if lkg_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="ipt-lkg-")
        lkg_dir = tmp.name
    report: Dict[str, dict] = {}
    cr_inc = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
    cr_good = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
    cr_bad = compile_ruleset(parse_seclang(_DRILL_BROKEN))

    def _drill(name: str, fn) -> None:
        t0 = time.monotonic()
        b = _mk_batcher(cr=cr_inc, device=device)
        ro = RolloutController(b, _drill_config(lkg_dir))
        b.rollout = ro
        violations: List[str] = []
        try:
            fn(b, ro, violations)
        except Exception as e:  # noqa: BLE001 — a drill crash IS a finding
            violations.append("drill raised %s: %s" % (type(e).__name__, e))
        finally:
            ro.close()
            b.close()
        report[name] = {"ok": not violations, "violations": violations,
                        "state": ro.state,
                        "seconds": round(time.monotonic() - t0, 2)}

    def _good(b, ro, violations):
        ro.admit(ruleset=cr_good)
        deadline = time.monotonic() + 60
        wave = 0
        while ro.state not in (LIVE, REJECTED, ROLLED_BACK) \
                and time.monotonic() < deadline:
            _, viol = _drill_traffic(b, 24, "g%d" % wave)
            violations.extend(viol)
            wave += 1
        if ro.state != LIVE:
            violations.append("good pack never reached LIVE (state=%s, "
                              "reason=%s)" % (ro.state, ro.rollback_reason))
            return
        if b.pipeline.ruleset.version != cr_good.version:
            violations.append("LIVE state but incumbent still serving")
        verdicts, viol = _drill_traffic(b, 16, "post")
        violations.extend(viol)
        if not any(v.attack for v in verdicts):
            violations.append("promoted pack lost detection")
        lkg = load_lkg(lkg_dir)
        if lkg is None or lkg.version != cr_good.version:
            violations.append("LKG not persisted after promote")
        report["good_pack_events"] = {"history": ro.history[-8:]}

    def _broken(b, ro, violations):
        v0 = b.pipeline.ruleset.version
        try:
            ro.admit(ruleset=cr_bad)
            violations.append("rulecheck-dirty pack was admitted")
        except RolloutRejected as e:
            if e.report["stage"] != "static":
                violations.append("broken pack rejected at %r, expected "
                                  "the static gate" % e.report["stage"])
        if b.pipeline.ruleset.version != v0:
            violations.append("rejection mutated the serving generation")
        verdicts, viol = _drill_traffic(b, 16, "rej")
        violations.extend(viol)
        if not any(v.attack and not v.fail_open for v in verdicts):
            violations.append("incumbent lost detection after rejection")
        if ro.swap_rejected.get("rulecheck", 0) < 1:
            violations.append("rejection not counted in swap_rejected")

    def _midcanary(b, ro, violations):
        v0 = b.pipeline.ruleset.version
        ro.admit(ruleset=cr_good)
        deadline = time.monotonic() + 60
        wave = 0
        while ro.state != CANARY and ro.state in (ADMITTED, SHADOW) \
                and time.monotonic() < deadline:
            _, viol = _drill_traffic(b, 24, "m%d" % wave)
            violations.extend(viol)
            wave += 1
        if ro.state != CANARY:
            violations.append("rollout never reached CANARY (state=%s)"
                              % ro.state)
            return
        # forced mid-canary failure: candidate dispatches start raising
        ro.record_candidate_failure("forced_drill_failure")
        _, viol = _drill_traffic(b, 24, "mc")
        violations.extend(viol)
        if ro.state != ROLLED_BACK:
            violations.append("forced canary failure did not roll back "
                              "(state=%s)" % ro.state)
        if b.pipeline.ruleset.version != v0:
            violations.append("rollback did not restore the incumbent")
        verdicts, viol = _drill_traffic(b, 16, "mr")
        violations.extend(viol)
        if not any(v.attack and not v.fail_open for v in verdicts):
            violations.append("incumbent lost detection after rollback")
        qdir = Path(lkg_dir) / "quarantine"
        if not any(qdir.glob("*.json")):
            violations.append("rolled-back pack was not quarantined")

    try:
        _drill("good_pack_to_live", _good)
        _drill("broken_pack_rejected", _broken)
        _drill("mid_canary_rollback", _midcanary)
    finally:
        if tmp is not None:
            tmp.cleanup()
    drills = {k: v for k, v in report.items() if "ok" in v}
    return {"passed": all(r["ok"] for r in drills.values()),
            "drills": report}
