"""Detection-plane telemetry keyed by sigpack row.

Stage latency says where the time went and the static rulecheck says
whether the compiled ruleset is sound.  This layer answers "what is each
rule actually doing in production":

  * ``RuleStats`` — vectorized per-rule counters updated once per
    finalize batch (numpy adds under a short lock, O(R) per batch —
    never per request): prefilter candidates, confirm hits, anomaly
    score / block contributions, and **confirm errors** — the runtime
    twin of rulecheck's ``regex.confirm-unparsable``.  A rule whose
    confirm regex fails at runtime silently abstains (models/confirm.py
    ``_op_match`` → None), so without this counter it is invisible
    until the next static audit; with it, the rule shows as
    runtime-dead in ``/rules/health`` after its first candidate.
  * ``FrozenRuleStats`` / ``drift_report`` — reload-drift detection:
    the batcher freezes the outgoing ruleset version's stats on hot
    swap, and ``/rules/drift`` joins old vs new per rule id (hit-rate
    deltas, rules that went quiet after a reload — the class of
    regression a proton.db-style sync ships silently).
  * ``device_efficiency`` / ``bench_block`` — device-efficiency gauges
    the bench hints at but the server never exported: bucket occupancy,
    padding-waste ratio, dispatch fill, recompile count; plus the
    per-family false-candidate summary the BENCH json carries as its
    ``rule_stats`` block (the prefilter over-approximation axis — the
    wasted confirm CPU the bitap prefilter trades for device
    throughput, cf. the approximate-automata NIDS line in PAPERS.md).

Cardinality policy: per-RULE detail is JSON-only (``/rules/*``);
Prometheus gets per-FAMILY series with a hard label budget
(``utils/trace.py bounded_counter_series``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ingress_plus_tpu_torch.utils.trace import named_lock


def family_of(rule_id: int) -> str:
    """CRS family label for a rule id: the leading 3 digits of a 6+
    digit id (942100 → "942"); shorter ids (sigpack signatures, local
    rules) fold into "custom".  Families are the bounded label space the
    Prometheus series use — never the full id set."""
    rid = int(rule_id)
    return str(rid)[:3] if rid >= 100000 else "custom"


class BitmapRing:
    """Opt-in bounded ring of raw per-request activation bitmaps — the
    shadow-time feature source for the learned scoring lane
    (docs/LEARNED_SCORING.md).

    Each entry is a (candidates, confirmed) pair of ``np.packbits``-
    packed rows — ~2·⌈R/8⌉ bytes per request, so the default 8 MiB cap
    holds ~16k requests of a 2k-rule pack.  The cap is HARD: capacity is
    derived from ``cap_bytes`` up front and the deque evicts oldest on
    overflow (``dropped`` counts) — capture can never grow the serve
    plane's memory unboundedly.  Appends happen under the owning
    RuleStats lock (one packbits per finalize batch, not per request)."""

    def __init__(self, n_rules: int, cap_bytes: int = 8 << 20) -> None:
        self.n_rules = int(n_rules)
        self.row_bytes = 2 * ((self.n_rules + 7) // 8)
        self.capacity = max(1, int(cap_bytes) // self.row_bytes)
        self.cap_bytes = int(cap_bytes)
        self._ring: Deque[Tuple[np.ndarray, np.ndarray]] = deque(
            maxlen=self.capacity)
        self.appended = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    def extend(self, cand_packed: np.ndarray,
               conf_packed: np.ndarray) -> None:
        """Fold one finalize batch of packed rows ((Q, ⌈R/8⌉) each)."""
        q = cand_packed.shape[0]
        self.dropped += max(0, len(self._ring) + q - self.capacity)
        self.appended += q
        for i in range(q):
            self._ring.append((cand_packed[i], conf_packed[i]))

    def clear(self) -> None:
        self._ring.clear()
        self.appended = 0
        self.dropped = 0

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Unpacked ((N, R) candidates, (N, R) confirmed) bool arrays,
        oldest first."""
        if not self._ring:
            z = np.zeros((0, self.n_rules), dtype=bool)
            return z, z.copy()
        cand = np.stack([c for c, _ in self._ring])
        conf = np.stack([f for _, f in self._ring])
        return (np.unpackbits(cand, axis=1)[:, :self.n_rules].astype(bool),
                np.unpackbits(conf, axis=1)[:, :self.n_rules].astype(bool))

    def stats(self) -> dict:
        return {"requests": len(self._ring), "capacity": self.capacity,
                "cap_bytes": self.cap_bytes, "appended": self.appended,
                "dropped": self.dropped}


@dataclass
class FrozenRuleStats:
    """Immutable snapshot of one ruleset version's counters, taken at
    hot-swap time (the old version's last word — drift's "before")."""

    version: str
    requests: int
    rule_ids: np.ndarray     # (R,) int64
    candidates: np.ndarray   # (R,) int64
    confirmed: np.ndarray    # (R,) int64


class RuleStats:
    """Per-rule runtime counters for one CompiledRuleset generation.

    All mutation is batch-granular and vectorized; the only per-rule
    Python work is on confirmed hits (already a short list).  Thread
    safety: the dispatch thread and the oversized side worker both
    finalize (each under the batcher's swap lock), direct library
    callers may not hold any lock — so updates take a short internal
    lock of their own."""

    def __init__(self, ruleset, confirms: Optional[Sequence] = None):
        R = int(ruleset.n_rules)
        self.version: str = ruleset.version
        self.rule_ids = np.asarray(ruleset.rule_ids, dtype=np.int64).copy()
        self.rule_score = np.asarray(ruleset.rule_score,
                                     dtype=np.int64).copy()
        self.families: List[str] = [family_of(r) for r in self.rule_ids]
        self.candidates = np.zeros((R,), dtype=np.int64)
        self.confirmed = np.zeros((R,), dtype=np.int64)
        self.confirm_errors = np.zeros((R,), dtype=np.int64)
        self.score_sum = np.zeros((R,), dtype=np.int64)
        self.block_hits = np.zeros((R,), dtype=np.int64)
        # per-rule cumulative confirm cost (docs/CONFIRM_PLANE.md):
        # nanoseconds spent in this rule's candidate walks, sampled per
        # (request, rule) by the confirm plane and folded here in one
        # vectorized add per batch — /rules/health ranks the top-
        # expensive confirms from it
        self.confirm_ns = np.zeros((R,), dtype=np.int64)
        self.requests = 0
        # config machinery (ctl-carrying pass-action rules): never a
        # detection hit by design, excluded from the never-hit /
        # never-candidate health views (the pipeline marks them)
        self.ignored = np.zeros((R,), dtype=bool)
        # rules whose confirm can never evaluate (broken regex in the
        # rule or any chain link): every candidate is a confirm error
        self.broken = np.zeros((R,), dtype=bool)
        self.broken_reason: Dict[int, str] = {}
        if confirms is not None:
            for i, c in enumerate(confirms):
                reason = c.dead_reason()
                if reason is not None:
                    self.broken[i] = True
                    self.broken_reason[i] = reason
        # the ConfirmRule closures themselves: quick-reject counters
        # (qr_skips/qr_evals — telemetry-grade plain ints maintained by
        # the confirm plane) are gathered from them at snapshot time,
        # so the per-generation reset convention covers them too
        self._confirms: List = list(confirms) if confirms is not None else []
        # opt-in raw-bitmap capture (learned-scorer feature source);
        # None = off, the serve-plane default
        self.capture: Optional[BitmapRing] = None
        # sampled scanned-byte histogram — the byte-frequency axis of
        # the MeasuredProfile export (compiler/profile.py).  Budgeted:
        # once ``byte_sample_budget`` bytes have been folded the fold
        # is a no-op, so the steady-state dispatch cost is zero
        self.byte_hist = np.zeros((256,), dtype=np.int64)
        self.byte_sampled = 0
        self.byte_sample_budget = 4 << 20
        self._lock = named_lock("RuleStats._lock")

    # ---------------------------------------------------------- update

    def enable_capture(self, cap_bytes: int = 8 << 20) -> BitmapRing:
        """Turn on the bounded per-request bitmap ring (idempotent when
        already on with the same cap)."""
        with self._lock:
            if self.capture is None or \
                    self.capture.cap_bytes != int(cap_bytes):
                self.capture = BitmapRing(len(self.rule_ids), cap_bytes)
            return self.capture

    def disable_capture(self) -> None:
        with self._lock:
            self.capture = None

    def capture_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if self.capture is None:
                z = np.zeros((0, len(self.rule_ids)), dtype=bool)
                return z, z.copy()
            return self.capture.snapshot()

    def reset(self) -> None:
        """Zero the counters (warmup exclusion — see
        DetectionPipeline.reset_detection_observations); the broken-rule
        mask is structural and survives.  The capture ring (when on)
        empties too — warmup traffic must not leak into a training
        dataset any more than into the hit-rate gauges."""
        with self._lock:
            for a in (self.candidates, self.confirmed,
                      self.confirm_errors, self.score_sum,
                      self.block_hits, self.confirm_ns):
                a[:] = 0
            self.requests = 0
            for c in self._confirms:
                for r in c.walk_chain():
                    r.qr_skips = 0
                    r.qr_evals = 0
            self.byte_hist[:] = 0
            self.byte_sampled = 0
            if self.capture is not None:
                self.capture.clear()

    def observe_bytes(self, rows: Sequence[bytes]) -> None:
        """Fold scanned request bytes into the sampled histogram (one
        vectorized bincount per row, dispatch-thread side).  Stops dead
        once the per-generation budget is spent — profile quality needs
        a few MiB of traffic shape, not an unbounded tax."""
        if self.byte_sampled >= self.byte_sample_budget:
            return
        h = np.zeros((256,), dtype=np.int64)
        n = 0
        for r in rows:
            if len(r) == 0:
                continue
            h += np.bincount(np.frombuffer(r, dtype=np.uint8),
                             minlength=256)
            n += len(r)
            if self.byte_sampled + n >= self.byte_sample_budget:
                break
        if n == 0:
            return
        with self._lock:
            self.byte_hist += h
            self.byte_sampled += n

    def observe_finalize(self, rule_hits: np.ndarray,
                         confirmed_idx: Sequence[int],
                         confirmed_blocked: Sequence[bool],
                         confirmed_rows: Optional[
                             Sequence[Sequence[int]]] = None,
                         rule_ns: Optional[Tuple[Sequence[int],
                                                 Sequence[int]]] = None
                         ) -> None:
        """Fold one finalize batch.

        ``rule_hits``: the (Q, R) masked candidate matrix the batch
        confirmed against (the caller zeroes per-request runtime-ctl
        exclusions first — those rules were never confirm-evaluated);
        ``confirmed_idx``: flat rule indices of every confirmed
        (request, rule) hit across the batch; ``confirmed_blocked``:
        same length, whether that request's verdict blocked;
        ``confirmed_rows``: per-request confirmed index lists (len Q) —
        only consumed by the opt-in capture ring, which stays silent
        when the caller cannot provide them (prefilter-only brownout
        verdicts are not training-grade features);
        ``rule_ns``: per-(request, rule) confirm cost samples from the
        confirm plane as parallel (rule_index, nanoseconds) sequences —
        folded into ``confirm_ns`` in one vectorized add."""
        cand = rule_hits.sum(axis=0, dtype=np.int64)
        # config machinery (ignored mask) is never a detection
        # candidate — suppress on the reduced vector, one place
        cand[self.ignored] = 0
        with self._lock:
            self.requests += int(rule_hits.shape[0])
            self.candidates += cand
            if self.capture is not None and confirmed_rows is not None:
                conf = np.zeros_like(rule_hits, dtype=bool)
                for qi, row in enumerate(confirmed_rows):
                    if len(row):
                        conf[qi, np.asarray(row, dtype=np.int64)] = True
                self.capture.extend(
                    np.packbits(rule_hits.astype(bool), axis=1),
                    np.packbits(conf, axis=1))
            if self.broken.any():
                self.confirm_errors += np.where(self.broken, cand, 0)
            if len(confirmed_idx):
                idx = np.asarray(confirmed_idx, dtype=np.int64)
                np.add.at(self.confirmed, idx, 1)
                np.add.at(self.score_sum, idx, self.rule_score[idx])
                bidx = idx[np.asarray(confirmed_blocked, dtype=bool)]
                if len(bidx):
                    np.add.at(self.block_hits, bidx, 1)
            if rule_ns is not None and len(rule_ns[0]):
                np.add.at(self.confirm_ns,
                          np.asarray(rule_ns[0], dtype=np.int64),
                          np.asarray(rule_ns[1], dtype=np.int64))

    # -------------------------------------------------------- snapshot

    def _snap(self):
        with self._lock:
            return (self.requests, self.candidates.copy(),
                    self.confirmed.copy(), self.confirm_errors.copy(),
                    self.score_sum.copy(), self.block_hits.copy())

    def _snap_confirm(self):
        """Confirm-plane columns: (confirm_ns, qr_skips, qr_evals) —
        the quick-reject counters gather from the ConfirmRule closures
        (plain ints; a racing confirm worker may cost an increment,
        never a crash)."""
        R = len(self.rule_ids)
        with self._lock:
            ns = self.confirm_ns.copy()
            skips = np.zeros((R,), dtype=np.int64)
            evals = np.zeros((R,), dtype=np.int64)
            for i, c in enumerate(self._confirms[:R]):
                # chain links evaluate (and quick-reject) too — their
                # counters book against the parent rule's row
                skips[i] = sum(r.qr_skips for r in c.walk_chain())
                evals[i] = sum(r.qr_evals for r in c.walk_chain())
            return ns, skips, evals

    def quick_reject_summary(self) -> dict:
        """Pack-level quick-reject coverage + hit rate: how many rx
        rules carry mandatory literals, and what fraction of candidate
        evaluations the literal pre-check resolved without ``re``."""
        _ns, skips, evals = self._snap_confirm()
        rules = [r for c in self._confirms for r in c.walk_chain()]
        rx_rules = sum(1 for c in rules
                       if getattr(c, "op", None) == "rx"
                       and c.rx is not None)
        covered = sum(1 for c in rules
                      if getattr(c, "qr_literals", None) is not None)
        total_skips = int(skips.sum())
        total_evals = int(evals.sum())
        checked = total_skips + total_evals
        return {
            "rx_rules": rx_rules,
            "rules_with_literals": covered,
            "coverage": round(covered / rx_rules, 4) if rx_rules else None,
            "skips": total_skips,
            "regex_evals": total_evals,
            "skip_rate": (round(total_skips / checked, 4)
                          if checked else None),
        }

    def freeze(self) -> FrozenRuleStats:
        requests, cand, conf, _err, _sc, _bl = self._snap()
        return FrozenRuleStats(version=self.version, requests=requests,
                               rule_ids=self.rule_ids.copy(),
                               candidates=cand, confirmed=conf)

    def rules_json(self, limit: int = 0) -> List[dict]:
        """Per-rule records, candidates-descending (full detail is
        JSON-only by the cardinality policy); ``limit`` 0 = all."""
        _req, cand, conf, err, score, block = self._snap()
        ns, skips, _evals = self._snap_confirm()
        order = np.argsort(-cand, kind="stable")
        if limit:
            order = order[:limit]
        out = []
        for i in order:
            i = int(i)
            c = int(cand[i])
            rec = {
                "rule_id": int(self.rule_ids[i]),
                "family": self.families[i],
                "candidates": c,
                "confirmed": int(conf[i]),
                "confirm_errors": int(err[i]),
                "false_candidates": c - int(conf[i]),
                "false_candidate_rate":
                    round((c - int(conf[i])) / c, 4) if c else 0.0,
                "score_sum": int(score[i]),
                "block_hits": int(block[i]),
                "confirm_us": int(ns[i] // 1000),
                "quick_rejects": int(skips[i]),
            }
            if i in self.broken_reason:
                rec["dead_reason"] = self.broken_reason[i]
            out.append(rec)
        return out

    def family_totals(self) -> Dict[str, Dict[str, int]]:
        _req, cand, conf, err, _score, _block = self._snap()
        out: Dict[str, Dict[str, int]] = {}
        for i, fam in enumerate(self.families):
            t = out.setdefault(fam, {"candidates": 0, "confirmed": 0,
                                     "confirm_errors": 0, "rules": 0})
            t["candidates"] += int(cand[i])
            t["confirmed"] += int(conf[i])
            t["confirm_errors"] += int(err[i])
            t["rules"] += 1
        return out

    def health(self, never_hit_cap: int = 50,
               top_waste: int = 20, top_cost: int = 20) -> dict:
        """The /rules/health body: runtime-dead rules (confirm can never
        evaluate AND candidates reached it), latent-dead rules (broken
        but not yet candidated), never-hit rules, the top false-
        candidate rules ranked by wasted confirm evaluations (the
        confirm-CPU cost of prefilter over-approximation), the top
        rules by cumulative confirm cost, and the quick-reject coverage
        summary (docs/CONFIRM_PLANE.md)."""
        requests, cand, conf, err, _score, _block = self._snap()
        ns, skips, _evals = self._snap_confirm()
        runtime_dead, latent_dead = [], []
        for i in np.nonzero(self.broken)[0]:
            i = int(i)
            rec = {"rule_id": int(self.rule_ids[i]),
                   "confirm_errors": int(err[i]),
                   "candidates": int(cand[i]),
                   "reason": self.broken_reason.get(i, "")}
            (runtime_dead if cand[i] > 0 else latent_dead).append(rec)
        never = np.nonzero((conf == 0) & ~self.ignored)[0]
        never_cand = np.nonzero((cand == 0) & ~self.ignored)[0]
        # broken rules are reported under runtime_dead, not here: their
        # candidates all "waste" by definition (confirm aborts on the
        # None pattern instantly), and a loose-factored dead rule would
        # otherwise bury the genuinely tunable rules this list targets
        waste = np.where(self.broken, 0, cand - conf)
        worder = np.argsort(-waste, kind="stable")[:top_waste]
        top = []
        for i in worder:
            i = int(i)
            if waste[i] <= 0:
                break
            top.append({"rule_id": int(self.rule_ids[i]),
                        "family": self.families[i],
                        "candidates": int(cand[i]),
                        "confirmed": int(conf[i]),
                        "wasted_confirms": int(waste[i]),
                        "false_candidate_rate":
                            round(int(waste[i]) / int(cand[i]), 4)})
        corder = np.argsort(-ns, kind="stable")[:top_cost]
        expensive = []
        for i in corder:
            i = int(i)
            if ns[i] <= 0:
                break
            expensive.append({
                "rule_id": int(self.rule_ids[i]),
                "family": self.families[i],
                "confirm_us": int(ns[i] // 1000),
                "candidates": int(cand[i]),
                "confirmed": int(conf[i]),
                "quick_rejects": int(skips[i]),
                "us_per_candidate":
                    round(int(ns[i]) / 1000.0 / int(cand[i]), 2)
                    if cand[i] else None,
            })
        return {
            "version": self.version,
            "requests": requests,
            "runtime_dead": runtime_dead,
            "latent_dead": latent_dead,
            "top_expensive_confirms": expensive,
            "quick_reject": self.quick_reject_summary(),
            "never_hit": {
                "count": int(len(never)),
                "total_rules": int(len(self.rule_ids)),
                "sample_rule_ids":
                    [int(self.rule_ids[i]) for i in never[:never_hit_cap]],
                "note": "confirmed == 0 over the requests above; expect "
                        "many on low traffic — judge against `requests`",
            },
            "never_candidate_count": int(len(never_cand)),
            "top_false_candidates": top,
        }


def drift_report(frozen: Optional[FrozenRuleStats], live: RuleStats,
                 top: int = 200, min_new_requests: int = 100) -> dict:
    """Join the frozen (pre-swap) stats against the live generation by
    rule id: per-rule confirm-hit-rate deltas plus the went-quiet flag
    (confirmed before the reload, silent after).  ``frozen`` None means
    no hot swap has happened yet — an explicit note, not an error.

    ``min_new_requests``: traffic floor before went_quiet fires —
    right after a swap essentially every previously-active rule has
    confirmed==0 simply because no matching request arrived yet, so an
    unfloored flag would report dozens of false regressions
    (``/rules/drift?min=N`` overrides; the deltas report regardless)."""
    if frozen is None:
        return {"note": "no ruleset swap since startup; /rules/drift "
                        "compares across the most recent hot reload",
                "new_version": live.version, "rules": []}
    requests, cand, conf, _err, _sc, _bl = live._snap()
    old_idx = {int(r): i for i, r in enumerate(frozen.rule_ids)}
    new_idx = {int(r): i for i, r in enumerate(live.rule_ids)}
    old_req = max(frozen.requests, 1)
    new_req = max(requests, 1)
    quiet_eligible = requests >= min_new_requests
    rows = []
    went_quiet = []
    for rid, ni in new_idx.items():
        oi = old_idx.get(rid)
        if oi is None:
            continue
        old_rate = float(frozen.confirmed[oi]) / old_req
        new_rate = float(conf[ni]) / new_req
        if old_rate == 0.0 and new_rate == 0.0:
            continue
        quiet = (quiet_eligible and frozen.confirmed[oi] > 0
                 and conf[ni] == 0)
        rows.append({
            "rule_id": rid,
            "old_confirmed": int(frozen.confirmed[oi]),
            "new_confirmed": int(conf[ni]),
            "old_hit_rate": round(old_rate, 6),
            "new_hit_rate": round(new_rate, 6),
            "delta": round(new_rate - old_rate, 6),
            "went_quiet": bool(quiet),
        })
        if quiet:
            went_quiet.append(rid)
    rows.sort(key=lambda r: abs(r["delta"]), reverse=True)
    added = sorted(set(new_idx) - set(old_idx))
    removed = sorted(set(old_idx) - set(new_idx))
    return {
        "old_version": frozen.version,
        "new_version": live.version,
        "old_requests": frozen.requests,
        "new_requests": requests,
        "min_new_requests": min_new_requests,
        "rules": rows[:top],
        "went_quiet": sorted(went_quiet),
        "added_rules": added[:100],
        "removed_rules": removed[:100],
    }


def device_efficiency(stats) -> dict:
    """Device-efficiency gauges from PipelineStats: how much of the
    padded (B, L) rectangles the engine scans is live bytes, how full
    the dispatched row dimension runs, how often serving hit a shape
    the warmup had not compiled, and per-L-tier bucket occupancy.

    Reads the RESETTABLE group (live_* / padded_* — zeroed after
    warmup), not the cumulative Prometheus counters.  The bucket dicts
    are copied via dict() FIRST: that copy is a single C-level op under
    the GIL, safe against the dispatch thread inserting a new L tier
    mid-scrape (a plain comprehension over the live dict can raise
    "dict changed size during iteration")."""
    pad_bytes = getattr(stats, "padded_bytes", 0)
    pad_rows = getattr(stats, "padded_rows", 0)
    bucket_rows = dict(getattr(stats, "bucket_rows", {}))
    bucket_padded = dict(getattr(stats, "bucket_padded_rows", {}))
    return {
        "padding_waste_ratio":
            round(1.0 - stats.live_row_bytes / pad_bytes, 4) if pad_bytes
            else None,
        "dispatch_fill":
            round(stats.live_rows / pad_rows, 4) if pad_rows else None,
        "engine_recompiles": getattr(stats, "engine_compiles", 0),
        "bucket_rows":
            {str(k): v for k, v in sorted(bucket_rows.items())},
        "bucket_padded_rows":
            {str(k): v for k, v in sorted(bucket_padded.items())},
    }


def bench_block(pipeline) -> Optional[dict]:
    """The BENCH json ``rule_stats`` block (per-family false-candidate
    rate + the padding-waste / dispatch-fill gauges), mirroring the
    ``stage_breakdown`` convention: callers treat None as a LOUD
    warning, never a silent absence."""
    rs = getattr(pipeline, "rule_stats", None)
    if rs is None or rs.requests == 0:
        return None
    fams = rs.family_totals()
    per_family = {}
    tot_cand = tot_conf = 0
    for fam, t in sorted(fams.items()):
        c, cf = t["candidates"], t["confirmed"]
        tot_cand += c
        tot_conf += cf
        if c == 0:
            continue
        per_family[fam] = {
            "candidates": c, "confirmed": cf,
            "false_candidate_rate": round((c - cf) / c, 4),
        }
    health = rs.health()
    out = {
        "version": rs.version,
        "requests": rs.requests,
        "false_candidate_rate":
            round((tot_cand - tot_conf) / tot_cand, 4) if tot_cand
            else None,
        "per_family": per_family,
        "runtime_dead":
            [d["rule_id"] for d in health["runtime_dead"]],
        "latent_dead":
            [d["rule_id"] for d in health["latent_dead"]],
    }
    out.update(device_efficiency(pipeline.stats))
    return out
