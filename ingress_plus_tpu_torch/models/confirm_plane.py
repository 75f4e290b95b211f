"""Confirm plane: the exact per-request candidate walk.

The subset of ``ingress_plus_tpu/models/confirm_plane.py`` this package
runs: :func:`confirm_one`, the pure per-request walk (candidates in,
confirmed rules + detail points out), the per-cycle flood memo
(:class:`ConfirmMemo`, keyed on ``(rule, stream-bytes digest)``), and the
inline launch/join that runs the walk serially on the calling thread.
The worker pool and the cross-cycle verdict cache are not ported.

Confirm is host work: it runs on the CPU whatever device scanned.
"""

from __future__ import annotations

import time
from hashlib import blake2b
from typing import Dict, List, Optional

import numpy as np


class ConfirmResult:
    """One request's confirm outcome — everything the single-threaded
    fold needs, nothing shared: ``confirmed`` (rule indices, walk
    order), ``points`` (attack-export match details, capped at 8),
    ``excluded`` (the runtime-ctl exclusion mask applied, for the
    telemetry fold), ``detection_only`` (a matched
    ctl:ruleEngine=DetectionOnly), and the per-rule cost samples
    ``rule_idx``/``rule_ns`` (RuleStats confirm-cost telemetry)."""

    __slots__ = ("confirmed", "points", "excluded", "detection_only",
                 "rule_idx", "rule_ns")

    def __init__(self) -> None:
        self.confirmed: List[int] = []
        self.points: List[dict] = []
        self.excluded: Optional[np.ndarray] = None
        self.detection_only = False
        self.rule_idx: List[int] = []
        self.rule_ns: List[int] = []


class ConfirmMemo:
    """Bounded per-cycle confirm memo keyed ``(rule_index, digest)``.

    The digest is a 16-byte blake2b over the request's confirm streams
    (key, length, bytes — unambiguous framing), computed at most once
    per request: identical streams ⇒ identical parse, identical
    transform outputs, identical operator outcome, identical detail
    points.  Bounded by refusing inserts at capacity (``suppressed``
    counts) — eviction would thrash on exactly the high-cardinality
    traffic the bound exists for, and a flood's working set is small by
    definition.  Counter races between confirm workers are tolerated
    (telemetry-grade; the dict ops themselves are GIL-atomic, and a
    duplicated compute stores the identical value)."""

    __slots__ = ("cap", "hits", "misses", "suppressed", "_d", "_seen")

    def __init__(self, cap: int = 4096) -> None:
        self.cap = int(cap)
        self.hits = 0
        self.misses = 0
        self.suppressed = 0
        self._d: Dict[tuple, tuple] = {}
        self._seen: set = set()

    def __len__(self) -> int:
        return len(self._d)

    def see(self, digest: bytes) -> bool:
        """Record one request digest; True when it was already seen
        this cycle.  Per-rule entries engage only from a digest's
        SECOND occurrence on — unique traffic pays one digest + one
        set op per request and ZERO per-rule memo round-trips
        (measured at ~9% of confirm before this gate), while a flood
        of N identical requests walks twice and hits N-2 times."""
        if digest in self._seen:
            return True
        if len(self._seen) < self.cap:
            # concheck: ok GIL-atomic set.add; a lost add just costs one duplicate confirm walk
            self._seen.add(digest)
        return False

    def get(self, key: tuple) -> Optional[tuple]:
        v = self._d.get(key)
        if v is not None:
            self.hits += 1  # concheck: ok telemetry-grade counter race
        return v

    def put(self, key: tuple, value: tuple) -> None:
        if len(self._d) < self.cap:
            self.misses += 1  # concheck: ok telemetry-grade counter race
            # concheck: ok GIL-atomic dict store; racers store the identical value for the key
            self._d[key] = value
        else:
            self.suppressed += 1  # concheck: ok telemetry-grade counter race


def streams_digest(streams: Dict[str, bytes]) -> bytes:
    """Content digest of one request's confirm streams (sorted keys,
    length-framed values — no concatenation ambiguity)."""
    h = blake2b(digest_size=16)
    for k in sorted(streams):
        v = streams[k]
        h.update(k.encode())
        h.update(b"\x00")
        h.update(len(v).to_bytes(4, "big"))
        h.update(v)
    return h.digest()


def confirm_one(pl, req, hit_row: np.ndarray,
                memo: Optional[ConfirmMemo] = None) -> ConfirmResult:
    """The pure per-request confirm walk — the loop body of the old
    serial ``finalize``, minus every piece of shared state.  ``pl`` is
    the owning DetectionPipeline, read-only here (confirms, ctl_rules,
    ruleset — all immutable between swaps, and in-flight cycles pin
    their generation).  Verdict-affecting inputs beyond ``hit_row`` are
    all inside ``req.confirm_streams()`` — which is exactly why the
    memo can key on its digest."""
    res = ConfirmResult()
    hit_rules = np.nonzero(hit_row)[0]
    streams = req.confirm_streams() if len(hit_rules) else {}
    cache: Dict = {}   # per-request transform/collection memo across rules
    # pass 1 — runtime ctl exclusions: a matched exclusion rule
    # (ctl:ruleRemoveById / ruleRemoveTargetById / ruleEngine=Off)
    # removes rules or target subfields for THIS request before
    # detection rules are confirmed (ModSecurity's request-scoped ctl
    # semantics, resolved statically — compiler/ruleset.py _resolve_ctls)
    excluded = None          # (R,) bool or None
    extra_excl: Dict = {}    # rule index → {kind: {selector}}
    for ci, remove_mask, target_excl, engine in pl.ctl_rules:
        if not hit_row[ci]:
            continue
        if not pl.confirms[ci].matches_streams(streams, cache):
            continue
        if engine == "off":
            excluded = np.ones(hit_row.shape[0], dtype=bool)
            break
        if engine == "detection_only":
            res.detection_only = True
        if remove_mask.any():
            excluded = (remove_mask if excluded is None
                        else excluded | remove_mask)
        for idx, excl_map in target_excl.items():
            merged = extra_excl.setdefault(idx, {})
            for kind, sels in excl_map.items():
                merged.setdefault(kind, set()).update(sels)
    res.excluded = excluded
    confirms = pl.confirms
    rule_ids = pl.ruleset.rule_ids
    points = res.points
    confirmed = res.confirmed
    ctl_pass = pl._ctl_pass_idx
    rule_idx = res.rule_idx
    rule_ns = res.rule_ns
    use_memo = False
    digest = b""
    if memo is not None and len(hit_rules):
        # one digest + one seen-set op per request; per-rule memo
        # round-trips engage only from a digest's second occurrence
        # (ConfirmMemo.see) — unique traffic skips them entirely
        digest = streams_digest(streams)
        use_memo = memo.see(digest)
    cache_get = cache.get
    for r in hit_rules.tolist():
        if r in ctl_pass:
            continue   # config machinery, never a detection hit
        if excluded is not None and excluded[r]:
            continue
        cr = confirms[r]
        if cr._qr_rule_ok and r not in extra_excl:
            # whole-rule literal quick-reject, inlined (this loop runs
            # per candidate — the method-call form measurably slowed the
            # hot path): no mandatory literal in the shared haystack ⇒
            # the exact walk would return False for every value.  No
            # memo traffic and no cost sample either — a rejected walk
            # costs ~nothing by construction, and the confirm-cost
            # telemetry exists to rank the EXPENSIVE rules.
            hay = cache_get(("#qrh", cr._plan_sig, cr._tkey))
            if hay is None:
                hay = cr._build_qr_hay(streams, cache)
            for lit in cr.qr_literals:
                if lit in hay:
                    break
            else:
                cr.qr_skips += 1
                continue
        det: tuple | list
        tr0 = time.perf_counter_ns()
        if use_memo and r not in extra_excl:
            # flood memo: the outcome for (rule, streams) is pure —
            # per-request ctl target exclusions (extra_excl) are the
            # one request-scoped input, so those rules bypass the memo
            key = (r, digest)
            cached = memo.get(key)
            if cached is not None:
                hit, det = cached
            else:
                dl: list = []
                # detail is ALWAYS collected on the memoized path (a
                # later request may still have point budget when this
                # one's is spent); the points cap is applied below, so
                # the exported matches are byte-identical either way
                hit = cr.matches_streams(streams, cache, None,
                                         detail_out=dl)
                det = tuple(dl)
                memo.put(key, (hit, det))
        else:
            dl = []
            hit = cr.matches_streams(
                streams, cache, extra_excl.get(r),
                detail_out=dl if len(points) < 8 else None)
            det = dl
        rule_idx.append(r)
        rule_ns.append(time.perf_counter_ns() - tr0)
        if hit:
            confirmed.append(r)
            if det and len(points) < 8:
                points.append({"rule_id": int(rule_ids[r]),
                               "var": det[0][0],
                               "value": det[0][1]})
    return res


class ConfirmJob:
    """One finalize batch's confirm phase: launched by
    ``Pipeline.finalize_launch``, joined by ``Pipeline.finalize_join``."""

    __slots__ = ("requests", "rule_hits", "results", "memo", "launch_us")

    def __init__(self, requests, rule_hits) -> None:
        self.requests = requests
        self.rule_hits = rule_hits
        self.results: List[Optional[ConfirmResult]] = [None] * len(requests)
        self.memo: Optional[ConfirmMemo] = None
        self.launch_us = 0


def launch_confirm(pl, requests, rule_hits: np.ndarray) -> ConfirmJob:
    """Run one finalize batch's confirm walk inline, request by request,
    with a per-cycle flood memo when the batch has more than one
    request and ``pl.confirm_memo_entries`` is non-zero."""
    job = ConfirmJob(requests, rule_hits)
    cap = getattr(pl, "confirm_memo_entries", 0)
    if cap and len(requests) > 1:
        job.memo = ConfirmMemo(cap)
    t0 = time.perf_counter()
    for qi, req in enumerate(requests):
        job.results[qi] = confirm_one(pl, req, rule_hits[qi], job.memo)
    job.launch_us = int((time.perf_counter() - t0) * 1e6)
    return job


def join_confirm(pl, job: ConfirmJob) -> List[Optional[ConfirmResult]]:
    """The inline walk has already run: the results are complete."""
    return job.results
