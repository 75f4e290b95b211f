"""Parallel confirm plane (docs/CONFIRM_PLANE.md).

The device scan is pack-size-invariant and shards across per-device
lanes, which leaves the serial CPU confirm loop in
``Pipeline.finalize`` as the serialized residue that bounds serve
throughput.  This module removes confirm from the critical path three
ways, all verdict-preserving:

1. **Sharded confirm workers** — :func:`confirm_one` is the pure
   per-request candidate walk (no shared mutable state: candidates in,
   confirmed rules + detail points out), so a :class:`ConfirmPool` can
   run request shares on N workers concurrently while the
   single-threaded fold (telemetry, scoring, ACL, Verdict assembly)
   stays in ``Pipeline.finalize_join``.  A wedged worker fails only ITS
   request share open within the pool's hang budget — the worker is
   abandoned and replaced exactly like a wedged device lane
   (serve/lanes.py), siblings' verdicts are untouched.
2. **Mandatory-literal quick-reject** — lives in models/confirm.py
   (``ConfirmRule.qr_literals``): a C-level ``literal in value`` check
   in front of every ``re.search``, derived from the same
   mandatory-factor machinery the prefilter soundness audit uses.
3. **Flood memoization** — :class:`ConfirmMemo`, a bounded per-cycle
   memo keyed on ``(rule, stream-bytes digest)``: replayed floods and
   templated scanners send near-identical segments, so the confirm
   outcome for an identical (rule, streams) pair is reused across
   requests within one cycle.  Per-request ctl target exclusions
   (``extra_excl``) bypass the memo entirely — their outcome is not a
   pure function of (rule, streams).

The parallel-firewall literature (PAPERS.md: GPU parallel firewalls,
arXiv:1312.4188; the Hyperflex prefilter/verify split, 2512.07123) says
the same thing twice: keep the cheap vectorized stage wide AND make the
exact verification stage both parallel and rarely-invoked.

Confirm is host work: it runs on the CPU whatever device scanned, on
numpy rule hits and request bytes, and never touches a CUDA tensor.  The
workers are threads, so pure-Python walks share the interpreter lock.
"""

from __future__ import annotations

import time
from hashlib import blake2b
from typing import Dict, List, Optional, Tuple

import numpy as np

from ingress_plus_tpu_torch.models.confirm import LONG_TRANSFORM_KEY
from ingress_plus_tpu_torch.serve.lanes import DeviceHang, LaneWorker
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.trace import EV_CONFIRM, flight


class ConfirmResult:
    """One request's confirm outcome — everything the single-threaded
    fold needs, nothing shared: ``confirmed`` (rule indices, walk
    order), ``points`` (attack-export match details, capped at 8),
    ``excluded`` (the runtime-ctl exclusion mask applied, for the
    telemetry fold), ``detection_only`` (a matched
    ctl:ruleEngine=DetectionOnly), the per-rule cost samples
    ``rule_idx``/``rule_ns`` (RuleStats confirm-cost telemetry), and
    the nanoseconds and input bytes of the transform chains applied to
    long values, ``long_transform_ns``/``long_transform_bytes``
    (PipelineStats, /metrics ipt_confirm_long_transform_*)."""

    __slots__ = ("confirmed", "points", "excluded", "detection_only",
                 "rule_idx", "rule_ns", "long_transform_ns",
                 "long_transform_bytes")

    def __init__(self) -> None:
        self.confirmed: List[int] = []
        self.points: List[dict] = []
        self.excluded: Optional[np.ndarray] = None
        self.detection_only = False
        self.rule_idx: List[int] = []
        self.rule_ns: List[int] = []
        self.long_transform_ns = 0
        self.long_transform_bytes = 0


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


class VerdictCache:
    """Bounded CROSS-cycle confirm cache keyed ``(generation,
    rule_index, digest)`` — the promotion of :class:`ConfirmMemo` from
    per-batch to per-process (docs/RETUNE.md).

    Soundness is the memo's second-occurrence argument with the
    generation folded into the key: within one generation the confirm
    closures, ctl resolution, and rule-row order are immutable (a swap
    installs a NEW generation tag), so the outcome for (generation,
    rule, streams-digest) is a pure function and may be replayed across
    batches.  Per-request ctl target exclusions still bypass the cache
    entirely (confirm_one's ``extra_excl`` gate — unchanged).  Swap /
    rollout boundaries call :meth:`invalidate`; that is HYGIENE (the
    old generation's entries are unreachable dead weight), never a
    soundness requirement.

    Unlike the memo, capacity EVICTS oldest-first instead of refusing
    inserts: a long-running cache must follow the traffic mix as it
    drifts.  All dict/counter races are GIL-atomic / telemetry-grade,
    same discipline as ConfirmMemo; ``invalidate`` REBINDS fresh dicts
    (atomic swap) so racing readers see either generation's view,
    both sound."""

    __slots__ = ("cap", "hits", "misses", "suppressed", "evicted",
                 "invalidations", "_d", "_seen")

    def __init__(self, cap: int = 65536) -> None:
        self.cap = max(1, int(cap))
        self.hits = 0
        self.misses = 0
        self.suppressed = 0
        self.evicted = 0
        self.invalidations = 0
        self._d: Dict[tuple, tuple] = {}
        # (generation, digest) → True, insertion-ordered: the cross-
        # cycle second-occurrence gate (a flood recurring every batch
        # digests once per request but walks confirm only once total)
        self._seen: Dict[tuple, bool] = {}

    def __len__(self) -> int:
        return len(self._d)

    def see(self, key: tuple) -> bool:
        if key in self._seen:
            return True
        if len(self._seen) >= self.cap:
            try:
                # concheck: ok oldest-first eviction; a racing del costs one retried insert
                del self._seen[next(iter(self._seen))]
            except (KeyError, StopIteration, RuntimeError):
                pass
        self._seen[key] = True  # concheck: ok GIL-atomic dict store
        return False

    def get(self, key: tuple) -> Optional[tuple]:
        v = self._d.get(key)
        if v is not None:
            self.hits += 1  # concheck: ok telemetry-grade counter race
        return v

    def put(self, key: tuple, value: tuple) -> None:
        if len(self._d) >= self.cap:
            try:
                # concheck: ok oldest-first eviction under the GIL
                del self._d[next(iter(self._d))]
                self.evicted += 1
            except (KeyError, StopIteration, RuntimeError):
                self.suppressed += 1
                return
        self.misses += 1  # concheck: ok telemetry-grade counter race
        # concheck: ok GIL-atomic dict store; racers store the identical value for the key
        self._d[key] = value

    def invalidate(self, reason: str = "") -> None:
        """Drop every entry (swap / promote / rollback hygiene).  The
        rebind is one GIL-atomic store per dict, so in-flight views
        keep reading a consistent (old or new) snapshot."""
        self._d = {}
        self._seen = {}
        self.invalidations += 1

    def view(self, generation: str) -> "_CycleView":
        """Per-finalize-batch adapter speaking ConfirmMemo's interface
        with this pipeline generation folded into every key — the
        confirm walk (confirm_one) and the stats fold (finalize_join's
        per-job hit/miss deltas) run unchanged."""
        return _CycleView(self, generation)

    def snapshot(self) -> dict:
        return {"entries": len(self._d), "cap": self.cap,
                "hits": self.hits, "misses": self.misses,
                "suppressed": self.suppressed, "evicted": self.evicted,
                "invalidations": self.invalidations}


class _CycleView(ConfirmMemo):
    """One batch's handle on the shared VerdictCache: delegates storage
    to the cache (generation-prefixed keys) while keeping its OWN
    hit/miss counters, which finalize_join folds as per-batch deltas —
    exactly what it did with a per-cycle ConfirmMemo."""

    __slots__ = ("cache", "gen")

    def __init__(self, cache: VerdictCache, generation: str) -> None:
        super().__init__(cap=cache.cap)
        self.cache = cache
        self.gen = generation

    def see(self, digest: bytes) -> bool:
        return self.cache.see((self.gen, digest))

    def get(self, key: tuple) -> Optional[tuple]:
        r, digest = key
        v = self.cache.get((self.gen, r, digest))
        if v is not None:
            self.hits += 1  # concheck: ok telemetry-grade counter race
        return v

    def put(self, key: tuple, value: tuple) -> None:
        r, digest = key
        self.misses += 1  # concheck: ok telemetry-grade counter race
        self.cache.put((self.gen, r, digest), value)


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
    book = cache_get(LONG_TRANSFORM_KEY)
    if book is not None:
        res.long_transform_ns, res.long_transform_bytes = book
    return res


class _ConfirmWorker(LaneWorker):
    """One confirm worker thread: LaneWorker's bounded-call machinery
    (submit/wait/abandon) with confirm-plane fault attribution —
    ``slow_confirm:worker=K`` plans target exactly one of these."""

    def __init__(self, seq: int, worker_index: int):
        self.worker_index = worker_index
        super().__init__(seq=seq, lane_index=None, name="ipt-confirm")

    def _setup(self) -> None:
        faults.set_current_confirm_worker(self.worker_index)
        flight.register_thread("confirm_worker")


class ConfirmJob:
    """One finalize batch's confirm phase in flight: launched by
    ``Pipeline.finalize_launch``, joined (bounded) by
    ``Pipeline.finalize_join``.  ``results[i]`` is None until that
    request's share lands — and stays None when its worker wedged (the
    fold fails exactly those requests open)."""

    __slots__ = ("requests", "rule_hits", "results", "pending", "memo",
                 "launch_us", "launch_cpu_us")

    def __init__(self, requests, rule_hits) -> None:
        self.requests = requests
        self.rule_hits = rule_hits
        self.results: List[Optional[ConfirmResult]] = [None] * len(requests)
        #: [(worker_index, request_indices, LanePending)]
        self.pending: List[Tuple[int, List[int], object]] = []
        self.memo: Optional[ConfirmMemo] = None
        self.launch_us = 0
        #: the launch's thread CPU µs, the inline walk included
        #: (PipelineStats.confirm_cpu_us)
        self.launch_cpu_us = 0


class ConfirmPool:
    """N confirm workers behind the pipeline's finalize
    (``--confirm-workers N|auto``).  ``n_workers == 1`` runs INLINE on
    the calling thread — zero threads, zero handoff, byte-for-byte the
    pre-pool serial walk (the <3% clean-path budget is enforced against
    this mode).  With N > 1 each finalize batch round-robins its
    requests into N shares; the shared per-cycle memo still spans all
    shares.  The pool is ruleset-free — the batcher carries ONE pool
    across hot swaps like the stats object."""

    def __init__(self, n_workers: int = 1, hang_budget_s: float = 30.0):
        self.n_workers = max(1, int(n_workers))
        self.hang_budget_s = float(hang_budget_s)
        self.workers_replaced = 0
        self._seq = 0
        self._workers: List[_ConfirmWorker] = []
        if self.n_workers > 1:
            self._workers = [self._spawn(i) for i in range(self.n_workers)]

    @property
    def inline(self) -> bool:
        return not self._workers

    def _spawn(self, index: int) -> _ConfirmWorker:
        self._seq += 1
        return _ConfirmWorker(seq=self._seq, worker_index=index)

    def submit(self, index: int, fn):
        return self._workers[index].submit(fn)

    def replace(self, index: int) -> None:
        """Abandon a wedged worker (Python cannot kill a thread stuck
        in native code): sentinel the old queue so the zombie exits
        when/if it un-sticks, spawn a fresh worker in its slot — the
        lane-plane discipline (serve/lanes.py Lane.abandon_worker)."""
        old = self._workers[index]
        old._q.put(None)
        self._workers[index] = self._spawn(index)
        self.workers_replaced += 1

    def snapshot(self) -> dict:
        return {"workers": self.n_workers,
                "inline": self.inline,
                "hang_budget_s": self.hang_budget_s,
                "workers_replaced": self.workers_replaced}

    def close(self, timeout: float = 2.0) -> None:
        for w in self._workers:
            w.close(timeout=timeout)


def launch_confirm(pl, requests, rule_hits: np.ndarray) -> ConfirmJob:
    """Start one finalize batch's confirm phase.  Inline pool: the
    whole walk runs NOW on the calling thread (the classic serial
    path).  Pooled: request shares are submitted to the workers and the
    call returns immediately — the batcher's mesh loop overlaps the in-
    flight confirm with the next cycle's scan dispatch, the same
    software-pipelining move the mesh loop makes for host→device
    transfer."""
    job = ConfirmJob(requests, rule_hits)
    cache = getattr(pl, "confirm_cache", None)
    if cache is not None and len(requests):
        # cross-cycle verdict cache: engages even for 1-request batches
        # (the reuse is across cycles) and takes precedence over the
        # per-cycle memo — it subsumes it
        job.memo = cache.view(pl.generation_tag)
    else:
        cap = getattr(pl, "confirm_memo_entries", 0)
        if cap and len(requests) > 1:
            job.memo = ConfirmMemo(cap)
    memo = job.memo
    pool = pl.confirm_pool
    t0 = time.perf_counter()
    cpu0 = time.thread_time_ns()
    # tenant-targeted slow_confirm (docs/ROBUSTNESS.md "Tenant
    # isolation"): the per-request arrival points below exist ONLY when
    # the active plan targets a tenant — untargeted plans never reach
    # them, so their site arrival counts (and replays) are unchanged;
    # the share-level sleep_if above/below is invisible to a
    # tenant-targeted rule (no tenant stamped there).
    tt = faults.tenant_targeted("slow_confirm")
    # flight recorder: the cycle id is read on the CALLING thread (the
    # dispatch thread set it) and travels into the worker closures, so
    # a confirm share overlapping the NEXT cycle's scan still stitches
    # to the cycle whose verdicts it computes
    trace_cycle = flight.cycle()
    if pool.inline:
        # worker id 0 stamped around the inline walk so worker-targeted
        # fault plans behave identically at --confirm-workers 1
        faults.set_current_confirm_worker(0)
        flight.begin(EV_CONFIRM, cycle=trace_cycle, tag=0,
                     arg=len(requests))
        try:
            faults.sleep_if("slow_confirm")
            for qi, req in enumerate(requests):
                if tt:
                    faults.set_current_tenant(req.tenant)
                    faults.sleep_if("slow_confirm")
                job.results[qi] = confirm_one(pl, req, rule_hits[qi], memo)
        finally:
            if tt:
                faults.set_current_tenant(None)
            faults.set_current_confirm_worker(None)
            flight.end(EV_CONFIRM, cycle=trace_cycle, tag=0)
    else:
        n = pool.n_workers
        for wi in range(n):
            idxs = list(range(wi, len(requests), n))
            if not idxs:
                continue

            def _share(idxs=idxs, tt=tt, wi=wi):
                share_cpu0 = time.thread_time_ns()
                flight.set_cycle(trace_cycle)
                flight.begin(EV_CONFIRM, cycle=trace_cycle, tag=wi,
                             arg=len(idxs))
                faults.sleep_if("slow_confirm")
                out = []
                try:
                    for i in idxs:
                        if tt:
                            faults.set_current_tenant(requests[i].tenant)
                            faults.sleep_if("slow_confirm")
                        out.append((i, confirm_one(pl, requests[i],
                                                   rule_hits[i], memo)))
                finally:
                    if tt:
                        faults.set_current_tenant(None)
                    flight.end(EV_CONFIRM, cycle=trace_cycle, tag=wi)
                return out, (time.thread_time_ns() - share_cpu0) // 1000

            job.pending.append((wi, idxs, pool.submit(wi, _share)))
    job.launch_cpu_us = (time.thread_time_ns() - cpu0) // 1000
    job.launch_us = int((time.perf_counter() - t0) * 1e6)
    return job


def join_confirm(pl, job: ConfirmJob
                 ) -> Tuple[List[Optional[ConfirmResult]], int]:
    """Bounded-join the confirm shares.  ONE shared deadline for the
    whole batch (the shares launched together — k wedged workers cost
    one hang budget, not k, as in the mesh loop's lane collection).  A
    share past the deadline: its worker is abandoned and replaced, its
    requests' results stay None (the fold fails exactly those open),
    ``stats.confirm_hangs`` counts it.  A share that RAISED re-raises
    after every other share is folded — the batch-level error contract
    of the serial path, with the healthy shares' work not discarded by
    ordering.  Returns the results and the thread CPU µs of the shares
    joined."""
    if not job.pending:
        return job.results, 0
    cpu_us = 0
    deadline = time.perf_counter() + pl.confirm_pool.hang_budget_s
    err: Optional[BaseException] = None
    for wi, idxs, pending in job.pending:
        try:
            out, share_cpu_us = pending.wait(
                max(deadline - time.perf_counter(), 0.001))
        except DeviceHang:
            pl.stats.confirm_hangs += 1
            pl.confirm_pool.replace(wi)
            continue
        except Exception as e:  # noqa: BLE001 — re-raised below
            if err is None:
                err = e
            continue
        cpu_us += share_cpu_us
        for i, res in out:
            job.results[i] = res
    if err is not None:
        raise err
    return job.results, cpu_us
