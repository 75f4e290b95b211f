"""Overlap attribution over the cycle flight recorder's event stream
(docs/OBSERVABILITY.md "Cycle flight recorder").

The serve plane's throughput claims are structural: the mesh loop says
host prep and device scan overlap (double-buffered transfer), and the
pooled confirm says cycle N's confirm overlaps cycle N+1's scan.  This
module MEASURES both from the recorded timeline:

* ``scan↔confirm overlap fraction`` — the share of confirm wall time
  during which some device scan was simultaneously busy (the pooled-confirm
  claim, measured);
* ``per-lane idle-gap share`` — 1 − device-busy / measurement window
  per lane (where the cards wait on the host);
* ``drain occupancy`` — the dispatch thread's share of the window spent
  in the double-buffer drain wait (the mesh loop's overlap window: high under
  load means the host keeps up, ~0 means the dispatch thread never
  waits — i.e. the host is the bottleneck);
* ``critical-path stage per cycle`` — the longest stage of each cycle,
  ranked over the window;
* ``serialized residue`` — per thread, the time it was the ONLY active
  thread (exclusive busy), as a share of all-active time: the thread
  with the largest share is what bounds throughput (the next thing to overlap).

Everything here is plain interval arithmetic over the snapshot; no torch,
no numpy — cheap enough for /healthz.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ingress_plus_tpu_torch.utils.trace import (
    EV_COLLECT,
    EV_CONFIRM,
    EV_CYCLE,
    EV_DEVICE,
    EV_DRAIN,
    EV_FINALIZE,
    EV_LAUNCH,
    EV_MIRROR,
    EV_OVERSIZED,
    EV_PREP,
    EV_SHADOW,
    EV_STREAM,
    EVENT_NAMES,
    match_spans,
)

#: codes that count as "busy" for a thread (instants are markers;
#: CYCLE/DRAIN bracket the dispatch thread's whole loop — DRAIN is the
#: wait window, CYCLE the envelope; EV_COLLECT is the dispatch thread
#: BLOCKED on a lane's scan result — the device's EV_DEVICE carries the
#: real work, so collect booking as dispatch busy would make the
#: dispatch thread look like the bound whenever a card is slow)
_BUSY_CODES = frozenset({
    EV_PREP, EV_LAUNCH, EV_DEVICE, EV_CONFIRM, EV_FINALIZE,
    EV_MIRROR, EV_STREAM, EV_OVERSIZED, EV_SHADOW,
})

#: the per-cycle stages the critical-path ranking compares
_STAGE_CODES = (EV_PREP, EV_LAUNCH, EV_DEVICE, EV_COLLECT, EV_CONFIRM,
                EV_FINALIZE, EV_MIRROR, EV_STREAM)


def spans_from_events(snapshot: dict) -> List[dict]:
    """Span dicts ``{tid, root, code, name, tag, cycle, t0_ns, t1_ns}``
    from the snapshot's events — the pair matching itself is
    ``trace.match_spans`` (ONE fold shared with the Perfetto exporter,
    keyed on cycle so the mesh double buffer's interleaved envelopes
    pair correctly)."""
    roots = {t["tid"]: t["root"] for t in snapshot.get("threads", ())}
    return [{"tid": tid, "root": roots.get(tid, "?"), "code": code,
             "name": EVENT_NAMES.get(code, str(code)), "tag": tag,
             "cycle": cyc, "arg": arg, "t0_ns": t0, "t1_ns": t1}
            for tid, code, cyc, tag, arg, t0, t1 in
            match_spans(snapshot.get("events", ()))]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of [t0, t1) intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for t0, t1 in intervals[1:]:
        if t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _total(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in intervals)


def _intersect(a: Sequence[Tuple[int, int]],
               b: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Intersection of two MERGED interval lists."""
    out: List[Tuple[int, int]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_report(snapshot: dict,
                   confirm_workers: Optional[int] = None,
                   n_lanes: Optional[int] = None) -> Optional[dict]:
    """The measured overlap report for one snapshot window.  Returns
    None when the window carries no cycle spans at all (recorder off or
    no traffic) — callers treat None as a LOUD diagnostic condition,
    the stage_breakdown convention."""
    spans = spans_from_events(snapshot)
    cycles = [s for s in spans if s["code"] == EV_CYCLE]
    if not cycles:
        return None
    # the measurement window is bounded by CYCLE-ATTRIBUTED spans
    # (cycle id > 0): cycle-0 events — idle drains, side lanes, the
    # exporter tick — keep recording while the box sits idle, and an
    # unclipped window would dilute drain_occupancy / lane_idle_share
    # with idle time the 'last N cycles' never contained.  Cycle-0 intervals are INTERSECTED with the window below.
    attributed = [s for s in spans if s["cycle"] > 0]
    w0 = min(s["t0_ns"] for s in attributed)
    w1 = max(s["t1_ns"] for s in attributed)
    window_ns = max(w1 - w0, 1)
    window = [(w0, w1)]

    # --- scan ↔ confirm overlap (the pooled-confirm claim, measured): fraction
    # of confirm wall time with a device scan simultaneously busy
    # (window-clipped: warmup/side-lane scans carry cycle 0)
    scan_iv = _intersect(_merge(
        [(s["t0_ns"], s["t1_ns"]) for s in spans
         if s["code"] == EV_DEVICE]), window)
    confirm_iv = _intersect(_merge(
        [(s["t0_ns"], s["t1_ns"]) for s in spans
         if s["code"] == EV_CONFIRM]), window)
    confirm_ns = _total(confirm_iv)
    scan_ns = _total(scan_iv)
    overlap_ns = _total(_intersect(scan_iv, confirm_iv))
    scan_confirm_overlap = (round(overlap_ns / confirm_ns, 4)
                            if confirm_ns else None)

    # --- per-lane idle-gap share over the window (tag = lane index;
    # -1 = host threads with no lane).  Lanes that recorded NO device
    # span in the window are backfilled at idle 1.0 — a wedged or
    # starved lane is exactly the one the operator must see, not a
    # missing key
    lane_busy: Dict[int, List[Tuple[int, int]]] = {}
    for s in spans:
        if s["code"] == EV_DEVICE:
            lane_busy.setdefault(s["tag"], []).append(
                (s["t0_ns"], s["t1_ns"]))
    for lane in range(n_lanes or 0):
        lane_busy.setdefault(lane, [])
    lane_idle = {str(lane):
                 round(1.0 - _total(_intersect(_merge(iv), window))
                       / window_ns, 4)
                 for lane, iv in sorted(lane_busy.items())}

    # --- double-buffer drain occupancy: the dispatch thread's share of
    # the window spent waiting in the interleaved drain (the mesh loop's overlap
    # window — this is where host time hides while cards crunch).
    # Clipped to the window: drains are cycle-0 spans.
    drain_iv = _intersect(_merge(
        [(s["t0_ns"], s["t1_ns"]) for s in spans
         if s["code"] == EV_DRAIN]), window)
    drain_occupancy = round(_total(drain_iv) / window_ns, 4)

    # --- critical-path stage per cycle: the stage with the largest
    # total duration inside each cycle, ranked over the window
    by_cycle: Dict[int, Dict[int, int]] = {}
    for s in spans:
        if s["code"] in _STAGE_CODES and s["cycle"] > 0:
            d = by_cycle.setdefault(s["cycle"], {})
            d[s["code"]] = d.get(s["code"], 0) + (s["t1_ns"] - s["t0_ns"])
    crit_counts: Dict[str, int] = {}
    for _cid, stages in by_cycle.items():
        if not stages:
            continue
        code = max(stages, key=lambda c: stages[c])
        name = EVENT_NAMES[code]
        crit_counts[name] = crit_counts.get(name, 0) + 1
    critical_path = dict(sorted(crit_counts.items(),
                                key=lambda kv: -kv[1]))

    # --- per-STAGE busy/exclusive shares: the stage-level
    # twin of the thread residue ranking below.  Threads conflate work
    # kinds (the dispatch thread preps AND launches; a lane worker's
    # span is the card), so "is host prep what bounds the pipeline" is
    # answered here: host_prep ranking above device_scan in exclusive
    # busy is exactly the condition the raw-byte device path
    # (scan_impl pallas3) exists to remove — check_claims() warns on it
    stage_iv: Dict[str, List[Tuple[int, int]]] = {}
    for code, name in ((EV_PREP, "host_prep"),
                       (EV_DEVICE, "device_scan"),
                       (EV_CONFIRM, "confirm"),
                       (EV_FINALIZE, "finalize"),
                       (EV_LAUNCH, "lane_launch")):
        stage_iv[name] = _intersect(_merge(
            [(s["t0_ns"], s["t1_ns"]) for s in spans
             if s["code"] == code]), window)
    any_stage_ns = _total(_merge(
        [x for iv in stage_iv.values() for x in iv])) or 1
    stage_shares = {}
    for name, iv in stage_iv.items():
        others = _merge([x for n2, iv2 in stage_iv.items()
                         if n2 != name for x in iv2])
        busy = _total(iv)
        exclusive = busy - _total(_intersect(iv, others))
        stage_shares[name] = {
            "busy_share": round(busy / any_stage_ns, 4),
            "exclusive_share": round(exclusive / any_stage_ns, 4),
        }

    # --- serialized residue: per thread, busy-time union and the share
    # of it during which NO other thread was busy.  The all-active
    # union is the denominator so the ranking answers "who bounds
    # throughput", not "who exists".
    per_thread: Dict[int, List[Tuple[int, int]]] = {}
    for s in spans:
        if s["code"] in _BUSY_CODES:
            per_thread.setdefault(s["tid"], []).append(
                (s["t0_ns"], s["t1_ns"]))
    # clip to the window too: side-plane busy (oversized, shadow,
    # exporter — cycle-0 spans) outside the cycle window must not
    # enter the residue ranking's denominator
    merged = {tid: _intersect(_merge(iv), window)
              for tid, iv in per_thread.items()}
    merged = {tid: iv for tid, iv in merged.items() if iv}
    any_busy = _merge([iv for lst in merged.values() for iv in lst])
    any_busy_ns = _total(any_busy) or 1
    roots = {t["tid"]: "%s/%s" % (t["root"], t["tid"])
             for t in snapshot.get("threads", ())}
    residue = []
    for tid, iv in merged.items():
        others = _merge([x for otid, lst in merged.items()
                         if otid != tid for x in lst])
        busy = _total(iv)
        exclusive = busy - _total(_intersect(iv, others))
        residue.append({
            "thread": roots.get(tid, str(tid)),
            "busy_share": round(busy / any_busy_ns, 4),
            "exclusive_share": round(exclusive / any_busy_ns, 4),
        })
    residue.sort(key=lambda r: -r["exclusive_share"])

    return {
        "cycles": len(cycles),
        "window_ms": round(window_ns / 1e6, 3),
        "scan_confirm_overlap": scan_confirm_overlap,
        "scan_busy_ms": round(scan_ns / 1e6, 3),
        "confirm_busy_ms": round(confirm_ns / 1e6, 3),
        "lane_idle_share": lane_idle,
        "drain_occupancy": drain_occupancy,
        "stage_shares": stage_shares,
        "critical_path": critical_path,
        "serialized_residue": residue[:8],
        "dropped_events": snapshot.get("dropped", 0),
        "confirm_workers": confirm_workers,
        "n_lanes": n_lanes,
    }


def collect(batcher, cycles: Optional[int] = None) -> Optional[dict]:
    """The ONE collection entry (/healthz and any measurement harness
    call this — inline copies would drift): snapshot the process recorder
    and compute the report with the batcher's pool/lane geometry.
    None when the recorder is off, captured nothing, or raised —
    observability must never break the caller."""
    from ingress_plus_tpu_torch.utils.trace import flight

    if not flight.enabled:
        return None
    try:
        return overlap_report(
            flight.snapshot(cycles=cycles),
            confirm_workers=batcher.pipeline.confirm_pool.n_workers,
            n_lanes=batcher.lanes.n)
    except Exception:
        return None


def brief(report: Optional[dict]) -> Optional[dict]:
    """The compact /healthz face of the report."""
    if report is None:
        return None
    top = report["serialized_residue"][:1]
    ss = report.get("stage_shares") or {}
    return {
        "cycles": report["cycles"],
        "scan_confirm_overlap": report["scan_confirm_overlap"],
        "drain_occupancy": report["drain_occupancy"],
        "critical_path": report["critical_path"],
        "bounding_thread": (top[0] if top else None),
        # the host-prep-vs-device ranking at a glance — the
        # raw-byte offload is judged by host_prep staying BELOW device
        "host_prep_exclusive": (ss.get("host_prep") or {})
        .get("exclusive_share"),
        "device_scan_exclusive": (ss.get("device_scan") or {})
        .get("exclusive_share"),
        "dropped_events": report["dropped_events"],
    }


def check_claims(report: Optional[dict]) -> List[str]:
    """The LOUD-warning conditions bench.py prints: the measured
    timeline contradicting the overlap design claims, or a single thread
    bounding the pipeline.  Returns human-readable warning strings
    (empty = structure as designed)."""
    if report is None:
        return ["pipeline_overlap MISSING: the flight recorder captured "
                "no cycle spans (recorder disabled or no traffic?)"]
    out = []
    workers = report.get("confirm_workers")
    lanes = report.get("n_lanes")
    ov = report.get("scan_confirm_overlap")
    if (workers or 0) > 1 and (lanes or 0) > 1 and ov is not None \
            and ov < 0.05 and report["cycles"] >= 8:
        out.append(
            "measured scan<->confirm overlap is %.1f%% with "
            "--confirm-workers %d — the overlapped-confirm design "
            "is NOT overlapping on this host" % (ov * 100, workers))
    for r in report.get("serialized_residue", ())[:1]:
        if r["exclusive_share"] > 0.60:
            out.append(
                "thread %s holds %.0f%% of the critical path "
                "(exclusive busy) — it bounds pipeline throughput; "
                "the overlap machinery cannot help until this thread's "
                "work shrinks or moves" % (r["thread"],
                                           r["exclusive_share"] * 100))
    # host-prep-above-the-device-lanes check: the measured
    # stage shares contradicting the raw-byte offload design — host
    # normalize/merge time exceeding the device scan's exclusive busy
    # means the host, not the cards, bounds the pipeline
    ss = report.get("stage_shares") or {}
    hp, dv = ss.get("host_prep"), ss.get("device_scan")
    if (hp and dv and hp["exclusive_share"] > 0.05
            and hp["exclusive_share"] > dv["exclusive_share"]):
        out.append(
            "host_prep ranks ABOVE the device lanes (%.0f%% exclusive "
            "busy vs device_scan's %.0f%%) — host prep bounds the "
            "pipeline; the raw-byte device path (scan_impl pallas3, "
            "docs/SCAN_KERNEL.md 'Device path') should be absorbing "
            "this work" % (hp["exclusive_share"] * 100,
                           dv["exclusive_share"] * 100))
    return out
