"""dbg — inspection CLI for the serve loop's dynamic-config plane.

Reference: `cmd/dbg/main.go`† queries the controller's Lua unix-socket
endpoints (`/configuration/backends`, ...) to show the live dynamic
state.  Same idea against our HTTP plane:

    python -m ingress_plus_tpu_torch.control.dbg conf     [--server host:port]
    python -m ingress_plus_tpu_torch.control.dbg health
    python -m ingress_plus_tpu_torch.control.dbg metrics
    python -m ingress_plus_tpu_torch.control.dbg latency  [--sidecar host:port]
    python -m ingress_plus_tpu_torch.control.dbg tenants --set '{"1": ["attack-sqli"]}'
    python -m ingress_plus_tpu_torch.control.dbg ruleset --swap /path/artifact \
        [--paranoia 2]
    python -m ingress_plus_tpu_torch.control.dbg rulecheck [--rules path] \
        [--fail-on error]
    python -m ingress_plus_tpu_torch.control.dbg evadecheck [--rules path] \
        [--fail-on error]
    python -m ingress_plus_tpu_torch.control.dbg rules    [--server host:port]
    python -m ingress_plus_tpu_torch.control.dbg drift    [--server host:port]
    python -m ingress_plus_tpu_torch.control.dbg scoring  [--swap head.npz] [--force]
    python -m ingress_plus_tpu_torch.control.dbg breaker  [--server host:port]
    python -m ingress_plus_tpu_torch.control.dbg faults   [--set 'site:times=1']
    python -m ingress_plus_tpu_torch.control.dbg fleet    [--server host:port]

``fleet`` renders the fleet telemetry plane (docs/OBSERVABILITY.md
"Fleet telemetry") from the aggregator's ``/fleet/healthz`` +
``/fleet/slo``: the node table (up/stale, pack generation, requests,
p99, confirm share), skew findings, the merged-profile hash, and the
SLO burn-rate table.  ``--server`` points at the aggregator
(``control/fleetobs.py``, default port 9911), not a serve node.

``rules`` renders the detection-plane telemetry: top rules by
prefilter candidates with confirm outcomes and false-candidate rates
(from ``/rules/stats``), the runtime dead-rule list (``/rules/health``
— the runtime twin of ``rulecheck``), and the device-efficiency
gauges; ``drift`` renders per-rule hit-rate deltas across the most
recent hot reload (``/rules/drift``), went-quiet rules flagged.

``latency`` renders the serve plane's stage-level latency attribution:
per-stage p50/p90/p99 from the /metrics histograms plus the
/debug/slow exemplar ring as terminal tables; ``--sidecar`` adds the
native sidecar's per-upstream EWMA hop timing from its --status-port.

``tenants`` renders the tenant-isolation plane (docs/ROBUSTNESS.md
"Tenant isolation") from ``/tenants``: fair-queue depths, per-tenant
admitted/shed/degraded counters, quarantine state and the top-offender
sketch; ``--set`` still pushes a tenant→tags table to
``/configuration/tenants``.

``breaker`` renders the fail-safe serve plane (docs/ROBUSTNESS.md):
circuit-breaker state/trips, the brownout ladder rung + queue-delay
EWMA, admission queue depth and shed counters (from ``/healthz``);
``faults`` inspects — or with ``--set`` installs, ``--set ''``
clears — the deterministic fault-injection plan (``/faults``).

``rulecheck`` runs the static ruleset analyzer (analysis/ —
see docs/ANALYSIS.md) locally over a rules tree (default: the bundled
CRS tree) and renders the findings table; exit code is the
analyzer CLI's (nonzero on unsuppressed findings at/above ``--fail-on``).
``evadecheck`` does the same for the evasion-closure analyzer
(docs/ANALYSIS.md "Evasion analysis"); ``concheck`` for the
serve-plane concurrency analyzer.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def _call(server: str, path: str, payload=None, timeout: float = 10) -> str:
    url = "http://%s%s" % (server, path)
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method="POST" if data else "GET",
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()
    except urllib.error.HTTPError as e:
        # 4xx bodies are STRUCTURED reports (e.g. the rollout admission
        # gate's {stage, reason, findings}) — the operator needs them,
        # not just "HTTP Error 422"
        try:
            body = e.read().decode()
        except Exception:
            body = ""
        raise OSError("%s%s" % (e, ("\n" + body) if body.strip() else ""))


def render_latency(metrics_text: str, slow: dict,
                   sidecar: dict | None = None) -> str:
    """Terminal tables for `dbg latency` (separated from main so tests
    can drive it on real endpoint output without a TTY)."""
    from ingress_plus_tpu_torch.utils.trace import (
        STAGES, stage_breakdown_from_metrics)

    lines = []
    sb = stage_breakdown_from_metrics(metrics_text)
    if sb is None:
        lines.append("stage histograms: MISSING or malformed in /metrics"
                     " (server predates the latency-attribution layer?)")
    else:
        lines.append("%-8s %10s %12s %12s %12s"
                     % ("stage", "count", "p50_us", "p90_us", "p99_us"))
        order = [s for s in STAGES if s in sb] \
            + sorted(set(sb) - set(STAGES))
        for stage in order:
            e = sb[stage]
            lines.append("%-8s %10d %12.1f %12.1f %12.1f"
                         % (stage, e["count"], e["p50_us"], e["p90_us"],
                            e["p99_us"]))
    ex = slow.get("slowest", [])
    lines.append("")
    lines.append("slowest requests (%d retained):" % len(ex))
    # attribution dims: lane=device, wrk=confirm
    # worker, ten=fair-queue tenant, gen=ruleset generation — a slow
    # request names every plane that served it
    lines.append("%-14s %10s %9s %9s %9s %9s %4s %4s %4s %-12s %s"
                 % ("req_id", "e2e_us", "queue", "prep", "scan",
                    "confirm", "lane", "wrk", "ten", "gen", "rules"))
    for e in ex[:20]:
        b = e.get("batch", {})

        def dim(key, e=e):
            v = e.get(key)
            return "-" if v is None or v == -1 else str(v)

        lines.append("%-14s %10d %9d %9d %9d %9d %4s %4s %4s %-12s %s"
                     % (str(e.get("request_id", "?"))[:14],
                        e.get("e2e_us", 0), e.get("queue_us", 0),
                        b.get("prep_us", 0), b.get("scan_us", 0),
                        b.get("confirm_us", 0),
                        dim("lane"), dim("worker"), dim("tenant"),
                        str(e.get("generation", "-") or "-")[:12],
                        ",".join(str(r) for r in
                                 e.get("rule_ids", [])[:4]) or "-"))
    if sidecar is not None:
        lines.append("")
        lines.append("sidecar hop (per-upstream EWMA, stamped sidecar-"
                     "side): pending=%s late=%s"
                     % (sidecar.get("pending"),
                        sidecar.get("late_responses")))
        for up in sidecar.get("upstreams") or []:
            lines.append("  %-28s ewma_ms=%.3f inflight=%s"
                         % (up.get("path", "?"), up.get("ewma_ms", 0.0),
                            up.get("inflight", 0)))
    return "\n".join(lines)


def render_timeline(trace: dict, max_cycles: int = 6,
                    width: int = 48) -> str:
    """Terminal Gantt for `dbg timeline`: per cycle, one bar
    row per recorded span — thread, span name, duration, and its
    position inside the cycle's window, so the cross-thread overlap
    structure (device busy vs confirm shares vs the next drain) is
    visible without leaving the terminal.  Input is the /debug/trace
    Chrome-trace JSON (the same bytes Perfetto loads)."""
    events = trace.get("traceEvents", [])
    if not trace.get("enabled", True) and not events:
        return "flight recorder disabled (--no-flight-recorder)"
    tnames = {e["tid"]: e["args"]["name"]
              for e in events if e.get("ph") == "M"
              and e.get("name") == "thread_name"}
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "serve"]
    by_cycle: dict = {}
    for s in spans:
        cyc = (s.get("args") or {}).get("cycle", 0)
        if cyc:
            by_cycle.setdefault(cyc, []).append(s)
    if not by_cycle:
        return ("no cycles recorded yet (no traffic, or the ring "
                "evicted them)")
    lines = []
    dropped = (trace.get("otherData") or {}).get("dropped", 0)
    if dropped:
        lines.append("NOTE: %d events evicted from the ring "
                     "(--trace-ring-kb raises the cap)" % dropped)
    for cyc in sorted(by_cycle)[-max_cycles:]:
        cspans = sorted(by_cycle[cyc], key=lambda s: s["ts"])
        w0 = min(s["ts"] for s in cspans)
        w1 = max(s["ts"] + s["dur"] for s in cspans)
        span_w = max(w1 - w0, 1.0)
        env = next((s for s in cspans if s["name"] == "cycle"), None)
        lines.append("cycle %d  (%.2f ms window%s)" % (
            cyc, span_w / 1000.0,
            ", %s requests" % env["args"].get("arg")
            if env is not None and env.get("args", {}).get("arg")
            else ""))
        for s in cspans:
            tname = tnames.get(s["tid"], str(s["tid"])).split(" ")[0]
            off = int((s["ts"] - w0) / span_w * width)
            ln = max(1, int(s["dur"] / span_w * width))
            bar = "." * off + "#" * min(ln, width - off)
            bar += "." * (width - len(bar))
            tag = s.get("args", {}).get("tag", 0)
            label = s["name"]
            if s["name"] in ("lane_launch", "device_busy",
                             "lane_collect"):
                label += "[%s]" % tag
            elif s["name"] == "confirm_share":
                label += "[w%s]" % tag
            lines.append("  %-22s %-16s %9dus |%s|"
                         % (tname, label, int(s["dur"]), bar))
    return "\n".join(lines)


def render_rules(stats: dict, health: dict, top: int = 20) -> str:
    """Terminal tables for `dbg rules`: the top rules by
    prefilter candidates with their confirm outcomes, the runtime
    dead-rule list, and the device-efficiency gauges."""
    lines = []
    eff = stats.get("efficiency") or {}
    dev = stats.get("device") or {}
    lines.append("ruleset %s  requests=%d  scan_impl=%s"
                 % (stats.get("version", "?"), stats.get("requests", 0),
                    dev.get("scan_impl", "?")))
    lines.append("efficiency: pad_waste=%s dispatch_fill=%s recompiles=%s"
                 % (eff.get("padding_waste_ratio"),
                    eff.get("dispatch_fill"),
                    eff.get("engine_recompiles")))
    lines.append("")
    qr = health.get("quick_reject") or {}
    if qr:
        lines.append("quick-reject: %s/%s rx rules carry literals "
                     "(skips=%s regex_evals=%s skip_rate=%s)"
                     % (qr.get("rules_with_literals"), qr.get("rx_rules"),
                        qr.get("skips"), qr.get("regex_evals"),
                        qr.get("skip_rate")))
    lines.append("%-8s %-7s %10s %10s %8s %8s %9s %10s %9s"
                 % ("rule_id", "family", "cand", "confirmed", "errors",
                    "fc_rate", "score_sum", "confirm_us", "qr_skips"))
    for r in (stats.get("rules") or [])[:top]:
        lines.append("%-8d %-7s %10d %10d %8d %8.3f %9d %10d %9d"
                     % (r["rule_id"], r["family"], r["candidates"],
                        r["confirmed"], r["confirm_errors"],
                        r["false_candidate_rate"], r["score_sum"],
                        r.get("confirm_us", 0), r.get("quick_rejects", 0)))
    dead = health.get("runtime_dead") or []
    lines.append("")
    lines.append("runtime-dead rules (%d):" % len(dead))
    for d in dead:
        lines.append("  %d  confirm_errors=%d  %s"
                     % (d["rule_id"], d["confirm_errors"],
                        d.get("reason", "")))
    for d in health.get("latent_dead") or []:
        lines.append("  %d  LATENT (no candidates yet)  %s"
                     % (d["rule_id"], d.get("reason", "")))
    nh = health.get("never_hit") or {}
    lines.append("never-hit: %s/%s rules over %s requests"
                 % (nh.get("count"), nh.get("total_rules"),
                    health.get("requests")))
    waste = health.get("top_false_candidates") or []
    if waste:
        lines.append("")
        lines.append("top confirm-CPU waste (false candidates):")
        for w in waste[:10]:
            lines.append("  %-8d %-7s wasted=%-8d fc_rate=%.3f"
                         % (w["rule_id"], w["family"],
                            w["wasted_confirms"],
                            w["false_candidate_rate"]))
    cost = health.get("top_expensive_confirms") or []
    if cost:
        lines.append("")
        lines.append("top confirm cost (cumulative, docs/CONFIRM_PLANE.md):")
        for w in cost[:10]:
            lines.append("  %-8d %-7s confirm_us=%-9d cand=%-6d "
                         "us/cand=%s qr_skips=%d"
                         % (w["rule_id"], w["family"], w["confirm_us"],
                            w["candidates"], w.get("us_per_candidate"),
                            w.get("quick_rejects", 0)))
    return "\n".join(lines)


def render_breaker(health: dict) -> str:
    """Terminal view for `dbg breaker`: the fail-safe plane's state
    out of /healthz's robustness block."""
    rb = health.get("robustness") or {}
    if not rb:
        return ("no robustness block in /healthz "
                "(server predates the fail-safe serve plane?)")
    brk = rb.get("breaker") or {}
    lad = rb.get("ladder") or {}
    lines = [
        "breaker: %s  trips=%s closes=%s probes=%s  last_trip=%s"
        % (brk.get("state", "?"), brk.get("trips"), brk.get("closes"),
           brk.get("probes"), brk.get("last_trip_reason") or "-"),
        "  consecutive_failures=%s/%s  cooldown_s=%s"
        % (brk.get("consecutive_failures"), brk.get("failure_threshold"),
           brk.get("cooldown_s")),
        "ladder:  level=%s (%s)  queue_delay_ewma_us=%s  steps=%s up/%s "
        "down"
        % (lad.get("level"), lad.get("mode"),
           lad.get("queue_delay_ewma_us"), lad.get("steps_up"),
           lad.get("steps_down")),
        "queue:   depth=%s/%s" % (rb.get("queue_depth"),
                                  rb.get("queue_cap")),
        "fallback: hangs=%s cpu_fallback_batches=%s watchdog_released=%s"
        % (rb.get("hangs"), rb.get("cpu_fallback_batches"),
           rb.get("watchdog_released")),
        "degraded_verdicts=%s" % rb.get("degraded_verdicts"),
    ]
    shed = rb.get("shed") or {}
    lines.append("shed:    %s"
                 % (", ".join("%s=%d" % kv for kv in sorted(shed.items()))
                    or "-"))
    lanes = rb.get("lanes") or []
    if len(lanes) > 1:
        # per-device lane plane (docs/MESH_SERVING.md): one row per
        # chip — where the capacity went when a breaker above is open
        lines.append("")
        lines.append("lanes:")
        lines.append("  %-4s %-14s %-9s %5s %5s %6s %8s %7s"
                     % ("lane", "device", "breaker", "trips", "hangs",
                        "errors", "requests", "fill"))
        for ln in lanes:
            brk_l = ln.get("breaker") or {}
            fill = ln.get("dispatch_fill")
            lines.append(
                "  %-4s %-14s %-9s %5s %5s %6s %8s %7s"
                % (ln.get("lane"), ln.get("device") or "-",
                   brk_l.get("state", "?"), brk_l.get("trips"),
                   ln.get("hangs"), ln.get("errors"),
                   ln.get("requests"),
                   ("%.3f" % fill) if fill is not None else "-"))
    return "\n".join(lines)


def render_tenants(st: dict) -> str:
    """Terminal view for `dbg tenants`: the tenant-isolation plane out
    of /tenants (docs/ROBUSTNESS.md "Tenant isolation") — fair-queue
    depths, per-tenant admission counters, quarantine state, and the
    top offenders sketch."""
    q = st.get("queue") or {}
    g = st.get("guard")
    lines = [
        "queue: depth=%s/%s  tenant_cap=%s  active_tenants=%s"
        % (q.get("depth"), q.get("cap"), q.get("tenant_cap"),
           q.get("active_tenants")),
    ]
    weights = q.get("weights") or {}
    if weights:
        lines.append("weights: %s"
                     % ", ".join("%s=%s" % kv
                                 for kv in sorted(weights.items())))
    if g is None:
        lines.append("tenant guard: DISABLED (--tenant-guard off) — "
                     "fair admission still applies")
        return "\n".join(lines)
    lines.append(
        "guard: policy=%s  tracked=%s/%s  quarantined=%s  "
        "(quarantines=%s releases=%s)"
        % (g.get("policy"), g.get("tracked"), g.get("max_tracked"),
           g.get("quarantined") or "-", g.get("quarantines"),
           g.get("releases")))
    lines.append(
        "budget: share>%s of a %ss window (min %s arrivals), "
        "%s window(s) confirm, dwell %ss, depth trigger %s"
        % (g.get("max_share"), g.get("window_s"),
           g.get("min_window_arrivals"), g.get("up_confirm_windows"),
           g.get("dwell_s"), g.get("depth_trigger")))
    rows = g.get("tenants") or []
    if rows:
        lines.append("")
        lines.append("%-8s %10s %8s %9s %9s %9s  %s"
                     % ("tenant", "admitted", "shed", "degraded",
                        "rate_rps", "shed_rps", "state"))
        depths = q.get("depths") or {}
        for r in rows[:20]:
            lines.append(
                "%-8s %10d %8d %9d %9.1f %9.1f  %s"
                % (r["tenant"], r["admitted"], r["shed"], r["degraded"],
                   r.get("rate_rps", 0.0), r.get("shed_rps", 0.0),
                   ("QUARANTINED" if r.get("quarantined") else
                    "q=%s" % depths.get(str(r["tenant"]), 0))))
    top = st.get("top_offenders") or []
    if top:
        sk = st.get("sketch") or {}
        lines.append("")
        lines.append("top offenders (shed+degraded; sketch %s/%s keys):"
                     % (sk.get("tracked"), sk.get("capacity")))
        for e in top[:10]:
            lines.append("  tenant %-8s count=%-8d (max_error=%d)"
                         % (e["key"], e["count"], e["max_error"]))
    return "\n".join(lines)


def render_faults(state: dict) -> str:
    """Terminal view for `dbg faults`: the active plan + counters."""
    if not state.get("active"):
        return "no fault plan active"
    plan = state.get("plan") or {}
    lines = ["fault plan (seed=%s):" % plan.get("seed")]
    lines.append("%-16s %7s %7s %9s %6s %9s %7s"
                 % ("site", "after", "times", "delay_s", "prob",
                    "arrivals", "fired"))
    for r in plan.get("rules") or []:
        lines.append("%-16s %7d %7s %9.3f %6.2f %9d %7d"
                     % (r["site"], r["after"],
                        r["times"] if r["times"] is not None else "inf",
                        r["delay_s"], r["prob"], r["arrivals"],
                        r["fired"]))
    return "\n".join(lines)


def render_rollout(st: dict) -> str:
    """Terminal view for `dbg rollout`: the guarded-rollout state
    machine out of /rollout (docs/ROBUSTNESS.md)."""
    if not st.get("enabled", True):
        return "no rollout controller attached (library batcher?)"
    sh = st.get("shadow") or {}
    diff = st.get("diff") or {}
    lines = [
        "rollout: %s  candidate=%s  incumbent=%s"
        % (st.get("state", "?"), st.get("candidate") or "-",
           st.get("incumbent") or "-"),
        "ramp:    step %s/%s  fraction=%s  served=%s/%s this step"
        % (st.get("step"), max(len(st.get("steps") or []) - 1, 0),
           st.get("fraction"), st.get("step_served"),
           st.get("step_min_requests")),
        "shadow:  %s  mirrored=%s compared=%s dropped=%s (sample=%s)"
        % ("on" if sh.get("active") else "off", sh.get("mirrored"),
           sh.get("compared"), sh.get("dropped"), sh.get("sample")),
        "diff:    %s"
        % (", ".join("%s=%d" % kv for kv in sorted(diff.items())) or "-"),
        "canary:  requests=%s failures=%s fail_open=%s"
        % (st.get("candidate_requests"), st.get("candidate_failures"),
           st.get("candidate_fail_open")),
        "history: promotions=%s rollbacks=%s%s"
        % (st.get("promotions"), st.get("rollbacks"),
           ("  last_rollback=%s" % st["rollback_reason"])
           if st.get("rollback_reason") else ""),
    ]
    rej = st.get("swap_rejected") or {}
    lines.append("rejected: %s"
                 % (", ".join("%s=%d" % kv for kv in sorted(rej.items()))
                    or "-"))
    if st.get("lkg_dir"):
        lines.append("lkg:     %s" % st["lkg_dir"])
    for ev in (st.get("history") or [])[-6:]:
        extras = {k: v for k, v in ev.items() if k not in ("ts", "event")}
        lines.append("  event: %-14s %s"
                     % (ev.get("event"),
                        " ".join("%s=%s" % kv for kv in extras.items())))
    return "\n".join(lines)


def render_scoring(st: dict) -> str:
    """Terminal view for `dbg scoring`: the learned scoring lane out of
    /scoring (docs/LEARNED_SCORING.md) — installed head, operating
    point, and the live fixed-vs-learned divergence counters."""
    if not st.get("active"):
        lines = ["scoring: FIXED CRS weights (no learned head installed)",
                 "  anomaly_threshold=%s  generation=%s"
                 % (st.get("anomaly_threshold"), st.get("generation"))]
        return "\n".join(lines)
    head = st.get("head") or {}
    diff = st.get("diff") or {}
    lines = [
        "scoring: LEARNED head %s  (fixed threshold=%s still exported)"
        % (head.get("version", "?"), st.get("anomaly_threshold")),
        "  threshold=%s  bias=%s  rules_in_head=%s  coverage=%s"
        % (head.get("threshold"), head.get("bias"),
           head.get("rules_in_head"), head.get("coverage")),
        "  bound to ruleset %s  (generation %s)"
        % (head.get("bound_ruleset"), st.get("generation")),
        "  divergence: %s"
        % (", ".join("%s=%d" % kv for kv in sorted(diff.items())) or
           "none observed"),
    ]
    prov = head.get("provenance") or {}
    base = prov.get("baseline") or {}
    if base:
        lines.append("  trained: dataset=%s  fp %s->%s  new_fn=%s"
                     % (prov.get("dataset", "?"),
                        (base.get("fixed") or {}).get("fp"),
                        (base.get("learned") or {}).get("fp"),
                        base.get("new_fn_vs_fixed")))
    tw = head.get("top_weights") or []
    if tw:
        lines.append("  top weights: %s"
                     % ", ".join("%s=%+.3f" % (w["rule_id"], w["weight"])
                                 for w in tw[:8]))
    return "\n".join(lines)


def render_drift(drift: dict, top: int = 20) -> str:
    """Terminal table for `dbg drift`: per-rule hit-rate deltas across
    the most recent hot reload, went-quiet rules first."""
    if not drift.get("rules") and drift.get("note"):
        return drift["note"]
    lines = ["drift %s -> %s  (requests %s -> %s)"
             % (drift.get("old_version", "?"),
                drift.get("new_version", "?"),
                drift.get("old_requests"), drift.get("new_requests"))]
    quiet = drift.get("went_quiet") or []
    lines.append("went quiet after reload (%d): %s"
                 % (len(quiet),
                    ", ".join(str(r) for r in quiet[:20]) or "-"))
    lines.append("")
    lines.append("%-8s %12s %12s %12s  %s"
                 % ("rule_id", "old_rate", "new_rate", "delta", "flag"))
    for r in (drift.get("rules") or [])[:top]:
        lines.append("%-8d %12.6f %12.6f %+12.6f  %s"
                     % (r["rule_id"], r["old_hit_rate"],
                        r["new_hit_rate"], r["delta"],
                        "QUIET" if r.get("went_quiet") else ""))
    added = drift.get("added_rules") or []
    removed = drift.get("removed_rules") or []
    if added or removed:
        lines.append("")
        lines.append("pack delta: +%d rules, -%d rules"
                     % (len(added), len(removed)))
    return "\n".join(lines)


def render_fleet(health: dict, slo: dict) -> str:
    """Terminal tables for `dbg fleet`: the node table,
    skew findings, and the SLO burn-rate table from the aggregator's
    /fleet/healthz + /fleet/slo."""
    lines = ["fleet: %s  (%d up, %d stale, %d scrape cycles)"
             % (health.get("status", "?"), health.get("nodes_up", 0),
                health.get("nodes_stale", 0),
                health.get("scrape_cycles", 0)), ""]
    lines.append("%-10s %-5s %-5s %-22s %10s %10s %8s %8s"
                 % ("node", "up", "stale", "generation", "requests",
                    "p99_us", "cf_share", "scr_ms"))
    for n in health.get("nodes", []):
        lines.append(
            "%-10s %-5s %-5s %-22s %10s %10s %8s %8s"
            % (n.get("name", "?"),
               "yes" if n.get("up") else "NO",
               "yes" if n.get("stale") else "-",
               (n.get("generation") or "-")[:22],
               ("%d" % n["requests_total"])
               if n.get("requests_total") is not None else "-",
               ("%.1f" % n["p99_e2e_us"])
               if n.get("p99_e2e_us") is not None else "-",
               ("%.2f" % n["confirm_share"])
               if n.get("confirm_share") is not None else "-",
               n.get("scrape_ms", "-")))
        if n.get("error"):
            lines.append("           error: %s" % n["error"])
    findings = health.get("skew_findings", [])
    lines.append("")
    if findings:
        lines.append("skew findings (%d):" % len(findings))
        for f in findings:
            lines.append("  [%s] %s: %s"
                         % (f.get("kind", "?"), f.get("node", "?"),
                            f.get("detail", "")))
    else:
        lines.append("skew findings: none")
    prof = health.get("merged_profile") or {}
    if "content_hash" in prof:
        lines.append("merged profile: %s (%s requests, %s rules)"
                     % (prof["content_hash"], prof.get("requests"),
                        prof.get("rules")))
    else:
        lines.append("merged profile: %s"
                     % (prof.get("error") or "unavailable"))
    lines.append("")
    lines.append("%-16s %-6s %-10s %10s %12s %12s"
                 % ("slo", "window", "verdict", "objective",
                    "burn", "error_rate"))
    for name, rec in sorted((slo.get("slos") or {}).items()):
        for wname, w in sorted(rec.get("windows", {}).items()):
            lines.append(
                "%-16s %-6s %-10s %10s %12s %12s"
                % (name, wname, rec.get("verdict", "?"),
                   rec.get("objective", "-"),
                   "-" if w.get("burn") is None else w["burn"],
                   "-" if w.get("error_rate") is None
                   else w["error_rate"]))
    lines.append("")
    lines.append("fleet SLO verdict: %s" % slo.get("verdict", "?"))
    return "\n".join(lines)


def render_fleetctl(journal: dict, lkg: dict,
                    daemon_tail: list) -> str:
    """Terminal view for `dbg fleetctl`: the fleet rollout
    journal (per-node stage + ack ledger), the fleet LKG pointer, and
    the retune daemon's last cycles — all read from the shared
    --lkg-dir, so it works with the control plane down (that is the
    point: this is the view an operator reads DURING an incident)."""
    lines = []
    if journal:
        lines.append("fleet rollout: %s  (wave at node %s)"
                     % (journal.get("state", "?"),
                        journal.get("node_idx", "?")))
        lines.append("candidate: %s   incumbent: %s"
                     % (journal.get("candidate") or "-",
                        journal.get("incumbent") or "-"))
        if journal.get("rollback_reason"):
            lines.append("last rollback: %s" % journal["rollback_reason"])
        lines.append("")
        acks = journal.get("acks") or {}
        lines.append("%-10s %-10s %-22s" % ("node", "stage", "acked"))
        for i, name in enumerate(journal.get("nodes") or []):
            idx = journal.get("node_idx", 0)
            stage = ("done" if name in acks
                     else "rolling" if i == idx
                     and journal.get("state") in ("canary", "promoting")
                     else "pending")
            lines.append("%-10s %-10s %-22s"
                         % (name, stage, acks.get(name, "-")))
    else:
        lines.append("fleet rollout: no journal (no wave has run)")
    lines.append("")
    if lkg:
        lines.append("fleet LKG: %s" % lkg.get("version", "?"))
        lines.append("  artifact: %s" % lkg.get("artifact", "?"))
        for name, ver in sorted((lkg.get("acks") or {}).items()):
            lines.append("  ack %-8s %s" % (name, ver))
    else:
        lines.append("fleet LKG: none written yet")
    lines.append("")
    if daemon_tail:
        last = daemon_tail[-1]
        lines.append("retune daemon: last cycle %s  (%s)"
                     % (last.get("result", "?"),
                        last.get("detail") or last.get("drift") or ""))
        lines.append("%-6s %-24s %s" % ("cycle", "result", "detail"))
        for rec in daemon_tail:
            lines.append("%-6s %-24s %s"
                         % (rec.get("cycle", "?"),
                            rec.get("result", "?"),
                            (rec.get("detail") or "")[:48]))
    else:
        lines.append("retune daemon: no ledger (daemon has not run)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.control.dbg")
    ap.add_argument("cmd",
                    choices=["conf", "health", "metrics", "latency",
                             "tenants", "ruleset", "acl", "rulecheck",
                             "concheck", "evadecheck", "rules", "drift",
                             "breaker", "faults", "rollout", "scoring",
                             "timeline", "fleet", "fleetctl"])
    ap.add_argument("--cycles", type=int, default=6,
                    help="timeline: how many recent cycles to render "
                         "(the Gantt view of /debug/trace)")
    ap.add_argument("--server", default="127.0.0.1:9901")
    ap.add_argument("--rules", default=None,
                    help="rulecheck: rules tree to analyze (default: "
                         "the bundled CRS tree)")
    ap.add_argument("--fail-on", default="error",
                    choices=["error", "warning", "notice", "info"],
                    help="rulecheck: gate severity for the exit code")
    ap.add_argument("--set", dest="set_json", default=None,
                    help="tenants: JSON tenant→tags table to push")
    ap.add_argument("--swap", default=None,
                    help="ruleset: checkpoint artifact path to hot-swap")
    ap.add_argument("--force", action="store_true",
                    help="ruleset: break-glass one-shot swap (skip the "
                         "guarded staged rollout)")
    ap.add_argument("--abort", action="store_true",
                    help="rollout: abort an in-flight staged rollout "
                         "(rolls back to the incumbent)")
    ap.add_argument("--paranoia", type=int, default=2)
    ap.add_argument("--sidecar", default=None,
                    help="latency: also scrape the native sidecar's "
                         "--status-port JSON at this host:port")
    ap.add_argument("--lkg-dir", default=None,
                    help="fleetctl: the shared fleet LKG dir (rollout "
                         "journal + LKG pointer + daemon ledger)")
    args = ap.parse_args(argv)

    if args.cmd == "fleetctl":
        # file-plane view: reads the shared --lkg-dir directly, no
        # serve process involved (works mid-incident by design)
        import os as _os

        from ingress_plus_tpu_torch.control.fleetctl import (
            FLEET_JOURNAL, load_fleet_lkg)
        from ingress_plus_tpu_torch.control.retuned import JOURNAL_NAME

        if not args.lkg_dir:
            ap.error("fleetctl needs --lkg-dir")
        journal = None
        jpath = _os.path.join(args.lkg_dir, FLEET_JOURNAL)
        if _os.path.exists(jpath):
            with open(jpath) as f:
                journal = json.load(f)
        lkg = load_fleet_lkg(args.lkg_dir)
        tail = []
        lpath = _os.path.join(args.lkg_dir, JOURNAL_NAME)
        if _os.path.exists(lpath):
            with open(lpath) as f:
                for line in f.read().splitlines()[-12:]:
                    try:
                        tail.append(json.loads(line))
                    except ValueError:
                        continue
        print(render_fleetctl(journal, lkg, tail))
        return 0

    if args.cmd in ("rulecheck", "concheck", "evadecheck"):
        # local analysis, no serve plane involved — delegate to the
        # analyzer CLI so dbg and `python -m ingress_plus_tpu_torch.analysis`
        # render and gate identically
        from ingress_plus_tpu_torch.analysis.__main__ import main as rc_main
        rc_args = ["--fail-on", args.fail_on]
        if args.cmd == "concheck":
            rc_args.append("--conc")
        else:
            if args.cmd == "evadecheck":
                rc_args.append("--evade")
            if args.rules:
                rc_args += ["--rules", args.rules]
        return rc_main(rc_args)

    try:
        if args.cmd == "rules":
            stats = json.loads(_call(args.server, "/rules/stats?n=64"))
            rules_health = json.loads(_call(args.server, "/rules/health"))
            out = render_rules(stats, rules_health)
        elif args.cmd == "drift":
            out = render_drift(json.loads(_call(args.server,
                                                "/rules/drift")))
        elif args.cmd == "breaker":
            out = render_breaker(json.loads(_call(args.server,
                                                  "/healthz")))
        elif args.cmd == "rollout":
            if args.abort:
                out = render_rollout(json.loads(_call(
                    args.server, "/rollout", {"action": "abort"})))
            else:
                out = render_rollout(json.loads(_call(args.server,
                                                      "/rollout")))
        elif args.cmd == "scoring":
            if args.swap:
                # staged scoring-head push (the admission gate answers;
                # --force = break-glass one-shot install)
                out = _call(args.server,
                            "/configuration/scoring"
                            + ("?mode=force" if args.force else ""),
                            {"path": args.swap}, timeout=300)
            else:
                out = render_scoring(json.loads(_call(args.server,
                                                      "/scoring")))
        elif args.cmd == "faults":
            if args.set_json is not None:
                # --set 'dispatch_hang:times=1' installs; --set '' clears
                out = render_faults(json.loads(_call(
                    args.server, "/faults", {"spec": args.set_json})))
            else:
                out = render_faults(json.loads(_call(args.server,
                                                     "/faults")))
        elif args.cmd == "fleet":
            # --server here is the AGGREGATOR (control/fleetobs.py),
            # default port 9911, not a serve node
            srv = args.server
            if srv == "127.0.0.1:9901":
                srv = "127.0.0.1:9911"
            out = render_fleet(
                json.loads(_call(srv, "/fleet/healthz")),
                json.loads(_call(srv, "/fleet/slo")))
        elif args.cmd == "timeline":
            trace = json.loads(_call(
                args.server, "/debug/trace?cycles=%d"
                % max(args.cycles, 1)))
            out = render_timeline(trace, max_cycles=max(args.cycles, 1))
        elif args.cmd == "latency":
            metrics = _call(args.server, "/metrics")
            slow = json.loads(_call(args.server, "/debug/slow"))
            sidecar = None
            if args.sidecar:
                sidecar = json.loads(_call(args.sidecar, "/"))
            out = render_latency(metrics, slow, sidecar)
        elif args.cmd == "conf":
            out = _call(args.server, "/configuration")
        elif args.cmd == "health":
            out = _call(args.server, "/healthz")
        elif args.cmd == "metrics":
            out = _call(args.server, "/metrics")
        elif args.cmd == "tenants":
            if args.set_json:
                out = _call(args.server, "/configuration/tenants",
                            json.loads(args.set_json))
            else:
                # the tenant-isolation plane (fair queue + flood
                # guard), not just the mask count — /configuration
                # still carries the latter
                out = render_tenants(json.loads(_call(args.server,
                                                      "/tenants")))
        elif args.cmd == "acl":
            if args.set_json:
                # push: {"acls": {name: {allow/deny/greylist: [cidr]}},
                #        "tenant_acl": {"0": name}, "default": name}
                out = _call(args.server, "/configuration/acl",
                            json.loads(args.set_json))
            else:
                out = _call(args.server, "/configuration")
        else:  # ruleset
            if not args.swap:
                print("ruleset requires --swap <artifact path>",
                      file=sys.stderr)
                return 2
            # the push responds only after the admission gate (staged)
            # or the full compile+swap (force) — minutes-grade, not 10s
            out = _call(args.server,
                        "/configuration/ruleset"
                        + ("?mode=force" if args.force else ""),
                        {"path": args.swap,
                         "paranoia_level": args.paranoia}, timeout=300)
    except (OSError, ValueError) as e:  # ValueError covers bad --set JSON
        print("error: %s" % e, file=sys.stderr)
        return 1
    print(out.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
