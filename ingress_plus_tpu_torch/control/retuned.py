"""The continuous retune daemon: close the telemetry→compiler loop.

A retune takes a measured fleet profile in and gives a four-gate-vetted
repacked ruleset out.  This module runs it as a long-running control
loop (docs/RETUNE.md):

    watch /fleet/drift  →  pull the merged /fleet/profile  →
    four-gate retune    →  fleet-staged rollout (control/fleetctl.py)

Hands-free, and deliberately slow-twitch:

- **Rate limited** — at most one retune per ``min_interval_s``, and a
  ``cooldown_s`` freeze after ANY fleet rollback (a pack that just got
  rolled back fleet-wide must not be re-derived ten seconds later from
  the same telemetry that produced it).
- **Structured skips, not crashes** — no drift, an unavailable merged
  profile (e.g. a node serving a newer PROFILE_VERSION degrades the
  merge), a gate failure, or an admission rejection each journal a
  typed skip and leave the incumbent serving everywhere.
- **Journaled** — every cycle appends one JSON line to a bounded
  on-disk ledger (``retuned.jsonl``), so "why didn't the daemon act"
  is answerable after the fact (``dbg fleetctl`` renders the tail).

The ``retune_gate_fail`` fault site (utils/faults.py) forces the gate
verdict to failure — the acceptance drill for "a failed gate leaves
the incumbent serving" rides it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

from ingress_plus_tpu_torch.control.fleetctl import (
    FLEET_LIVE,
    FLEET_ROLLED_BACK,
    FleetController,
)
from ingress_plus_tpu_torch.utils import faults

JOURNAL_NAME = "retuned.jsonl"

#: a drift is "actionable" when the fleet went-quiet union is non-empty
#: or any node reports a per-rule hit-rate delta at least this large
DRIFT_DELTA = 0.02

#: typed cycle results (the journal's ``result`` field)
SKIP_MIN_INTERVAL = "skip:min_interval"
SKIP_COOLDOWN = "skip:cooldown"
SKIP_NO_DRIFT = "skip:no_drift"
SKIP_NO_PROFILE = "skip:profile_unavailable"
SKIP_GATES = "skip:gates_failed"
SKIP_ADMISSION = "skip:admission_rejected"
ROLLOUT_LIVE = "rollout:fleet_live"
ROLLOUT_ROLLED_BACK = "rollout:rolled_back"
ROLLOUT_STALLED = "rollout:stalled"
CYCLE_ERROR = "error"


class RetuneDaemon:
    """One watcher, one fleet.  ``cycle()`` is the unit of work (the
    drill and the fault matrix call it directly); ``run_forever()``
    is the deployed daemon loop."""

    def __init__(self, observer, fleet: FleetController,
                 journal_dir,
                 rules: Optional[List[str]] = None,
                 min_interval_s: float = 600.0,
                 cooldown_s: float = 1800.0,
                 drift_delta: float = DRIFT_DELTA,
                 rollout_deadline_s: float = 300.0,
                 retune_kw: Optional[dict] = None,
                 max_journal_entries: int = 512,
                 clock=time.monotonic):
        self.observer = observer        # FleetObserver (or API twin)
        self.fleet = fleet
        self.journal_path = Path(journal_dir) / JOURNAL_NAME
        self.journal_path.parent.mkdir(parents=True, exist_ok=True)
        self.rules = rules              # parsed rules | None = bundled pack
        self.min_interval_s = min_interval_s
        self.cooldown_s = cooldown_s
        self.drift_delta = drift_delta
        self.rollout_deadline_s = rollout_deadline_s
        self.retune_kw = dict(retune_kw or {})
        self.max_journal_entries = max_journal_entries
        self.clock = clock
        self.cycles = 0
        self.retunes = 0
        self.last_cycle: Optional[dict] = None
        self._last_retune_at: Optional[float] = None
        self._cooldown_until: Optional[float] = None

    # ------------------------------------------------------- journal

    #: no journal record serializes under this many bytes — lets a
    #: stat() rule out truncation without reading the ledger
    _MIN_ENTRY_BYTES = 32

    def _journal(self, rec: dict) -> None:
        """Append one cycle record; rewrite keeping the newest half
        when the ledger exceeds its bound (bounded disk)."""
        rec = {"at": time.time(), **rec}
        try:
            with self.journal_path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            self._maybe_truncate()
        except OSError:
            pass  # the ledger is observability, not a serving dependency

    def _maybe_truncate(self) -> None:
        """Halve the ledger once it exceeds its entry bound.  The
        read-truncate-replace pass runs only when a cheap size check
        says it is due, and under an O_EXCL lock — a second writer
        (``--once`` beside the daemon, same shared lkg_dir) appending
        mid-rewrite must not have its record silently replaced away."""
        if (self.journal_path.stat().st_size
                <= self.max_journal_entries * self._MIN_ENTRY_BYTES):
            return
        lock = self.journal_path.with_suffix(".lock")
        try:
            os.close(os.open(str(lock),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except OSError:
            try:  # a writer that crashed mid-pass must not leak the
                if time.time() - lock.stat().st_mtime > 60.0:  # lock
                    lock.unlink()
            except OSError:
                pass
            return  # another writer is truncating; ours lands next pass
        try:
            lines = self.journal_path.read_text().splitlines()
            if len(lines) > self.max_journal_entries:
                keep = lines[-self.max_journal_entries // 2:]
                tmp = self.journal_path.with_suffix(".tmp")
                tmp.write_text("\n".join(keep) + "\n")
                tmp.replace(self.journal_path)
        finally:
            try:
                lock.unlink()
            except OSError:
                pass

    def journal_tail(self, n: int = 16) -> List[dict]:
        try:
            lines = self.journal_path.read_text().splitlines()
        except OSError:
            return []
        out = []
        for line in lines[-n:]:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out

    # ------------------------------------------------------- signals

    def _drift_reason(self) -> Optional[str]:
        """An actionable-drift probe over /fleet/drift, or None."""
        try:
            d = self.observer.fleet_drift()
        except Exception:  # noqa: BLE001 — unreachable fleet = no signal
            return None
        quiet = d.get("fleet_went_quiet") or []
        if quiet:
            return "fleet_went_quiet:%d rules" % len(quiet)
        worst = 0.0
        for name, rep in (d.get("nodes") or {}).items():
            for row in (rep.get("rules") or []):
                worst = max(worst, abs(float(row.get("delta", 0.0))))
        if worst >= self.drift_delta:
            return "hit_rate_delta:%.4f" % worst
        return None

    def _profile(self):
        """(profile, error) — the merged fleet profile or the typed
        reason it is unavailable (a node publishing a newer
        PROFILE_VERSION already degraded to merge-over-the-rest or an
        explicit error inside the observer; both surface here as a
        structured skip, never a crashed cycle)."""
        try:
            prof = self.observer.merged_profile()
        except Exception as e:  # noqa: BLE001 — daemon must not crash
            return None, "observer error: %s" % e
        if prof is None:
            err = ""
            try:
                err = self.observer.healthz().get(
                    "merged_profile", {}).get("error", "")
            except Exception:
                pass
            return None, err or "no merged profile"
        return prof, ""

    # ------------------------------------------------------- the cycle

    def cycle(self, force: bool = False) -> dict:
        """One daemon cycle.  Returns (and journals) the typed record;
        never raises.  ``force`` skips the rate limiter and the drift
        check (operator break-glass / drill hook), NOT the gates."""
        self.cycles += 1
        now = self.clock()
        rec: Dict = {"cycle": self.cycles, "result": "", "detail": ""}
        try:
            rec.update(self._cycle_inner(now, force))
        except Exception as e:  # noqa: BLE001 — the loop must survive
            rec["result"] = CYCLE_ERROR
            rec["detail"] = "%s: %s" % (type(e).__name__, e)
        self.last_cycle = rec
        self._journal(rec)
        return rec

    def _cycle_inner(self, now: float, force: bool) -> dict:
        if (self._cooldown_until is not None
                and now < self._cooldown_until):
            return {"result": SKIP_COOLDOWN,
                    "detail": "%.0fs left after a fleet rollback"
                              % (self._cooldown_until - now)}
        if not force:
            if (self._last_retune_at is not None
                    and now - self._last_retune_at < self.min_interval_s):
                return {"result": SKIP_MIN_INTERVAL,
                        "detail": "%.0fs since last retune"
                                  % (now - self._last_retune_at)}
            drift = self._drift_reason()
            if drift is None:
                return {"result": SKIP_NO_DRIFT, "detail": ""}
        else:
            drift = "forced"
        prof, perr = self._profile()
        if prof is None:
            return {"result": SKIP_NO_PROFILE, "detail": perr,
                    "drift": drift}
        self._last_retune_at = now
        self.retunes += 1

        from ingress_plus_tpu_torch.control.retune import retune

        report = retune(rules=self.rules, profile=prof,
                        **self.retune_kw)
        cr = report.pop("_retuned_cr", None)
        gates: Dict = {"ok": bool(report.get("ok"))}
        infl = report.get("inflation") or {}
        if isinstance(infl.get("retuned"), dict):
            gates["lost_candidates"] = infl["retuned"].get("lost_candidates")
        replay = report.get("replay") or {}
        gates["replay_new_fns"] = replay.get("new_fns")
        if isinstance(report.get("rollout"), dict):
            gates["staged_state"] = report["rollout"].get("state")
        if faults.fire("retune_gate_fail"):
            report["ok"] = False
            gates["ok"] = False
            gates["injected"] = True
        if not report.get("ok") or cr is None:
            return {"result": SKIP_GATES, "drift": drift,
                    "gates": gates,
                    "detail": "retune gates failed; incumbent stays"}
        incumbent = self.fleet.nodes[0].serving_version
        if cr.version == incumbent:
            return {"result": SKIP_NO_DRIFT, "drift": drift,
                    "detail": "retuned pack == incumbent %s" % incumbent}
        admission = self.fleet.begin(ruleset=cr)
        if not admission.get("ok"):
            return {"result": SKIP_ADMISSION, "drift": drift,
                    "gates": gates,
                    "detail": admission.get("reason", "rejected")}
        state = self.fleet.drive(deadline_s=self.rollout_deadline_s)
        out = {"drift": drift, "gates": gates,
               "candidate": cr.version, "fleet_state": state}
        if state == FLEET_LIVE:
            out["result"] = ROLLOUT_LIVE
        elif state == FLEET_ROLLED_BACK:
            out["result"] = ROLLOUT_ROLLED_BACK
            out["detail"] = self.fleet.rollback_reason
            self._cooldown_until = self.clock() + self.cooldown_s
        else:
            out["result"] = ROLLOUT_STALLED
            out["detail"] = "state %s at deadline" % state
        return out

    # ------------------------------------------------------- lifecycle

    def status(self) -> dict:
        now = self.clock()
        return {
            "cycles": self.cycles,
            "retunes": self.retunes,
            "min_interval_s": self.min_interval_s,
            "cooldown_s": self.cooldown_s,
            "cooldown_left_s": (
                max(0.0, self._cooldown_until - now)
                if self._cooldown_until is not None else 0.0),
            "last_cycle": self.last_cycle,
            "journal": str(self.journal_path),
        }

    def run_forever(self, poll_s: float = 30.0,
                    stop_event=None) -> None:
        import threading

        stop = stop_event or threading.Event()
        while not stop.is_set():
            self.cycle()
            stop.wait(poll_s)


def main(argv=None) -> None:
    """Deployed daemon: HTTP nodes + the fleet aggregator's /fleet
    surfaces.  (In-process fleets wire RetuneDaemon directly.)"""
    from ingress_plus_tpu_torch.control.fleetctl import HttpFleetNode

    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.control.retuned")
    ap.add_argument("--fleet-url", default="127.0.0.1:9911",
                    help="fleet aggregator host:port (/fleet/* surfaces)")
    ap.add_argument("--node", action="append", default=[],
                    metavar="NAME=HOST:PORT", required=False,
                    help="one serve node's HTTP plane; repeatable")
    ap.add_argument("--lkg-dir", required=True,
                    help="shared fleet LKG dir (journal + pointer + packs)")
    ap.add_argument("--poll-s", type=float, default=30.0)
    ap.add_argument("--min-interval-s", type=float, default=600.0)
    ap.add_argument("--cooldown-s", type=float, default=1800.0)
    ap.add_argument("--once", action="store_true",
                    help="run one cycle and print its record")
    ap.add_argument("--force", action="store_true",
                    help="skip the rate limiter and drift check once")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="torch device of the retune gates' pipelines "
                         "(the profile replay, the staged rollout, the "
                         "A/B); cuda without a card fails the retune "
                         "cycle")
    args = ap.parse_args(argv)

    class _HttpFleetSurfaces:
        """Minimal observer twin over the aggregator's HTTP plane."""

        def __init__(self, target: str):
            self.target = target

        def _get(self, path: str) -> dict:
            import urllib.request

            with urllib.request.urlopen(
                    "http://%s%s" % (self.target, path), timeout=10) as r:
                return json.loads(r.read())

        def fleet_drift(self) -> dict:
            return self._get("/fleet/drift")

        def healthz(self) -> dict:
            return self._get("/fleet/healthz")

        def merged_profile(self):
            from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile

            try:
                return MeasuredProfile.from_dict(
                    self._get("/fleet/profile"))
            except Exception:
                return None

    nodes = []
    for spec in args.node:
        name, sep, target = spec.partition("=")
        if not sep:
            ap.error("--node wants NAME=HOST:PORT, got %r" % spec)
        nodes.append(HttpFleetNode(name, target))
    if not nodes:
        ap.error("the daemon needs at least one --node to roll packs to")
    fleet = FleetController(nodes, args.lkg_dir)
    fleet.recover()
    daemon = RetuneDaemon(_HttpFleetSurfaces(args.fleet_url), fleet,
                          args.lkg_dir,
                          min_interval_s=args.min_interval_s,
                          cooldown_s=args.cooldown_s,
                          retune_kw={"device": args.platform})
    if args.once:
        print(json.dumps(daemon.cycle(force=args.force), indent=2))
        return
    daemon.run_forever(poll_s=args.poll_s)


if __name__ == "__main__":
    main()
