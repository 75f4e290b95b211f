"""Export + ruleset-sync loops — the cron sidecar analog (SURVEY.md §3.4).

``Exporter`` is the `export-attacks`/`export-counters`† cadence: a
background thread that periodically drains the HitQueue, folds hits into
attacks (aggregate.py), runs brute detection, and delivers them to a sink.
The reference POSTs to the Wallarm cloud over HTTPS; this build has zero
egress, so the default sink is an append-only jsonl spool directory, with
an optional HTTP hook for a reachable collector.  Delivery failure never
raises into the serve path — failed batches are re-spooled and counted.

``RulesetWatcher`` is the `sync-node`† analog: the reference cron pulls a
fresh proton.db and hot-swaps the engine's ruleset.  Here: watch a
directory for compiled-ruleset artifacts (compiler/ruleset.py save()
format, `<name>.iptr/` with meta.json) newer than the running version and
POST the serve loop's ``/configuration/ruleset`` endpoint, which performs
the double-buffered on-device swap with no serve gap.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable, List, Optional

from ingress_plus_tpu_torch.post.aggregate import aggregate_attacks
from ingress_plus_tpu_torch.post.brute import BruteDetector
from ingress_plus_tpu_torch.post.queue import HitQueue
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.trace import EV_EXPORT, flight


class Exporter:
    def __init__(
        self,
        queue: HitQueue,
        spool_dir: Optional[str] = None,
        http_url: Optional[str] = None,
        interval_s: float = 5.0,
        gap_s: float = 60.0,
        brute: Optional[BruteDetector] = None,
        max_drain: int = 100_000,
        on_export: Optional[Callable[[List[dict]], None]] = None,
        backoff_max_s: float = 300.0,
        max_spool_bytes: int = 256 << 20,
        jitter_seed: int = 0,
    ):
        self.queue = queue
        self.spool_dir = Path(spool_dir) if spool_dir else None
        self.http_url = http_url
        self.interval_s = interval_s
        self.gap_s = gap_s
        self.brute = brute
        self.max_drain = max_drain
        #: delivered-records hook (PostChannel feeds NodeCounters so
        #: brute/dirbust events show in /wallarm-status per application)
        self.on_export = on_export
        self.exported_attacks = 0
        self.export_errors = 0
        # failure backoff (docs/ROBUSTNESS.md): a down collector used to
        # be re-hit on the fixed interval forever — retries now back off
        # exponentially with jitter up to a ceiling, and delivery
        # success snaps back to the base interval
        self.backoff_max_s = backoff_max_s
        self.consecutive_failures = 0
        self.backoff_s = 0.0   # the currently applied backoff (status)
        self._rng = random.Random(jitter_seed)
        # spool bound: a long collector outage must not fill the disk —
        # oldest spool files are dropped (and counted) to fit the cap
        self.max_spool_bytes = max_spool_bytes
        self.spool_dropped_files = 0
        self.spool_dropped_bytes = 0
        self.spool_dropped_records = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.spool_dir:
            self.spool_dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------ core

    def flush_once(self) -> int:
        """One export cycle; returns number of attacks delivered."""
        hits = self.queue.drain(self.max_drain)
        if not hits:
            return 0
        attacks = aggregate_attacks(hits, gap_s=self.gap_s)
        if self.brute is not None:
            attacks.extend(self.brute.observe(hits))
        if not attacks:
            return 0
        records = [a.to_dict() for a in attacks]
        ok = self._deliver(records)
        if ok:
            self.consecutive_failures = 0
            self.exported_attacks += len(records)
            if self.on_export is not None:
                try:
                    self.on_export(records)
                except Exception:
                    pass   # counters are best-effort, never break export
            return len(records)
        self.export_errors += 1
        self.consecutive_failures += 1
        return 0

    def next_wait_s(self) -> float:
        """Sleep until the next export attempt: the base interval while
        healthy; exponential backoff with jitter (x[1.0, 1.5)) and a
        hard ceiling after consecutive delivery failures — a down
        collector is probed ever more gently, and the jitter keeps a
        fleet of nodes from re-hitting it in lockstep."""
        if not self.consecutive_failures:
            return self.interval_s
        base = min(self.interval_s * (2 ** (self.consecutive_failures - 1)),
                   self.backoff_max_s)
        return min(base * (1.0 + 0.5 * self._rng.random()),
                   self.backoff_max_s)

    def _enforce_spool_bound(self, incoming: int, keep: Path) -> bool:
        """Drop-oldest spool files until ``incoming`` more bytes fit
        under ``max_spool_bytes`` (the current writer's own file is
        dropped last).  False = the batch cannot fit even after
        dropping everything else — the caller skips the write and
        counts the records."""
        if self.max_spool_bytes <= 0 or self.spool_dir is None:
            return True
        try:
            files = []
            for f in self.spool_dir.glob("attacks*"):
                if f.is_file():
                    st = f.stat()
                    files.append((st.st_mtime, st.st_size, f))
        except OSError:
            return True
        total = sum(sz for _, sz, _ in files)
        if total + incoming <= self.max_spool_bytes:
            return True
        # oldest first; the live file we are about to append to goes last
        files.sort(key=lambda t: (t[2] == keep, t[0]))
        for _, sz, f in files:
            if total + incoming <= self.max_spool_bytes:
                break
            try:
                f.unlink()
            except OSError:
                continue
            total -= sz
            self.spool_dropped_files += 1
            self.spool_dropped_bytes += sz
        return total + incoming <= self.max_spool_bytes

    def _deliver(self, records: List[dict]) -> bool:
        delivered = False
        if self.spool_dir is not None:
            try:
                # one spool file per exporter process: the rendered
                # Deployment mounts a single spool emptyDir into N serve
                # containers, so a shared attacks.jsonl would interleave
                # buffered appends and tear lines.  Keyed by pid there is
                # exactly one writer per file.
                path = self.spool_dir / ("attacks.%d.jsonl" % os.getpid())
                payload = "".join(json.dumps(r) + "\n" for r in records)
                if self._enforce_spool_bound(len(payload), path):
                    with path.open("a") as f:
                        f.write(payload)
                    delivered = True
                else:
                    # the batch alone exceeds the bound: counted loss,
                    # never unbounded disk
                    self.spool_dropped_records += len(records)
            except OSError:
                pass
        if self.http_url:
            try:
                # export_5xx fault site (utils/faults.py): a collector
                # answering 5xx raises exactly like a dead one
                faults.raise_if("export_5xx")
                req = urllib.request.Request(
                    self.http_url, data=json.dumps(records).encode(),
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=5).read()
                delivered = True
            except Exception:
                # cloud unreachable: spool already has the data (if
                # configured); otherwise count the loss, never raise
                pass
        return delivered

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="ipt-exporter", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        wait = self.interval_s
        flight.register_thread("exporter")
        while not self._stop.wait(wait):
            flight.begin(EV_EXPORT, cycle=0)
            try:
                self.flush_once()
            except Exception:
                self.export_errors += 1
                self.consecutive_failures += 1
            finally:
                flight.end(EV_EXPORT, cycle=0)
            wait = self.next_wait_s()
            self.backoff_s = wait if self.consecutive_failures else 0.0

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        try:
            self.flush_once()
        except Exception:
            self.export_errors += 1


class RulesetWatcher:
    """Poll ``artifact_dir`` for compiled-ruleset artifacts and hot-swap
    the serve loop when a version not yet running appears.

    Artifact layout (compiler/ruleset.py save()): ``<dir>/<name>.npz`` +
    ``<dir>/<name>.json`` whose JSON carries a content-hash ``version``.
    Newest meta mtime wins.  The swap itself
    is the serve loop's job (double-buffered device puts); this watcher
    only triggers it — exactly the reference's cron→module split.
    """

    def __init__(self, artifact_dir: str, serve_http: str,
                 interval_s: float = 10.0,
                 poster: Optional[Callable[[str, dict], dict]] = None):
        self.artifact_dir = Path(artifact_dir)
        self.serve_http = serve_http  # host:port
        self.interval_s = interval_s
        self.current_version: Optional[str] = None
        self.swaps = 0
        self.errors = 0
        # versions the serve loop REJECTED (guarded-rollout admission
        # gate 4xx, control/rollout.py): re-pushing one would re-run the
        # whole gate — compile smoke + corpus replay — every poll tick
        # forever; a rejected pack stays skipped until a NEW artifact
        # version appears
        self.rejected_versions: set = set()
        self._poster = poster or self._http_post
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _http_post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            "http://%s%s" % (self.serve_http, path),
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read() or b"{}")

    def newest_artifact(self) -> Optional[Path]:
        """Base path (no suffix) of the newest complete artifact pair."""
        if not self.artifact_dir.is_dir():
            return None
        cands = [p for p in self.artifact_dir.glob("*.json")
                 if p.with_suffix(".npz").is_file()]
        if not cands:
            return None
        return max(cands, key=lambda p: p.stat().st_mtime).with_suffix("")

    def check_once(self) -> bool:
        """Returns True if a swap was triggered."""
        art = self.newest_artifact()
        if art is None:
            return False
        try:
            version = json.loads(
                art.with_suffix(".json").read_text()).get("version")
        except (OSError, json.JSONDecodeError):
            self.errors += 1
            return False
        if version is None or version == self.current_version \
                or version in self.rejected_versions:
            return False
        try:
            out = self._poster("/configuration/ruleset", {"path": str(art)})
        except urllib.error.HTTPError as e:
            self.errors += 1
            if 400 <= e.code < 500 and e.code != 409:
                # DETERMINISTIC rejection (admission gate / unloadable
                # artifact): retrying every tick would re-run the whole
                # gate forever — remember the version until a new
                # artifact lands.  Transient refusals must stay
                # retryable: 409 (no controller / conflict) and the
                # 422 whose body says another rollout is in progress.
                try:
                    reason = json.loads(e.read() or b"{}").get("reason")
                except Exception:
                    reason = None
                if reason != "rollout_in_progress":
                    self.rejected_versions.add(version)
            return False
        except Exception:
            self.errors += 1
            return False
        # staged responses carry the CANDIDATE version ("candidate"/
        # "staged"); force responses carry "ruleset".  Either way the
        # push landed — don't re-push the same artifact next tick.
        self.current_version = out.get("ruleset") \
            or out.get("candidate") or version
        self.swaps += 1
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="ipt-ruleset-watch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:
                self.errors += 1

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


# --------------------------------------------------------------- CLI
# The standalone consolidator the postanalytics Deployment runs (the
# cron-sidecar process of the reference†: read the queue store, ship
# attacks to the collector, keep nothing on failure loss-y).

def consolidate_once(spool_dir: str | Path, url: Optional[str] = None,
                     keep: bool = True) -> int:
    """Claim the current attacks.jsonl (atomic rename), forward/fold it.

    Returns records processed.  On delivery failure the claimed file is
    left in place (`*.sending`) and retried next cycle — at-least-once,
    like the reference's export scripts.
    """
    spool = Path(spool_dir)
    out = spool / "consolidated"
    out.mkdir(exist_ok=True)
    n = 0
    # retry leftovers first, then claim the live spool files (one per
    # writer process, plus the legacy shared name)
    seq = 0
    for live in sorted(spool.glob("attacks*.jsonl")):
        claimed = spool / ("attacks.%d_%d.sending"
                           % (int(time.time() * 1e6), seq))
        seq += 1
        try:
            live.rename(claimed)
        except OSError:
            pass
    def _unlink_claimed(f: Path, keep_from: int, nread: int) -> None:
        """Unlink a processed .sending file WITHOUT dropping bytes a
        still-in-flight writer appended after our read (the claim-rename
        can land mid-append; the writer's completed tail would die with
        the unlink).  Only ONE burst can race — the
        writer re-opens by name each cycle and the name now points to a
        fresh live file — so: wait for the size to go stable (bounded),
        then requeue everything from ``keep_from`` (the last PARSED line
        boundary, so a record straddling the read boundary is requeued
        whole, torn prefix included) as a new .sending.
        """
        try:
            size = f.stat().st_size
            # wait for STABILITY (size stops changing), not equality
            # with nread — once a tail exists the size can never re-equal
            # nread, and an in-flight flush straddling the window would
            # still be torn; no tail costs zero sleeps
            for _ in range(5):
                if size == nread:
                    break
                time.sleep(0.01)
                prev, size = size, f.stat().st_size
                if size == prev:
                    break
            if size > nread:
                # bytes WERE appended after our read: requeue from the
                # line boundary so the straddled record survives whole.
                # (With no append, a torn final fragment is dropped as
                # before — requeueing it unconditionally would loop
                # forever on a fragment no writer will ever complete.)
                with f.open("rb") as fh:
                    fh.seek(keep_from)
                    tail = fh.read()
                if tail.strip():
                    requeued = spool / ("attacks.%d_tail.sending"
                                        % int(time.time() * 1e6))
                    requeued.write_bytes(tail)
            f.unlink()
        except OSError:
            pass  # transient; the whole file is retried next cycle

    for f in sorted(spool.glob("attacks.*.sending")):
        try:
            raw = f.read_bytes()
        except OSError:
            continue  # transient; retried next cycle
        # start of the trailing incomplete line (== len(raw) if none):
        # the requeue boundary for a record straddling this read
        boundary = len(raw) if raw.endswith(b"\n") else raw.rfind(b"\n") + 1
        text = raw.decode("utf-8", "replace")
        # salvage line-by-line: a torn line from a partial append must not
        # discard the batch's valid records (at-least-once contract)
        records = []
        for line in text.splitlines():
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                pass
        if not records:
            _unlink_claimed(f, boundary, len(raw))
            continue
        if url:
            try:
                req = urllib.request.Request(
                    url, data=json.dumps(records).encode(),
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:
                continue  # left as .sending → retried next cycle
        if keep:
            with (out / "attacks.jsonl").open("a") as fh:
                for r in records:
                    fh.write(json.dumps(r) + "\n")
        _unlink_claimed(f, boundary, len(raw))
        n += len(records)
    return n


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.post.export")
    ap.add_argument("--spool-dir", required=True)
    ap.add_argument("--url", default=None,
                    help="HTTP collector; default keeps a consolidated "
                         "jsonl under <spool>/consolidated/")
    ap.add_argument("--interval-s", type=float, default=5.0)
    ap.add_argument("--once", action="store_true")
    args = ap.parse_args(argv)
    while True:
        # with a collector the records live there; keeping a local copy
        # too would grow the pod's emptyDir without bound
        n = consolidate_once(args.spool_dir, url=args.url,
                             keep=not args.url)
        if n:
            print("consolidated %d attack records" % n, flush=True)
        if args.once:
            break
        time.sleep(args.interval_s)


if __name__ == "__main__":
    main()
