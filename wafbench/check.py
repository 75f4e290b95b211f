"""``correct``: every verdict a run got back, against the plain reference.

The benchmark regenerates the units the client sent (the same mix and
seed give the same bytes), decodes each request frame as the server
does, and has :class:`wafbench.reference.verdict.Reference` work out the
verdict it is owed: the scan on the given device in large batches, the
confirm stage, which is host Python, in worker processes of its own
(``python -m wafbench.check --worker IN OUT``), each started, waited for
and, on any way out, killed by the judge: no process outlives it.
Two numbers are compared, each an exact count with the limit 0:

``wrong``
    verdicts that came back and differ from the reference's in any field
    (attack, blocked, fail-open, score, classes, rule ids): a degraded or
    fail-open verdict differs, since the configurations guarantee an
    exact verdict for every request;
``unanswered``
    units sent whose verdict never came, the client's drain included.

Every answered unit is judged, the uploads too, whose confirm on 1 MiB
bodies costs the reference seconds each.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wafbench.gen import Traffic
from wafbench.reference.verdict import Reference
from wafbench.wire import decode_request

#: buffered requests, and uploads, scanned per batch
SCAN_BATCH = 8192
UPLOAD_BATCH = 16
#: the limit of each compared number (exact comparisons)
LIMITS = {"wrong": 0, "unanswered": 0}

def _finish_share(pack: str, mode: str, confirm: bool, share) -> List[dict]:
    ref = Reference(pack, mode=mode, device=None, confirm=confirm)
    out = []
    for req, hits, truncated in share:
        cand = np.zeros((ref.pack.n_rules,), bool)
        cand[hits] = True
        out.append(ref.finish_upload(req, cand, truncated))
    return out


def _run_workers(shares: List[list], pack: str, mode: str, confirm: bool
                 ) -> List[List[dict]]:
    """Each share confirmed in a process of its own; the verdicts by
    share.  Every worker is waited for, and killed first on an error."""
    from wafbench.server import child_env, die_with_parent

    procs: List[subprocess.Popen] = []
    with tempfile.TemporaryDirectory(prefix="wafbench-judge-") as d:
        try:
            for k, share in enumerate(shares):
                src = os.path.join(d, "share%d" % k)
                with open(src, "wb") as f:
                    pickle.dump((pack, mode, confirm, share), f)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "wafbench.check", "--worker", src,
                     src + ".out"], env=child_env(),
                    stdout=subprocess.DEVNULL, preexec_fn=die_with_parent))
            rcs = [p.wait() for p in procs]
            if any(rcs):
                raise RuntimeError("a confirm worker of the reference "
                                   "exited with %s" % rcs)
            results = []
            for k in range(len(shares)):
                with open(os.path.join(d, "share%d.out" % k), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


@dataclass
class Judgement:
    #: the reference's verdict per req_id
    want: Dict[int, dict] = field(default_factory=dict)
    #: per req_id: (scan rows, scan row bytes) by the reference's prep
    work: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    wrong: List[int] = field(default_factory=list)
    unanswered: List[int] = field(default_factory=list)
    #: seconds the reference took: prep and scan, then confirm
    times: Dict[str, float] = field(default_factory=dict)

    def numbers(self) -> Dict[str, int]:
        return {"wrong": len(self.wrong), "unanswered": len(self.unanswered)}

    @property
    def correct(self) -> bool:
        n = self.numbers()
        return all(n[k] <= LIMITS[k] for k in LIMITS)


def reference_verdicts(traffic: Traffic, req_ids: Sequence[int], pack: str,
                       mode: str = "block", device: str = "cpu",
                       workers: int = 0, confirm: bool = True,
                       only: Optional[set] = None, times: Optional[dict] = None
                       ) -> Tuple[Dict[int, dict], Dict[int, tuple]]:
    """The reference's scan work for each unit in ``req_ids``, and its
    verdict for each (for those in ``only``, when given).  ``workers``
    confirm processes (0: in this process); ``times`` gets the seconds
    of prep and scan, and of confirm."""
    t0 = time.perf_counter()
    ref = Reference(pack, mode=mode, device=device, confirm=confirm)
    jobs: List[tuple] = []       # (req_id, request, candidate idx, truncated)
    work: Dict[int, tuple] = {}
    ids = sorted(req_ids)
    buffered = [r for r in ids if traffic.unit(r - 1).chunks is None]
    for lo in range(0, len(buffered), SCAN_BATCH):
        part = buffered[lo:lo + SCAN_BATCH]
        reqs = [decode_request(traffic.unit(r - 1).frames[0])[2]
                for r in part]
        cand, rows = ref.candidates_and_rows(reqs)
        for k, r in enumerate(part):
            jobs.append((r, reqs[k], np.nonzero(cand[k])[0], False))
            work[r] = (int(rows[k][0]), int(rows[k][1]))
    uploads = [r for r in ids if traffic.unit(r - 1).chunks is not None]
    for lo in range(0, len(uploads), UPLOAD_BATCH):
        part = uploads[lo:lo + UPLOAD_BATCH]
        got = ref.uploads_candidates(
            [(decode_request(traffic.unit(r - 1).frames[0])[2],
              traffic.unit(r - 1).chunks) for r in part])
        for r, (req, cand, truncated, w) in zip(part, got):
            jobs.append((r, req, np.nonzero(cand)[0], truncated))
            work[r] = (int(w[0]), int(w[1]))
    t1 = time.perf_counter()
    if only is not None:
        jobs = [j for j in jobs if j[0] in only]
    want: Dict[int, dict] = {}
    payload = [(req, hits, trunc) for _r, req, hits, trunc in jobs]
    if workers > 0 and len(jobs) > 1:
        n = min(workers, len(jobs))
        # each worker takes interleaved requests, so one slow upload or a
        # run of attacks does not hold one worker alone
        shares = [payload[k::n] for k in range(n)]
        results = _run_workers(shares, pack, mode, confirm)
        for k in range(n):
            for j, v in zip(range(k, len(jobs), n), results[k]):
                want[jobs[j][0]] = v
    else:
        for (r, _req, _hits, _t), (req, hits, trunc) in zip(jobs, payload):
            cand = np.zeros((ref.pack.n_rules,), bool)
            cand[hits] = True
            want[r] = ref.finish_upload(req, cand, trunc)
    if times is not None:
        times.update(prep_scan_s=t1 - t0, confirm_s=time.perf_counter() - t1)
    return want, work


def judge(traffic: Traffic, sent: Sequence[int], got: Dict[int, dict],
          pack: str, mode: str = "block", device: str = "cpu",
          workers: int = 0) -> Judgement:
    """Compare every verdict that came back with the reference's; every
    unit that got no verdict counts as unanswered."""
    only = {r for r in sent if r in got}
    j = Judgement()
    j.want, j.work = reference_verdicts(traffic, sent, pack, mode, device,
                                        workers, only=only, times=j.times)
    want = j.want
    for r in sent:
        v = got.get(r)
        if v is None:
            j.unanswered.append(r)
            continue
        if r not in want:
            continue
        v = {k: v[k] for k in want[r]}
        if v != want[r]:
            j.wrong.append(r)
    return j


def default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def _worker_main(argv: List[str]) -> int:
    if len(argv) != 3 or argv[0] != "--worker":
        print("usage: python -m wafbench.check --worker IN OUT",
              file=sys.stderr)
        return 2
    with open(argv[1], "rb") as f:
        pack, mode, confirm, share = pickle.load(f)
    out = _finish_share(pack, mode, confirm, share)
    with open(argv[2], "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
