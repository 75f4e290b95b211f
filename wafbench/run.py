"""Run one cell of the benchmark once.

    python3 -m wafbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  The run:

1. starts the system under test, ``python -m ingress_plus_tpu_torch.serve``
   with the cell's configuration (``wafbench/configs/``), and the client,
   ``python -m wafbench.loadgen`` with the cell's traffic mix
   (``wafbench/traffic/``), each a process of its own; the client builds
   its traffic from the seed while the server builds, loads and warms
   its kernels;
2. once the server is ready, lets the client warm up and then measure for
   ``--seconds``, scraping the server's ``/metrics`` as the window opens
   and closes;
3. waits for the verdicts still in flight, reads the card's memory, and
   stops the server (which then writes its profiler trace, with
   ``--trace 1``);
4. judges every verdict against the plain reference (:mod:`wafbench.check`),
   on the card the server has left;
5. prints the numbers compared, each beside its limit, as the last lines
   of standard error, and one JSON line last on standard output: the
   cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
   with ``--trace 1``, each read by ``wafbench/metrics/<name>.py``.

It exits non-zero, printing no result, without the cards the cell asks
for, when the server or the client fails, or when JAX or the JAX package
is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from wafbench import check, manifest  # noqa: E402
from wafbench.devtrace import DeviceWindow, read_window  # noqa: E402
from wafbench.gen import Traffic, load_mix  # noqa: E402
from wafbench.server import (SOCKET, Server, child_env,  # noqa: E402
                             die_with_parent)

#: top-level modules that must not be loaded in the process that prints
#: the result (the port's own name starts with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "ingress_plus_tpu")
#: a first run in a checkout builds the kernels and the confirm twin
READY_S = 1100.0
#: units the client builds before it reports ready
PREGEN = {"web": 30000, "upload": 8}


@dataclass
class Context:
    """What a metric's reader reads (``read(ctx)`` in
    ``wafbench/metrics/<name>.py``; ``None`` = nothing to read)."""

    seconds: float
    setup_s: float
    #: the client's record (:class:`wafbench.loadgen.Record` as a dict)
    rec: dict
    #: /metrics counter deltas over the window
    counters: Dict[str, float]
    #: the pack's 32-bit words per scan row
    n_words: int
    #: per req_id: (scan rows, scan row bytes) by the reference's prep
    work: Dict[int, tuple]
    #: the device's window (``--trace 1``)
    trace: Optional[DeviceWindow] = None
    #: lines for standard error, before the compared numbers
    notes: List[str] = field(default_factory=list)

    def in_window(self, t: float) -> bool:
        return self.rec["t_open"] <= t <= self.rec["t_close"]

    def done_in_window(self):
        """(req_id, body bytes) of the units answered in the window."""
        rec = self.rec
        for rid, b in zip(rec["req_id"], rec["body_bytes"]):
            t = rec["t_done"].get(rid)
            if t is not None and self.in_window(t):
                yield rid, b

    def work_in_window(self):
        """(rows, row bytes) of scan work inside the window: each unit's
        work spread evenly over its time from sent to answered."""
        rec = self.rec
        t0, t1 = rec["t_open"], rec["t_close"]
        rows = nbytes = 0.0
        for rid, ts in zip(rec["req_id"], rec["t_sent"]):
            td = rec["t_done"].get(rid)
            if td is None or rid not in self.work:
                continue
            share = (1.0 if td <= ts else
                     max(0.0, min(td, t1) - max(ts, t0)) / (td - ts))
            if share:
                r, b = self.work[rid]
                rows += share * r
                nbytes += share * b
        return rows, nbytes


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True,
        timeout=30).stdout.strip()


def card_memory_bytes() -> int:
    return int(float(smi("memory.used"))) << 20


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             platform: str = "cuda", server_extra: List[str] = (),
             mix: Optional[dict] = None,
             server_env: Optional[Dict[str, str]] = None) -> dict:
    """One run of one cell; returns the result line's object.
    ``platform`` "cpu" (tests only) serves on the CPU and runs the
    reference there; it reads no card.  ``mix`` (tests only) replaces the
    cell's traffic mix; ``server_env`` is added to the server's
    environment."""
    man = manifest.load_manifest()
    cell = manifest.cell(man, cell_name)
    conf = manifest.config(man, cell["config"])
    mix = mix or load_mix(cell["traffic"])
    run_dir = Path(tempfile.gettempdir()) / "wafbench-run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    (run_dir / "mix.json").write_text(json.dumps(mix))
    extra = list(server_extra)
    if platform == "cpu":
        extra += ["--platform", "cpu", "--hard-deadline-ms", "10000"]
    server = Server(run_dir, conf["serve_flags"], trace, extra, server_env)
    client = None
    try:
        client = subprocess.Popen(
            [sys.executable, "-m", "wafbench.loadgen",
             "--mix", str(run_dir / "mix.json"),
             "--seed", str(seed), "--seconds", str(seconds),
             "--socket", SOCKET, "--out", str(run_dir / "client.pkl"),
             "--pregen", str(PREGEN[mix["kind"]])],
            cwd=run_dir, env=child_env(), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, preexec_fn=die_with_parent)
        server.wait_ready(READY_S)
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the client did not start")
        t_start = time.perf_counter() + 0.05
        client.stdin.write("go %r\n" % t_start)
        client.stdin.flush()
        line = client.stdout.readline().split()
        if not line or line[0] != "open":
            raise RuntimeError("the client failed in its warm-up")
        t_open = float(line[1])
        time.sleep(max(0.0, t_open - time.perf_counter()))
        m0 = server.counters()
        mem = [card_memory_bytes()] if platform == "cuda" else [0]
        time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        m1 = server.counters()
        if client.stdout.readline().strip() != "done":
            raise RuntimeError("the client failed")
        client.wait(timeout=60)
        if platform == "cuda":
            mem.append(card_memory_bytes())
        impl = [ln for ln in server.log_tail(200000).splitlines()
                if "scan impl" in ln]
    finally:
        # every child is stopped and waited for on every way out
        try:
            trace_path = server.stop()
        finally:
            if client is not None:
                if client.poll() is None:
                    client.kill()
                client.wait()
    with open(run_dir / "client.pkl", "rb") as f:
        rec = pickle.load(f)
    if rec["error"]:
        raise RuntimeError("the client failed: %s" % rec["error"])
    found = forbidden_modules()
    if found:
        raise SystemExit("wafbench: loaded in the result's process: %s"
                         % ", ".join(found))

    traffic = Traffic(mix, seed)
    tj = time.perf_counter()
    judgement = check.judge(
        traffic, rec["req_id"], rec["verdict"], str(manifest.ROOT / conf["pack"]),
        mode=conf["mode"], device=platform,
        workers=check.default_workers() if platform == "cuda" else 0)
    judge_s = time.perf_counter() - tj
    from wafbench.reference.pack import load_pack

    n_words = load_pack(manifest.ROOT / conf["pack"]).n_words
    ctx = Context(seconds=float(seconds),
                  setup_s=rec["t_open"] - T_START, rec=rec,
                  counters={k: m1[k] - m0.get(k, 0.0) for k in m1},
                  n_words=n_words, work=judgement.work)
    ctx.notes += impl
    if trace:
        if trace_path is None:
            raise RuntimeError("the server wrote no trace")
        off = rec["wall_minus_mono"]
        ctx.trace = read_window(trace_path, (rec["t_open"] + off) * 1e6,
                                (rec["t_close"] + off) * 1e6)
    wanted = (manifest.per_layer(man, cell_name) if trace
              else manifest.end_to_end(man, cell_name))
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sent = len(rec["req_id"])
    fail_open = {r for r, v in rec["verdict"].items() if v["fail_open"]}
    ctx.notes.append("server counters over the window: %d degraded "
                     "verdicts, %d fail-open, %d first loads"
                     % (ctx.counters.get("ipt_degraded_verdicts_total", 0),
                        ctx.counters.get("ipt_fail_open_total", 0),
                        ctx.counters.get("ipt_engine_recompiles_total", 0)))
    ctx.notes.append("sent %d units (%d in the window's %.0f s), %d "
                     "answered; %d fail-open; reference took %.1f s"
                     % (sent, sum(1 for t in rec["t_sent"]
                                  if ctx.in_window(t)),
                        seconds, len(rec["verdict"]), len(fail_open),
                        judge_s))
    ctx.notes.append("reference: %d verdicts judged; prep and scan %.1f s, "
                     "confirm %.1f s"
                     % (len(judgement.want),
                        judgement.times.get("prep_scan_s", 0.0),
                        judgement.times.get("confirm_s", 0.0)))
    fifths = [0] * 5
    for _rid, _b in ctx.done_in_window():
        k = int(5 * (rec["t_done"][_rid] - rec["t_open"]) / seconds)
        fifths[min(k, 4)] += 1
    ctx.notes.append("verdicts a second in each fifth of the window: %s"
                     % " ".join("%.1f" % (5 * n / seconds) for n in fifths))
    device = {"platform": "gpu" if platform == "cuda" else platform,
              "kind": "cpu", "count": int(cell["chips"]),
              "memory_peak_bytes": max(mem)}
    if platform == "cuda":
        import torch

        device["kind"] = torch.cuda.get_device_name(0)
        ctx.notes.append("card: %s" % smi("name,power.limit"))
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
    numbers = judgement.numbers()
    result = {"correct": judgement.correct, "attempted": sent,
              "failed": (len(judgement.unanswered)
                         + len(fail_open | set(judgement.wrong))),
              "metrics": metrics, "device": device}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    result["compared"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                          for k in check.LIMITS}
    for line in ctx.notes:
        say(line)
    for rid in (judgement.wrong + judgement.unanswered)[:3]:
        say("req %d: got %s, want %s" % (rid, rec["verdict"].get(rid),
                                         judgement.want.get(rid)))
    for k in check.LIMITS:
        say("compared %s: %d (limit %d)" % (k, numbers[k], check.LIMITS[k]))
    return result


def _exit_on_signal(signum, _frame) -> None:
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wafbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a polite kill unwinds the run, so that it stops its children
    for sig in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, _exit_on_signal)
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        say("wafbench: the cell needs %d CUDA card(s); this machine has %d"
            % (cell["chips"], torch.cuda.device_count()
               if torch.cuda.is_available() else 0))
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        say("wafbench: loaded in the result's process: %s" % ", ".join(found))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
