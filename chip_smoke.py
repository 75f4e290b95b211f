#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to its plain
versions.

Run from the repository root:  python3 chip_smoke.py
(``--kernels-only`` stops after phases 1, 2 and 4 and the segment sweep:
a quick check of both kernels.)

Both kernels split each row's serial chain into segments
(``ingress_plus_tpu_torch/ops/segments.py``); every launch below runs at
the plan's segment length, and every shape the plan splits is also timed
at one segment (the same kernel unsplit) in the same run.

Phases (any failure ends the run with a non-zero exit code):

1. Build both kernels from ``ingress_plus_tpu_torch/csrc`` (one nvcc per
   source, started together; sm_90a) and print the card's name and power
   limit.
2. Pair kernel against plain, both configurations: the CUDA kernel
   (``ByteScanner`` raw-byte, ``PairScanner`` class-id) and the plain
   ``ops/scan.py::scan_pairs`` on the same CUDA tensors -- B=1024 seeded
   rows with attack substrings, L in {64, 2048, 16384}, ragged lengths
   (0, 1, odd, L), a carried-in sticky match and state; then B=8 rows
   at L in {2048, 16384}, which the plan splits, with lengths on segment
   boundaries (checked split and unsplit); then edge shapes (1001 rows,
   odd L, the largest class table).  Match and state must be
   bit-identical.  Then the segment sweep: both kernels at the
   row-starved shapes, timed at several segment lengths.
3. The main path: ``DetectionPipeline(device="cuda")`` (scan impl
   ``pallas3``) on the bundled pack at full width, over
   ``generate_corpus(n=2048, seed=20260729)`` plus 10 large-body requests
   (every L-bucket up to 16384 is hit), in batches of 256.  The same
   requests through ``DetectionPipeline(device="cpu")`` (the plain scan)
   must give identical (attack, blocked, sorted rule_ids, score, classes)
   for every request, and the kernel must have launched once per bucket.
   Then the kernel again on each of those launches' own buckets:
   bit-identical to the plain version, timed.
4. Step kernel against plain: ``StepScanner`` and the plain
   ``ops/scan.py::scan_bytes`` on the same CUDA tensors, at the shapes of
   phase 2 (the split ones included), on the edge shapes, and on a
   chained carry at B=1024 and at B=8, where the rows are split (rows cut
   at ragged points, scanned in two calls with the state carried, against
   one whole-row call).  Match and state must be bit-identical.
5. The batch path on ``scan_impl="pallas"`` (the step kernel) over the
   requests of phase 3: verdicts identical to phase 3's CPU pipeline, one
   launch per bucket, each launch re-run on its bucket and timed.
6. The stream lane: seven concurrent 1 MiB streams
   (``utils/stream_corpus.py``: benign form text, SQLi across a 64 KiB
   boundary, a split %-escape, a gzip body with an attack at its inflated
   tail, a base64 body, an attack only in the URI, a response leak),
   driven chunk by chunk through ``StreamEngine`` on the card and, in a
   child process (``chip_smoke.py --stream-cpu-reference``), on the CPU;
   verdicts identical, planted attacks found, none failed open, one
   kernel launch per wave.  While the child runs, every wave again on its
   own inputs: bit-identical to ``scan_bytes``, timed.
8. The serve plane: ``python -m ingress_plus_tpu_torch.serve`` with its
   defaults as a child process (platform cuda, scan impl auto =
   ``pallas3``, one inline confirm worker, warmup on); once ``/readyz``
   answers, phase 3's requests over the UDS wire protocol on several
   pipelined connections (``serve/client.py``), twice (two waves), then
   the response-leak body as a response-scan frame and the other six
   phase 6 bodies as chunked streams.  Every response must equal phase
   3's CPU pipeline verdict (for the bodies the Batcher reroutes to the
   stream lane: the CPU stream engine's on the whole body) and phase 6's
   CPU stream verdicts; ``/healthz`` must report the ``cuda`` backend and
   ``pallas3``; on ``/metrics`` breaker trips, CPU-fallback and
   breaker-open batches, sheds, degraded and fail-open verdicts,
   watchdog hangs and serve-time recompiles must all read 0 and
   ``engine_us`` above 0.  The server's launches by kernel and shape
   (``/debug/kernels``: (B, L, carried), launches, the work their
   lengths asked for, the latest launch's lengths) are read just before
   and just after the drive; their difference is this path's launches.
   Then the same two waves to a second server with ``--confirm-workers
   auto`` (the pooled confirm against the inline walk, one interpreter
   lock either way).  Prints wire req/s, client-side p50/p99, the
   server's stage breakdown, the confirm workers and the streamed MB/s.
   Then each kernel at every (B, L, carried) shape the serve path
   launched: rows of the wire traffic's own bytes cut to that shape's
   latest lengths, through the wrapper the server uses (``ByteScanner``,
   ``StepScanner``), bit-identical to the plain version, timed; the
   shape's time, the plain version's and the bound (from the work the
   server counted) over all its launches.
9. The compiler and the guarded rollout on the card.  The port's compiler
   builds, on this host: the bundled rules (held array for array against
   the committed pack, compile seconds logged), ``base`` (the port's
   ``rules/crs`` tree, as ``--rules-dir`` serves it), ``grow`` (base plus
   an operator's rule file of four @rx rules: another W and class
   count), ``lossy`` (base without ``942-sqli.conf``), ``overblock`` (base
   plus a rule that blocks benign fixtures) and ``tiny`` (the fault
   matrix's pack, W < 32).  Both kernels on the grow and tiny tables at
   the main path's shapes (phase 3's launches, phase 6's carried waves):
   bit-identical to ``scan_pairs`` / ``scan_bytes``.  Then the server
   with ``--rules-dir`` (base) and ``--lkg-dir``, its defaults otherwise:
   a wave of phase 3's requests plus six operator-rule requests; grow
   staged over ``/configuration/ruleset`` (small steps and minimums) —
   its admission report must equal the CPU pipeline's for the same pair
   of packs — and waves (the rerouted body left out) until ``/rollout``
   reads live, every wire verdict equal to the CPU verdict of base or of
   grow; a wave after live equal to grow's; overblock and lossy rejected
   at replay with serving unchanged; base staged and aborted mid-canary
   (rolled back, grow serving); base staged again and the server
   SIGKILLed mid-canary; the restart with the same ``--lkg-dir`` serves
   grow, every wire verdict grow's; every phase 8 health counter 0 on
   both servers.  Prints the admission stage seconds, admit-to-live, the
   waves' req/s and p50/p99, and re-times the first server's launches
   (both generations' serving cycles and the rollout's admission and
   shadow work, ``/debug/kernels?scope=rollout``) on grow's tables.
10. The fault matrix: ``run_fault_matrix()`` on a batcher on the card,
    every ported scenario ``ok`` with the card's invariants (breaker-open
    batches fail open, none blocks, nothing moves to the host); one line
    per scenario.
7. Read each kernel's compiled loop (SASS); print the kernels line, the
   nvidia-smi line and the result line.

Kernel times are device times: several launches captured in one CUDA
graph, CUDA events around the replay, the median of the replays, per
launch.  The plain versions' times are CUDA events around single
host-driven calls.  The bound is the larger of bytes over the HBM rate
and the recurrence's LOP3 / shift / shared-memory instruction counts over
the SM pipes' rates (see ``bound``); ``sass_loop_mix`` reports how many
instructions each compiled loop actually spends per step.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

BATCH = 256
SEED = 20260729
SCAN_B = 1024
SCAN_LS = (64, 2048, 16384)
#: row-starved shapes the segment plan splits (an 8-row bucket or wave)
SPLIT_B = 8
SPLIT_LS = (2048, 16384)
#: the segment sweep: (B, L) of the batch path's and the stream lane's
#: row-starved launches, each timed at these segment lengths below L
SWEEP_SHAPES = ((8, 512), (128, 256), (256, 256), (8, 2048), (16, 2048),
                (32, 2048), (8, 16384))
SWEEP_GS = (128, 256, 512, 1024, 2048, 4096)
TIMED_REPS = 25
#: published H100 SXM figures (the on-chip-measurement guide's table): the
#: HBM rate, and the 67 TFLOP/s float32 peak = SMs x 128 fp32 lanes x 2
#: flop x clock, which fixes the SM clocks per second, summed over the
#: card, that the per-SM pipe rates below run at
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
ALU_LANES = 64      # LOP3 / SHF / IADD3 pipe: lanes per SM per clock
ISSUE_LANES = 128   # 4 schedulers x one 32-lane instruction per clock
LDS_LANES = 32      # 32 banks x 4 B: one conflict-free warp-wide load/clock
#: per (row, word) of each recurrence, its bitwise parts fused into LOP3:
#: (LOP3, shifts, class-table reads) for one full pair and for the half
#: pair an odd length ends with (csrc/pair_scan.cu), and for one byte
#: (csrc/step_scan.cu)
FULL_PAIR = (5, 3, 2)
HALF_PAIR = (2, 1, 1)
ONE_BYTE = (2, 1, 1)
STREAM_BODY = 1 << 20       # BASELINE config #5: 1 MB POST bodies
STREAM_CHUNK = 64 << 10     # the chunk an oversized body is fed in
#: phase 8: pipelined client connections, units in flight on each (kept
#: small enough that no request queues past a fraction of the server's
#: default 250 ms deadline), and the limit on the server's startup
#: (kernel load, warmup)
SERVE_CONNECTIONS = 4
SERVE_WINDOW = 8
SERVE_START_S = 420
#: every series of these must read 0 after phase 8
SERVE_ZERO = ("ipt_breaker_trips_total", "ipt_cpu_fallback_batches_total",
              "ipt_breaker_fail_open_batches_total",
              "ipt_shed_total", "ipt_degraded_verdicts_total",
              "ipt_watchdog_hangs_total", "ipt_fail_open_total",
              "ipt_engine_recompiles_total")
ATTACKS = (b"1' UNION SELECT password FROM users--", b"<script>alert(1)</script>",
           b";cat /etc/passwd", b"../../etc/shadow", b"${jndi:ldap://x/a}")
#: phase 9: the staged rollout's knobs (per push: the ramp, the canary
#: and shadow minimums; the server's defaults otherwise), and the wire
#: traffic's concurrency there (half phase 8's in flight: a canary cycle
#: dispatches twice, once per generation, under the same 250 ms deadline)
ROLLOUT_KNOBS = {"steps": [0.1, 0.5, 1.0], "step_min_requests": 200,
                 "shadow_min_requests": 32, "shadow_sample": 0.25}
ROLLOUT_WINDOW = 4
#: the operator's rule file of the `grow` pack: four @rx rules on strings
#: the golden corpus and the benign fixtures never carry (a clean replay)
OPERATOR_RULES = r"""
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)wp-sync-backdoor\.php" \
    "id:960100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-rce'"
SecRule ARGS|REQUEST_BODY "@rx (?i)x-ipt-canary~probe=[0-9a-f]{8}" \
    "id:960110,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-generic'"
SecRule REQUEST_HEADERS:User-Agent "@rx (?i)zgrab-operator/\d+" \
    "id:960120,phase:1,block,severity:CRITICAL,tag:'attack-scanner'"
SecRule ARGS "@rx (?i)\{\{\s*ipt_ssti_marker\s*\}\}" \
    "id:960130,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-generic'"
"""
#: the `overblock` pack's extra rule: it blocks the GraphQL benign
#: fixtures, which the incumbent passes
OVERBLOCK_RULE = r"""
SecRule REQUEST_URI "@beginsWith /graphql" \
    "id:960200,phase:1,block,severity:CRITICAL,tag:'attack-generic'"
"""


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Per-call time (ms) of a host-driven function: the median over
    ``reps`` calls of CUDA-event time around one call, after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, inner: int = 20, reps: int = TIMED_REPS) -> float:
    """Device time (ms) of one launch: ``inner`` calls captured in one
    CUDA graph, so the host's per-call work is not timed; the median over
    ``reps`` replays of CUDA-event time, divided by ``inner``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(times)


def carried(B: int, W: int, rng: np.random.Generator):
    """A sparse sticky match and a carried state, uint32 (B, W)."""
    match = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    match[rng.random((B, W)) < 0.9] = 0        # sparse sticky bits
    state = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    return match, state


def scan_inputs(L: int, W: int, rng: np.random.Generator):
    """B rows of seeded printable bytes with attack substrings spliced
    in, lengths covering 0, 1, odd values and L, a sticky match and a
    carried state."""
    B = SCAN_B
    toks = rng.integers(32, 127, (B, L), dtype=np.uint8)
    for i in range(B):
        a = ATTACKS[i % len(ATTACKS)]
        if len(a) < L:
            at = int(rng.integers(0, L - len(a)))
            toks[i, at:at + len(a)] = np.frombuffer(a, np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:6] = [0, 1, 3, L - 1, L, L]
    lengths[6:40:2] |= 1                       # odd lengths
    return (toks, lengths) + carried(B, W, rng)


def split_inputs(L: int, W: int, rng: np.random.Generator):
    """SPLIT_B rows that the segment plan splits: lengths on segment
    boundaries (0, 1, G-1, G+1, 2G, 2G+33, L-1, L: odd and even), attack
    substrings spliced across segment starts, a sticky match and a
    carried state."""
    from ingress_plus_tpu_torch.ops.segments import plan_segments

    B, G = SPLIT_B, plan_segments(SPLIT_B, L, W).G
    toks = rng.integers(32, 127, (B, L), dtype=np.uint8)
    for i in range(B):
        a = ATTACKS[i % len(ATTACKS)]
        at = G * (1 + i % 3) - len(a) // 2 - i % 2
        toks[i, at:at + len(a)] = np.frombuffer(a, np.uint8)
    lengths = np.asarray([0, 1, G - 1, G + 1, 2 * G, 2 * G + 33, L - 1, L],
                         np.int32)
    return (toks, lengths) + carried(B, W, rng)


def forced(kernel, scanner):
    """``run(tokens, lengths, state=None, match=None, segment=None)``: the
    scanner's launch of ``kernel`` on raw bytes (its LUT and tiled class
    table), with the segment length forced when ``segment`` is given --
    ``L`` is the same launch unsplit."""
    t = scanner.tables

    def run(tokens, lengths, state=None, match=None, segment=None):
        return kernel(tokens, lengths, scanner.class_tiles, t.init_mask,
                      t.final_mask, byte_class=scanner.byte_class,
                      state=state, match=match, segment=segment)
    return run


def timed_plan(fn, B: int, L: int, W: int, inner: int = 20,
               reps: int = TIMED_REPS) -> dict:
    """Device time of ``fn(segment)`` at the plan's segment length and,
    when the plan splits, at one segment (the same kernel unsplit), one
    after the other on the same inputs."""
    from ingress_plus_tpu_torch.ops.segments import plan_segments

    plan = plan_segments(B, L, W)
    out = {"G": plan.G, "segments": plan.segments,
           "ms": device_ms(lambda: fn(None), inner, reps)}
    out["one_segment_ms"] = (device_ms(lambda: fn(L), inner, reps)
                             if plan.segments > 1 else out["ms"])
    return out


def bound(lengths: np.ndarray, L: int, W: int, K1: int,
          token_bytes: int, carried: bool, kernel: str = "pair") -> dict:
    """Least time for one call, with the work this call's lengths need
    (see ``bound_counts``)."""
    n = np.clip(lengths.astype(np.int64), 0, L)
    return bound_counts(lengths.shape[0], L, W, K1, token_bytes, carried,
                        kernel, int(n.sum()), int((n % 2).sum()))


def bound_counts(B: int, L: int, W: int, K1: int, token_bytes: int,
                 carried: bool, kernel: str, steps: int, odd: int,
                 launches: int = 1) -> dict:
    """Least time for ``launches`` calls of one (B, L) shape whose rows'
    lengths, clamped to [0, L], sum to ``steps`` with ``odd`` of them
    odd: the larger of bytes / HBM rate (each input read once, each
    output written once; state and match in only when ``carried``) and
    the recurrence's instructions over the SM pipe that runs them
    slowest: LOP3 on the ALU pipe, every instruction through issue,
    class-table reads through shared memory.  ``kernel`` "pair" counts
    full and half pairs, "step" one step per byte."""
    if kernel == "pair":
        full, half = W * ((steps - odd) // 2), W * odd
        lop3, shifts, lds = (f * full + h * half
                             for f, h in zip(FULL_PAIR, HALF_PAIR))
    else:
        lop3, shifts, lds = (c * W * steps for c in ONE_BYTE)
    nbytes = launches * (
        B * L * token_bytes + B * 4                # tokens, lengths
        + (2 * B * W * 4 if carried else 0)        # match + state in
        + 2 * B * W * 4                            # match + state out
        + K1 * W * 4 + 257 * 4 + 2 * W * 4)        # tables
    pipes = {"alu": lop3 / ALU_LANES,
             "issue": (lop3 + shifts + lds) / ISSUE_LANES,
             "lds": lds / LDS_LANES}
    pipe = max(pipes, key=pipes.get)
    t_ops = pipes[pipe] / SM_CLOCKS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
            "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pipe": pipe, "lop3": lop3, "shifts": shifts, "lds": lds,
            "bytes": nbytes}


def sass_loop_mix(lib_path, unit: str, reads_per_unit: int) -> dict:
    """Instructions per step in each kernel's scan loop, read from the
    built library's SASS (``cuobjdump -sass``): the innermost loop (a
    backward branch) with the most LOP3 (the recurrence's bitwise work;
    the loop that maps a window's tokens has the most loads but no LOP3),
    its steps counted as its 32-bit ``LDS`` (class-table reads) /
    ``reads_per_unit`` (2 per pair for the pair kernel, 1 per byte for the
    step kernel).  Says how far the compiled loop is from the
    recurrence's own count."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": "cuobjdump: %s" % e}
    ins_re = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        head = part.split("\n", 1)[0]
        name = ("step_scan" if "step_scan_kernel" in head
                else "raw_byte" if "ILb1E" in head else "class_id")
        ins, labels, pending = [], {}, []
        for line in part.splitlines():
            m = re.match(r"^\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = ins_re.match(line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                ins.append((addr, m.group(2), m.group(3)))
        loops = []
        for addr, op, args in ins:
            if op.startswith("BRA"):
                t = re.search(r"\((\.L_x_\d+)\)|(0x[0-9a-f]+)", args)
                to = (labels.get(t.group(1)) if t and t.group(1)
                      else int(t.group(2), 16) if t else None)
                if to is not None and to <= addr:
                    loops.append((to, addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] < lp[1] for o in loops)]
        best = None
        for lo, hi in inner:
            body = [op for a, op, _ in ins if lo <= a <= hi]
            lop3 = sum(op.startswith("LOP3") for op in body)
            table = sum(op == "LDS" for op in body)
            if table and (best is None or lop3 > best[0]):
                best = (lop3, table, body)
        if best is None:
            out[name] = {"error": "no loop with 32-bit LDS found"}
            continue
        steps = best[1] / reads_per_unit
        kinds = {"lop3": 0, "shift": 0, "lds": 0, "other": 0}
        for op in best[2]:
            kind = ("lop3" if op.startswith("LOP3")
                    else "shift" if op.startswith(("SHF", "IMAD.SHL"))
                    else "lds" if op.startswith("LDS") else "other")
            kinds[kind] += 1
        out[name] = {"%ss_per_iteration" % unit: steps,
                     "instructions_per_%s" % unit: len(best[2]) / steps,
                     **{"%s_per_%s" % (k, unit): v / steps
                        for k, v in kinds.items()}}
    return out


def phase_kernel(cr, dev: torch.device) -> dict:
    from ingress_plus_tpu_torch.ops.pair_scan import (
        PAIR_SCAN,
        ByteScanner,
        PairScanner,
    )
    from ingress_plus_tpu_torch.ops.scan import (
        ScanTables,
        classes_for,
        from_numpy_u32,
        scan_pairs,
    )

    tables = ScanTables.from_bitap(cr.tables, dev)
    W, K1 = tables.n_words, tables.class_table.shape[0]
    rng = np.random.default_rng(SEED)
    raw, cid = ByteScanner(tables), PairScanner(tables)
    raw_run = forced(PAIR_SCAN, raw)
    shapes = []
    for B, L in ([(SCAN_B, L) for L in SCAN_LS]
                 + [(SPLIT_B, L) for L in SPLIT_LS]):
        toks_np, len_np, match_np, state_np = (
            scan_inputs if B == SCAN_B else split_inputs)(L, W, rng)
        toks = torch.from_numpy(toks_np).to(dev)
        lens = torch.from_numpy(len_np).to(dev)
        match = from_numpy_u32(match_np, dev)
        state = from_numpy_u32(state_np, dev)
        m_ref, s_ref = scan_pairs(tables, toks, lens, state, match)
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: scan_pairs(tables, toks, lens, state,
                                              match),
                           reps=3 if L >= 8192 else 10)
        row = {"B": B, "L": L, "plain_ms": plain_ms}
        # the class-id launch alone: class ids mapped beforehand
        cls = classes_for(tables.byte_class, toks, lens).to(
            torch.int32).contiguous()
        runs = {
            "raw_byte": lambda seg: raw_run(toks, lens, state, match, seg),
            "class_id": lambda seg: PAIR_SCAN(
                cls, lens, cid.class_tiles, tables.init_mask,
                tables.final_mask, state=state, match=match, segment=seg)}
        for name, scanner in (("raw_byte", raw), ("class_id", cid)):
            outs = {"plan": scanner(toks, lens, state, match),
                    "one segment": runs[name](L)}
            torch.cuda.synchronize()
            for how, (m, s) in outs.items():
                if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                    raise SystemExit(
                        "kernel %s (%s) disagrees with scan_pairs at B=%d "
                        "L=%d: match diff words=%d state diff words=%d"
                        % (name, how, B, L, int((m != m_ref).sum()),
                           int((s != s_ref).sum())))
            m, s = outs["plan"]
            err = max(int((m.long() - m_ref.long()).abs().max()),
                      int((s.long() - s_ref.long()).abs().max()))
            tm = timed_plan(runs[name], B, L, W)
            b = bound(len_np, L, W, K1, 1 if name == "raw_byte" else 4,
                      carried=True)
            row[name] = {**tm, "max_abs_err": err, **b,
                         "parity": "bit-identical"}
            log("kernel pair_scan[%s] B=%d L=%d W=%d K1=%d G=%d (%d "
                "segments): bit-identical match+state; %.4f ms device "
                "(one segment %.4f ms; plain %.3f ms, bound %.4f ms by "
                "%s/%s, %.2fx)"
                % (name, B, L, W, K1, tm["G"], tm["segments"], tm["ms"],
                   tm["one_segment_ms"], plain_ms, b["bound_ms"],
                   b["bound_by"], b["pipe"], tm["ms"] / b["bound_ms"]))
        shapes.append(row)
    return {"shapes": shapes, "edges": edge_parity(tables, rng),
            "tables": tables}


def phase_segment_sweep(tables, dev: torch.device) -> dict:
    """Both kernels (raw-byte pair, step) at the row-starved shapes of the
    batch path and the stream lane, every row full, timed at each segment
    length of SWEEP_GS below L, at one segment and at the plan's length:
    the measurement the plan's warp target rests on."""
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.segments import plan_segments
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    W = tables.n_words
    rng = np.random.default_rng(SEED + 7)
    runs = {"pair_scan": forced(PAIR_SCAN, ByteScanner(tables)),
            "step_scan": forced(STEP_SCAN, StepScanner(tables))}
    out = []
    for B, L in SWEEP_SHAPES:
        toks = torch.from_numpy(
            rng.integers(32, 127, (B, L), dtype=np.uint8)).to(dev)
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        plan = plan_segments(B, L, W)
        for name, run in runs.items():
            ms = {G: device_ms(lambda: run(toks, lens, segment=G))
                  for G in sorted({g for g in SWEEP_GS if g < L}
                                  | {L, plan.G})}
            best = min(ms, key=ms.get)
            out.append({"kernel": name, "B": B, "L": L, "plan_G": plan.G,
                        "ms_by_G": ms, "best_G": best})
            log("sweep %s B=%d L=%d: %s ms by G; best G=%d, plan G=%d"
                % (name, B, L, json.dumps({g: round(v, 5)
                                           for g, v in ms.items()}),
                   best, plan.G))
    return {"shapes": out}


def edge_parity(tables, rng: np.random.Generator) -> str:
    """Shapes the main path does not produce but the kernel accepts: a
    row count that is no multiple of 8, an odd L (the plain version pads
    one dead column), and the largest class table (K+1 = 257: the raw
    byte table plus the dead row, fed byte values as class ids), which
    needs more than 48 KB of shared memory.  Bit-identical or fail."""
    from ingress_plus_tpu_torch.ops.cuda_build import tile_class_table
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32, scan_pairs

    dev = tables.byte_table.device
    B, L, W = 1001, 333, tables.n_words
    toks = torch.from_numpy(
        rng.integers(32, 127, (B, L), dtype=np.uint8)).to(dev)
    lens_np = rng.integers(0, L + 1, B).astype(np.int32)
    lens_np[:3] = [0, L, L - 1]
    lens = torch.from_numpy(lens_np).to(dev)
    match = from_numpy_u32(
        rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
        & np.uint32(0x01010101), dev)
    m, s = ByteScanner(tables)(toks, lens, match=match)
    m_ref, s_ref = scan_pairs(tables, torch.nn.functional.pad(toks, (0, 1)),
                              lens, match=match)
    raw = torch.cat([tables.byte_table,
                     torch.zeros_like(tables.byte_table[:1])]).contiguous()
    m2, s2 = PAIR_SCAN(toks.to(torch.int32).contiguous(), lens,
                       tile_class_table(raw), tables.init_mask,
                       tables.final_mask, match=match)
    torch.cuda.synchronize()
    for name, (a, b) in {"odd_B_odd_L": ((m, s), (m_ref, s_ref)),
                         "k1_257": ((m2, s2), (m_ref, s_ref))}.items():
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise SystemExit("kernel edge case %s disagrees with scan_pairs"
                             % name)
    log("kernel pair_scan edges: B=%d odd L=%d, K+1=257 class table: "
        "bit-identical match+state" % (B, L))
    return "bit-identical: B=%d, odd L=%d, K+1=257" % (B, L)


def large_body_requests(Request):
    """Requests whose bodies fill the 512, 2048 and 16384 buckets (and
    one past 16384, which the batched path truncates)."""
    rng = random.Random(SEED)
    out = []
    for i, size in enumerate((300, 450, 700, 1500, 3000, 6000, 12000,
                              16000, 16300, 20000)):
        filler = bytes(rng.choice(b"abcdefghijklmnopqrstuvwxyz0123456789")
                       for _ in range(size))
        payload = ATTACKS[i % len(ATTACKS)] if i % 2 == 0 else b"benign"
        at = rng.randrange(0, size - 64)
        body = (b"comment=" + filler[:at] + payload + filler[at:])
        out.append(Request(
            method="POST", uri="/api/v1/upload",
            headers={"host": "shop.example.com",
                     "content-type": "application/x-www-form-urlencoded",
                     "content-length": str(len(body))},
            body=body, request_id="large-%d" % i))
    return out


def run_pipeline(pl, requests):
    out = []
    for i in range(0, len(requests), BATCH):
        out.extend(pl.detect(requests[i:i + BATCH]))
    return out


def verdict_key(v) -> str:
    """What must agree between two verdicts, as JSON (so a child process
    can hand it over)."""
    return json.dumps([v.request_id, v.attack, v.blocked, sorted(v.rule_ids),
                       v.score, v.classes])


def check_verdicts(what: str, got, want_keys) -> None:
    bad = [(a.request_id, verdict_key(a), b)
           for a, b in zip(got, want_keys) if verdict_key(a) != b]
    if len(got) != len(want_keys) or bad:
        raise SystemExit("%s: verdicts differ between cuda and cpu on %d "
                         "requests, first: %s" % (what, len(bad), bad[:1]))
    if any(v.fail_open for v in got):
        raise SystemExit("%s: a cuda verdict failed open" % what)


def bucket_inputs(pl, requests):
    """The (tokens, lengths) of every launch a pipeline's run over
    ``requests`` made: its own bucketing of the same batches, one launch
    per bucket."""
    return [(tok, ln) for i in range(0, len(requests), BATCH)
            for tok, ln, _, _ in pl._build_scan_buckets(
                requests[i:i + BATCH])[0]]


def phase_pipeline(cr, dev: torch.device):
    from ingress_plus_tpu_torch.models.pipeline import (
        DetectionPipeline,
        PipelineStats,
    )
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    requests = [lr.request for lr in generate_corpus(n=2048, seed=SEED)]
    requests += large_body_requests(Request)
    gpu = DetectionPipeline(cr, device=dev, fail_open=False)
    cpu = DetectionPipeline(cr, device="cpu", fail_open=False)
    if dev.type == "cuda" and gpu.engine.scan_impl != "pallas3":
        raise SystemExit("cuda pipeline runs %r, not pallas3"
                         % gpu.engine.scan_impl)
    run_pipeline(gpu, requests[:BATCH])          # warm-up (not counted)
    torch.cuda.synchronize()
    gpu.stats = PipelineStats()
    PAIR_SCAN.launches = 0                       # count the main path only
    t0 = time.perf_counter()
    got = run_pipeline(gpu, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PAIR_SCAN.launches
    if launches <= 0:
        raise SystemExit("the cuda pipeline never launched the kernel")
    t1 = time.perf_counter()
    want = [verdict_key(v) for v in run_pipeline(cpu, requests)]
    cpu_wall = time.perf_counter() - t1
    check_verdicts("pallas3 pipeline", got, want)
    st = gpu.stats
    batches = -(-len(requests) // BATCH)
    res = {
        "requests": len(requests), "batches": batches,
        "identical_verdicts": len(requests),
        "attacks": sum(v.attack for v in got),
        "blocked": sum(v.blocked for v in got),
        "launches": launches,
        "launches_per_batch": launches / batches,
        "bucket_rows": {str(k): v for k, v in sorted(st.bucket_rows.items())},
        "truncated_rows": st.truncated_rows,
        "req_per_s_confirm_included": len(requests) / wall,
        "wall_s": wall,
        "prep_s": st.prep_us / 1e6, "engine_s": st.engine_us / 1e6,
        "confirm_s": st.confirm_us / 1e6,
        "cpu_pipeline_req_per_s": len(requests) / cpu_wall,
    }
    missing = [L for L in gpu.L_BUCKETS if L not in st.bucket_rows]
    if missing:
        raise SystemExit("L-buckets never hit: %s" % missing)
    log("pipeline: %d requests, identical verdicts cuda vs cpu, "
        "%d kernel launches; %.1f req/s on the card (host clock, confirm "
        "stage included; prep %.3fs engine %.3fs confirm %.3fs)"
        % (len(requests), launches, res["req_per_s_confirm_included"],
           res["prep_s"], res["engine_s"], res["confirm_s"]))
    inputs = bucket_inputs(gpu, requests)
    if len(inputs) != launches:
        raise SystemExit("the main path launched the kernel %d times for "
                         "%d buckets" % (launches, len(inputs)))
    return res, inputs, requests, want


def retime_launches(label: str, scanner, kernel, plain_fn, tables, inputs,
                    dev: torch.device, kind: str, inner: int = 20,
                    reps: int = 10) -> dict:
    """A kernel at each launch a path made, on that launch's own inputs
    ``(tokens, lengths[, state, match])``: parity of the ``scanner``'s
    launch with the plain version (match and state), device time at the
    plan's segment length and, where the plan splits, at one segment,
    the plain version's time (CUDA events around one host-driven call,
    the same call that gives the parity reference) and the bound
    (``kind`` "pair" or "step").  Totals are one pass over the path's
    launches."""
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32

    W, K1 = tables.n_words, tables.class_table.shape[0]
    run = forced(kernel, scanner)
    by_shape: dict = {}
    for inp in inputs:
        tok_np, len_np = inp[0], np.asarray(inp[1], np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev),
                torch.from_numpy(len_np).to(dev)]
        carried = len(inp) > 2
        if carried:
            args += [from_numpy_u32(inp[2], dev), from_numpy_u32(inp[3], dev)]
        m, s = scanner(*args)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m_ref, s_ref = plain_fn(*args)
        b.record()
        b.synchronize()
        B, L = args[0].shape
        if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
            raise SystemExit("%s: kernel disagrees with its plain version on "
                             "a launch B=%d L=%d" % (label, B, L))
        bd = bound(len_np, L, W, K1, 1, carried, kind)
        tm = timed_plan(lambda seg: run(*args, segment=seg), B, L, W,
                        inner, reps)
        agg = by_shape.setdefault("%dx%d" % (B, L), {
            "B": B, "L": L, "G": tm["G"], "segments": tm["segments"],
            "launches": 0, "ms": 0.0, "one_segment_ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0})
        agg["launches"] += 1
        agg["ms"] += tm["ms"]
        agg["one_segment_ms"] += tm["one_segment_ms"]
        agg["plain_ms"] += a.elapsed_time(b)
        for k in ("bound_ms", "ops_ms", "bytes_ms"):
            agg[k] += bd[k]
    total = {k: sum(a[k] for a in by_shape.values())
             for k in ("launches", "ms", "one_segment_ms", "plain_ms",
                       "bound_ms", "ops_ms", "bytes_ms")}
    total["bound_by"] = ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes")
    for key, a in sorted(by_shape.items(),
                         key=lambda kv: (kv[1]["L"], kv[1]["B"])):
        log("%s B=%d L=%d G=%d (%d segments): %d launches, bit-identical; "
            "%.4f ms device (one segment %.4f ms; plain %.3f ms, bound "
            "%.5f ms, %.1fx)"
            % (label, a["B"], a["L"], a["G"], a["segments"], a["launches"],
               a["ms"], a["one_segment_ms"], a["plain_ms"], a["bound_ms"],
               a["ms"] / a["bound_ms"]))
    log("%s total: %d launches, %.4f ms device (one segment %.4f ms; plain "
        "%.1f ms, bound %.5f ms by %s)"
        % (label, total["launches"], total["ms"], total["one_segment_ms"],
           total["plain_ms"], total["bound_ms"], total["bound_by"]))
    return {"shapes": by_shape, "total": total}


def phase_main_shapes(tables, inputs, dev: torch.device) -> dict:
    """The pair kernel at each launch of the main path (raw-byte
    configuration, as ``pallas3`` runs it)."""
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import scan_pairs

    return retime_launches(
        "main path", ByteScanner(tables), PAIR_SCAN,
        lambda t, n: scan_pairs(tables, t, n), tables, inputs, dev, "pair")


def phase_step_kernel(tables, dev: torch.device) -> dict:
    """The step kernel against ``scan_bytes`` at B=1024 x L in SCAN_LS
    (ragged lengths, carried state and sticky match) and at the split
    shapes (B=8, lengths on segment boundaries; checked split and
    unsplit), then the edge shapes and the chained carry at B=1024 and at
    B=8."""
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32, scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    scanner = StepScanner(tables)
    run = forced(STEP_SCAN, scanner)
    W, K1 = tables.n_words, tables.class_table.shape[0]
    rng = np.random.default_rng(SEED + 4)
    shapes = []
    for B, L in ([(SCAN_B, L) for L in SCAN_LS]
                 + [(SPLIT_B, L) for L in SPLIT_LS]):
        toks_np, len_np, match_np, state_np = (
            scan_inputs if B == SCAN_B else split_inputs)(L, W, rng)
        toks = torch.from_numpy(toks_np).to(dev)
        lens = torch.from_numpy(len_np).to(dev)
        match = from_numpy_u32(match_np, dev)
        state = from_numpy_u32(state_np, dev)
        m_ref, s_ref = scan_bytes(tables, toks, lens, state, match)
        outs = {"plan": scanner(toks, lens, state, match),
                "one segment": run(toks, lens, state, match, L)}
        torch.cuda.synchronize()
        for how, (m, s) in outs.items():
            if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                raise SystemExit(
                    "kernel step_scan (%s) disagrees with scan_bytes at B=%d "
                    "L=%d: match diff words=%d state diff words=%d"
                    % (how, B, L, int((m != m_ref).sum()),
                       int((s != s_ref).sum())))
        m, s = outs["plan"]
        err = max(int((m.long() - m_ref.long()).abs().max()),
                  int((s.long() - s_ref.long()).abs().max()))
        plain_ms = time_ms(lambda: scan_bytes(tables, toks, lens, state,
                                              match),
                           reps=2 if L >= 8192 else 5)
        tm = timed_plan(lambda seg: run(toks, lens, state, match, seg),
                        B, L, W)
        b = bound(len_np, L, W, K1, 1, carried=True, kernel="step")
        shapes.append({"B": B, "L": L, **tm, "plain_ms": plain_ms,
                       "max_abs_err": err, **b, "parity": "bit-identical"})
        log("kernel step_scan B=%d L=%d W=%d K1=%d G=%d (%d segments): "
            "bit-identical match+state; %.4f ms device (one segment %.4f "
            "ms; plain %.3f ms, bound %.4f ms by %s/%s, %.2fx)"
            % (B, L, W, K1, tm["G"], tm["segments"], tm["ms"],
               tm["one_segment_ms"], plain_ms, b["bound_ms"], b["bound_by"],
               b["pipe"], tm["ms"] / b["bound_ms"]))
    return {"shapes": shapes, "edges": step_edges(tables, rng),
            "chain": [chained_carry(tables, rng, B) for B in (SCAN_B,
                                                              SPLIT_B)]}


def step_edges(tables, rng: np.random.Generator) -> str:
    """A row count that is no multiple of 8, an odd L, and the largest
    class table (K+1 = 257: the raw byte table plus the dead row, reached
    through the identity LUT, so raw bytes are the class ids), which needs
    more than 48 KB of shared memory.  Bit-identical or fail."""
    from ingress_plus_tpu_torch.ops.cuda_build import tile_class_table
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32, scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    dev = tables.byte_table.device
    B, L, W = 1001, 333, tables.n_words
    toks = torch.from_numpy(
        rng.integers(0, 256, (B, L), dtype=np.uint8)).to(dev)
    lens_np = rng.integers(-2, L + 3, B).astype(np.int32)
    lens_np[:4] = [0, L, L - 1, 1]
    lens = torch.from_numpy(lens_np).to(dev)
    state = from_numpy_u32(
        rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32), dev)
    match = from_numpy_u32(
        rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
        & np.uint32(0x01010101), dev)
    m, s = StepScanner(tables)(toks, lens, state, match)
    m_ref, s_ref = scan_bytes(tables, toks, lens, state, match)
    raw = torch.cat([tables.byte_table,
                     torch.zeros_like(tables.byte_table[:1])]).contiguous()
    ident = torch.arange(257, dtype=torch.int32, device=dev)
    m2, s2 = STEP_SCAN(toks, lens, tile_class_table(raw), tables.init_mask,
                       tables.final_mask, byte_class=ident, state=state,
                       match=match)
    torch.cuda.synchronize()
    for name, (a, b) in {"odd_B_odd_L": ((m, s), (m_ref, s_ref)),
                         "k1_257": ((m2, s2), (m_ref, s_ref))}.items():
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise SystemExit("kernel step_scan edge case %s disagrees with "
                             "scan_bytes" % name)
    log("kernel step_scan edges: B=%d odd L=%d (lengths below 0 and past "
        "L), K+1=257 class table: bit-identical match+state" % (B, L))
    return "bit-identical: B=%d, odd L=%d, K+1=257" % (B, L)


def chained_carry(tables, rng: np.random.Generator, B: int) -> str:
    """B rows cut at ragged points (0, 1, odd, the whole row) and scanned
    in two calls, the first call's (state, match) carried into the second,
    must end in the words of one whole-row call, which must equal
    ``scan_bytes``.  A kernel that zeroed short rows' state would pass
    every match check and fail here; at B=8 the plan splits every call's
    rows, so the carried state crosses segments too."""
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32, scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import StepScanner

    dev = tables.byte_table.device
    L, W = 2048, tables.n_words
    toks_np, len_np, match_np, state_np = (
        scan_inputs if B == SCAN_B else split_inputs)(L, W, rng)
    n = np.clip(len_np, 0, L)
    cut = (rng.random(n.shape) * (n + 1)).astype(np.int32)
    if B == SCAN_B:
        cut[:8] = [0, 0, 1, min(1, n[3]), n[4], n[5] // 2 | 1, 0, n[7]]
    else:
        cut[[0, -1]] = [0, n[-1]]
    cut = np.minimum(cut, n)
    rest = np.zeros_like(toks_np)
    for i in range(n.shape[0]):
        rest[i, :n[i] - cut[i]] = toks_np[i, cut[i]:n[i]]
    scanner = StepScanner(tables)
    t = torch.from_numpy(toks_np).to(dev)
    state = from_numpy_u32(state_np, dev)
    match = from_numpy_u32(match_np, dev)
    m1, s1 = scanner(t, torch.from_numpy(cut).to(dev), state, match)
    m2, s2 = scanner(torch.from_numpy(rest).to(dev),
                     torch.from_numpy((n - cut).astype(np.int32)).to(dev),
                     s1, m1)
    whole = torch.from_numpy(n.astype(np.int32)).to(dev)
    wm, ws = scanner(t, whole, state, match)
    rm, rs = scan_bytes(tables, t, whole, state, match)
    torch.cuda.synchronize()
    if not (torch.equal(m2, wm) and torch.equal(s2, ws)):
        raise SystemExit("step_scan chained carry differs from the whole "
                         "scan: match diff words=%d state diff words=%d"
                         % (int((m2 != wm).sum()), int((s2 != ws).sum())))
    if not (torch.equal(wm, rm) and torch.equal(ws, rs)):
        raise SystemExit("step_scan whole scan differs from scan_bytes")
    log("kernel step_scan chained carry: B=%d L=%d rows cut at ragged "
        "points, two calls with the state carried == one call == scan_bytes "
        "(match+state)" % (n.shape[0], L))
    return "bit-identical: B=%d L=%d, two calls == one call" % (n.shape[0], L)


def phase_pallas_pipeline(cr, dev: torch.device, requests, want) -> dict:
    """The batch path on the step kernel (``scan_impl="pallas"``) over
    phase 3's requests, against phase 3's CPU verdicts."""
    from ingress_plus_tpu_torch.models.pipeline import (
        DetectionPipeline,
        PipelineStats,
    )
    from ingress_plus_tpu_torch.ops.scan import scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    gpu = DetectionPipeline(cr, device=dev, scan_impl="pallas",
                            fail_open=False)
    run_pipeline(gpu, requests[:BATCH])          # warm-up (not counted)
    torch.cuda.synchronize()
    gpu.stats = PipelineStats()
    STEP_SCAN.launches = 0                       # count this path only
    t0 = time.perf_counter()
    got = run_pipeline(gpu, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = STEP_SCAN.launches
    check_verdicts("pallas pipeline", got, want)
    inputs = bucket_inputs(gpu, requests)
    if launches <= 0 or launches != len(inputs):
        raise SystemExit("the pallas pipeline launched the step kernel %d "
                         "times for %d buckets" % (launches, len(inputs)))
    st = gpu.stats
    res = {"requests": len(requests), "identical_verdicts": len(requests),
           "launches": launches, "wall_s": wall,
           "req_per_s_confirm_included": len(requests) / wall,
           "prep_s": st.prep_us / 1e6, "engine_s": st.engine_us / 1e6,
           "confirm_s": st.confirm_us / 1e6}
    log("pallas pipeline: %d requests, identical verdicts to the cpu "
        "pipeline, %d step-kernel launches (= buckets); %.1f req/s (host "
        "clock, confirm included; engine %.3fs)"
        % (len(requests), launches, res["req_per_s_confirm_included"],
           res["engine_s"]))
    tables = gpu.engine.tables.scan
    res["retimed"] = retime_launches(
        "pallas path", StepScanner(tables), STEP_SCAN,
        lambda t, n: scan_bytes(tables, t, n), tables, inputs, dev, "step")
    return res


def phase_stream(cr, dev: torch.device) -> tuple:
    """Seven concurrent 1 MiB streams through ``StreamEngine`` on the card
    and on the CPU (BASELINE config #5), then every wave again on its own
    inputs.  Returns the result and the waves' inputs."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.scan import scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN
    from ingress_plus_tpu_torch.serve.stream import StreamEngine
    from ingress_plus_tpu_torch.utils.stream_corpus import (
        drive_streams,
        stream_cases,
    )

    class RecordingEngine(StreamEngine):
        """Keeps each wave's inputs, to re-run every launch on its own."""

        def __init__(self, pipeline):
            super().__init__(pipeline)
            self.recorded = []

        def _scan_wave(self, scanner, tokens, lengths, state, match):
            self.recorded.append((tokens.copy(), lengths.copy(),
                                  state.copy(), match.copy()))
            return super()._scan_wave(scanner, tokens, lengths, state, match)

    cases = stream_cases(STREAM_BODY, STREAM_CHUNK, SEED)
    wire = sum(len(c.body) for c in cases)
    gpu = DetectionPipeline(cr, device=dev, fail_open=False)
    warm = stream_cases(4096, 2048, SEED + 1)[:2]
    drive_streams(StreamEngine(gpu), warm, 2048)   # warm-up (not counted)
    torch.cuda.synchronize()
    eng = RecordingEngine(gpu)
    STEP_SCAN.launches = 0                          # count this path only
    t0 = time.perf_counter()
    got = drive_streams(eng, cases, STREAM_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = STEP_SCAN.launches
    st = eng.stats
    if launches <= 0 or launches != st.waves or launches != len(eng.recorded):
        raise SystemExit("the stream lane launched the step kernel %d times "
                         "for %d waves" % (launches, st.waves))
    # the CPU reference runs in a child process (one thread) while this
    # one re-times the waves; it is waited for, or killed, before return
    child = subprocess.Popen(
        [sys.executable, __file__, "--stream-cpu-reference"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tables = gpu.engine.tables.scan
        retimed = retime_launches(
            "stream wave", eng.scanner(), STEP_SCAN,
            lambda t, n, s, m: scan_bytes(tables, t, n, s, m), tables,
            eng.recorded, dev, "step", inner=10, reps=5)
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise SystemExit("the cpu stream reference failed:\n" + err[-4000:])
    ref = json.loads(out.strip().splitlines()[-1])
    check_verdicts("stream lane", got, ref["keys"])
    missed = [c.name for c, v in zip(cases, got) if v.attack != c.attack]
    if missed:
        raise SystemExit("stream lane: planted attacks missed or benign "
                         "bodies flagged: %s" % missed)
    if ref["waves"] != st.waves:
        raise SystemExit("the cpu stream lane ran %d waves, the card %d"
                         % (ref["waves"], st.waves))
    cpu_wall = ref["wall_s"]
    kernel_s = retimed["total"]["ms"] / 1e3
    res = {
        "streams": len(cases), "body_bytes": STREAM_BODY,
        "chunk_bytes": STREAM_CHUNK, "wire_bytes": wire,
        "identical_verdicts": len(cases),
        "verdicts": {c.name: [v.attack, v.fail_open, sorted(v.rule_ids)]
                     for c, v in zip(cases, got)},
        "waves": st.waves, "wave_rows": st.wave_rows,
        "scanned_bytes": st.scanned_bytes, "launches": launches,
        "wall_s": wall, "mb_per_s_confirm_included": wire / wall / 1e6,
        "split_s": {
            "begin_prefilter_feed": wall - (st.scan_us + st.finish_us) / 1e6,
            "scan_host": (st.scan_us - st.wave_us) / 1e6,
            "wave_round_trip": st.wave_us / 1e6,
            "of_which_kernel_device": kernel_s,
            "finish_confirm": st.finish_us / 1e6},
        "cpu_wall_s": cpu_wall, "cpu_mb_per_s": wire / cpu_wall / 1e6,
        "retimed": retimed, "cpu_keys": ref["keys"],
    }
    log("stream lane: %d streams x %d B in %d B chunks, identical verdicts "
        "cuda vs cpu, planted attacks found, none failed open; %d waves "
        "(%d rows, %d scanned bytes) = %d step-kernel launches; %.3f MB/s "
        "on the card (host clock, confirm included; split %s); cpu %.3f "
        "MB/s" % (len(cases), STREAM_BODY, STREAM_CHUNK, st.waves,
                  st.wave_rows, st.scanned_bytes, launches,
                  res["mb_per_s_confirm_included"],
                  json.dumps(res["split_s"]), res["cpu_mb_per_s"]))
    return res, eng.recorded


def stream_cpu_reference() -> int:
    """The stream lane of phase 6 on the CPU (the plain ``scan_bytes``),
    one thread; prints its verdict keys, waves and wall time as JSON."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.stream import StreamEngine
    from ingress_plus_tpu_torch.utils.stream_corpus import (
        drive_streams,
        stream_cases,
    )
    from ingress_plus_tpu_torch.weights import load_pack

    torch.set_num_threads(1)
    cpu = DetectionPipeline(load_pack(), device="cpu", fail_open=False)
    eng = StreamEngine(cpu)
    t0 = time.perf_counter()
    got = drive_streams(eng, stream_cases(STREAM_BODY, STREAM_CHUNK, SEED),
                        STREAM_CHUNK)
    print(json.dumps({"keys": [verdict_key(v) for v in got],
                      "waves": eng.stats.waves,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


def metric_values(text: str, name: str) -> list:
    """Every sample of one Prometheus metric: [(labels, value)]."""
    out = []
    for line in text.splitlines():
        m = re.match(r"^%s(\{[^}]*\})? (\S+)$" % re.escape(name), line)
        if m:
            out.append((m.group(1) or "", float(m.group(2))))
    return out


def kernel_launches(text: str) -> dict:
    return {re.search(r'kernel="(\w+)"', lab).group(1): int(v)
            for lab, v in metric_values(text, "ipt_kernel_launches_total")}


def http_get(port: int, path: str, timeout: float = 30.0):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def oversized_reference(cpu, request, plan):
    """The verdict the Batcher's oversized reroute gives ``request``,
    on the CPU: the whole body (inflated first for an "unpack" plan)
    through a ``StreamEngine`` of the CPU pipeline in 64 KiB chunks."""
    from dataclasses import replace

    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.stream import StreamEngine
    from ingress_plus_tpu_torch.serve.unpack import unpack_body

    kind, body, headers = plan
    if kind == "unpack":
        body = unpack_body(body, headers, request.parsers_off)
        headers = {k: v for k, v in headers.items()
                   if k.lower() != "content-encoding"}
    meta = replace(request, body=b"", headers=headers)
    eng = StreamEngine(cpu)
    st = eng.begin(meta, body_cap=len(body))
    st.base_hits = cpu.prefilter([meta])[0]
    for i in range(0, len(body), Batcher.OVERSIZE_CHUNK):
        eng.scan(st.feed(body[i:i + Batcher.OVERSIZE_CHUNK]))
    eng.scan(st.flush())
    return eng.finish(st)


def wire_key(request_id: str, resp: dict) -> str:
    """A decoded response frame as a ``verdict_key``."""
    return json.dumps([request_id, resp["attack"], resp["blocked"],
                       sorted(resp["rule_ids"]), resp["score"],
                       resp["classes"]])


class ServeChild:
    """``python -m ingress_plus_tpu_torch.serve`` with ``args`` as a child
    process on a temporary socket and a free HTTP port, ready once
    ``/readyz`` answers 200; stopped (terminate, then kill) on exit."""

    def __init__(self, *args: str):
        self.args = args

    def __enter__(self):
        self.tmp = tempfile.mkdtemp(prefix="ipt")
        self.sock = os.path.join(self.tmp, "serve.sock")
        if len(self.sock) > 100:
            raise SystemExit("serve: socket path too long for AF_UNIX: %s"
                             % self.sock)
        self.port = free_port()
        self.log_path = os.path.join(self.tmp, "serve.log")
        with open(self.log_path, "w") as logf:
            self.child = subprocess.Popen(
                [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
                 "--socket", self.sock, "--http-port", str(self.port),
                 *self.args],
                stdout=logf, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            t0 = time.perf_counter()
            while True:
                if self.child.poll() is not None:
                    raise SystemExit("serve: the server exited with %d:\n%s"
                                     % (self.child.returncode,
                                        self.log()[-4000:]))
                if time.perf_counter() - t0 > SERVE_START_S:
                    raise SystemExit("serve: not ready after %ds:\n%s"
                                     % (SERVE_START_S, self.log()[-4000:]))
                try:
                    if self.get("/readyz", 5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.25)
            self.startup_s = time.perf_counter() - t0
        except BaseException:
            self.__exit__(None, None, None)
            raise
        log("serve %s: ready in %.1fs (%s)" % (" ".join(self.args),
                                              self.startup_s, "; ".join(
            ln for ln in self.log().splitlines() if ln)))
        return self

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def get(self, path: str, timeout: float = 30.0):
        return http_get(self.port, path, timeout)

    def metrics(self) -> str:
        return self.get("/metrics")[1].decode()

    def __exit__(self, *exc):
        if self.child.poll() is None:
            self.child.terminate()
            try:
                self.child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.child.kill()
                self.child.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def request_wave(sock: str, requests, wants,
                 window: int = SERVE_WINDOW) -> dict:
    """``requests`` over the wire (SERVE_CONNECTIONS pipelined
    connections, ``window`` in flight on each); every response must
    equal its key in one of ``wants`` (one key list per generation that
    may serve it) and none may fail open.  Returns the wave's rate and
    latency, and how many responses matched only each generation."""
    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.protocol import encode_request

    # the large bodies go out spread over the first 80% of the wave, not
    # last: the server's admission queue math divides by an EWMA of its
    # cycle time that only running cycles update, so a wave ending on
    # slow cycles would leave the next wave shed on arrival
    small = [i for i, r in enumerate(requests) if len(r.body) < 4096]
    large = [i for i, r in enumerate(requests) if len(r.body) >= 4096]
    order = list(small)
    for j, i in enumerate(large):
        order.insert(int((j + 1) * 0.8 * len(small) / (len(large) + 1)), i)
    units = [(i + 1, [encode_request(requests[i], i + 1, mode=2)])
             for i in order]
    t0 = time.perf_counter()
    out = drive(sock, units, SERVE_CONNECTIONS, window, timeout=300)
    wall = time.perf_counter() - t0
    only = [0] * len(wants)
    bad = []
    for i, r in enumerate(requests):
        resp = out[i + 1][0]
        got = wire_key(r.request_id, resp)
        hit = [k for k, w in enumerate(wants) if w[i] == got]
        if resp["fail_open"] or not hit:
            bad.append((r.request_id, resp, [w[i] for w in wants]))
        elif len(hit) == 1:
            only[hit[0]] += 1
    if bad:
        raise SystemExit("serve: %d of %d wire verdicts differ from the cpu "
                         "reference, first: %s"
                         % (len(bad), len(requests), bad[:1]))
    lat = np.array([out[i + 1][1] for i in range(len(requests))]) * 1e3
    return {"requests": len(requests), "wall_s": wall,
            "wire_req_per_s": len(requests) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "only": only}


def check_serve_metrics(what: str, metrics: str) -> float:
    """Fail unless every SERVE_ZERO series reads 0 and engine_us is above
    0; returns engine_us."""
    nonzero = {n: v for n in SERVE_ZERO
               for v in metric_values(metrics, n) if v[1] != 0}
    if nonzero:
        raise SystemExit("serve %s: counters that must read 0 do not: %s"
                         % (what, nonzero))
    engine_us = metric_values(metrics, "ipt_engine_us_sum")[0][1]
    if engine_us <= 0:
        raise SystemExit("serve %s: engine_us is %s" % (what, engine_us))
    return engine_us


def kernel_shapes(srv, scope: str = "serve") -> dict:
    """The server's ``/debug/kernels`` of one launch scope: {kernel:
    {launches, shapes}}."""
    status, body = srv.get("/debug/kernels?scope=" + scope)
    if status != 200:
        raise SystemExit("serve: /debug/kernels answered %d" % status)
    return json.loads(body)


def shape_delta(before: dict, after: dict) -> dict:
    """{kernel: [shape]} of the launches made between two
    ``/debug/kernels`` reads: launches, work and odd rows as differences,
    the lengths of the latest launch; every launch's lengths must have
    come from the host, so the work is known for all of them."""
    out = {}
    for name, a in after.items():
        prev = {(s["B"], s["L"], s["carried"]): s
                for s in before[name]["shapes"]}
        rows = []
        for s in a["shapes"]:
            p = prev.get((s["B"], s["L"], s["carried"]))
            d = dict(s)
            for f in ("launches", "known", "steps", "odd_rows"):
                d[f] = s[f] - (p[f] if p else 0)
            if d["launches"] > 0:
                rows.append(d)
        if any(d["known"] != d["launches"] for d in rows):
            raise SystemExit("serve: %s launches without host lengths: %s"
                             % (name, rows))
        if sum(d["launches"] for d in rows) != (
                a["launches"] - before[name]["launches"]):
            raise SystemExit("serve: %s shape tally disagrees with its "
                             "launch count" % name)
        out[name] = rows
    return out


def traffic_pool(requests, cases) -> np.ndarray:
    """The bytes of the wire traffic (URIs, headers, bodies, stream
    bodies), concatenated: what re-timed rows are cut from."""
    parts = []
    for r in requests:
        parts.append(r.uri.encode("latin-1", "replace"))
        parts += [("%s: %s" % kv).encode("latin-1", "replace")
                  for kv in r.headers.items()]
        parts.append(r.body)
    parts += [c.body for c in cases]
    return np.frombuffer(b"\n".join(parts), np.uint8)


def retime_shapes(label: str, scanner, kernel, plain_fn, tables, shapes,
                  pool: np.ndarray, dev: torch.device, kind: str) -> dict:
    """A kernel at each (B, L, carried) shape another process launched
    it at (``shape_delta``): rows of ``pool`` cut to that shape's latest
    lengths (and a seeded carried state and sticky match where the
    launches carried one), through ``scanner`` -- parity with the plain
    version, device time at the plan's segment length and unsplit, the
    plain version's time (one host-driven call).  Each shape's times
    count once per launch of it; the bound counts the work that process's
    launches asked for.  Same result layout as ``retime_launches``."""
    from ingress_plus_tpu_torch.ops.scan import from_numpy_u32

    W, K1 = tables.n_words, tables.class_table.shape[0]
    run = forced(kernel, scanner)
    rng = np.random.default_rng(SEED + 8)
    by_shape: dict = {}
    err = 0
    for s in shapes:
        B, L, n = s["B"], s["L"], np.asarray(s["lengths"], np.int32)
        at = rng.integers(0, len(pool) - L, B)
        toks = np.stack([pool[a:a + L] for a in at])
        args = [torch.from_numpy(toks).to(dev), torch.from_numpy(n).to(dev)]
        if s["carried"]:
            match_np, state_np = carried(B, W, rng)
            args += [from_numpy_u32(state_np, dev),
                     from_numpy_u32(match_np, dev)]
        m, st = scanner(*args)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m_ref, s_ref = plain_fn(*args)
        b.record()
        b.synchronize()
        if not (torch.equal(m, m_ref) and torch.equal(st, s_ref)):
            raise SystemExit("%s: kernel disagrees with its plain version at "
                             "B=%d L=%d" % (label, B, L))
        err = max(err, int((m.long() - m_ref.long()).abs().max()),
                  int((st.long() - s_ref.long()).abs().max()))
        k = s["launches"]
        tm = timed_plan(lambda seg: run(*args, segment=seg), B, L, W,
                        reps=10)
        bd = bound_counts(B, L, W, K1, 1, s["carried"], kind, s["steps"],
                          s["odd_rows"], k)
        by_shape["%dx%d%s" % (B, L, "c" if s["carried"] else "")] = {
            "B": B, "L": L, "carried": s["carried"], "G": tm["G"],
            "segments": tm["segments"], "launches": k,
            "ms": k * tm["ms"], "one_segment_ms": k * tm["one_segment_ms"],
            "plain_ms": k * a.elapsed_time(b),
            **{f: bd[f] for f in ("bound_ms", "ops_ms", "bytes_ms")}}
    total = {f: sum(x[f] for x in by_shape.values())
             for f in ("launches", "ms", "one_segment_ms", "plain_ms",
                       "bound_ms", "ops_ms", "bytes_ms")}
    total["bound_by"] = ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes")
    total["max_abs_err"] = err
    for x in sorted(by_shape.values(), key=lambda x: (x["L"], x["B"])):
        log("%s B=%d L=%d%s G=%d (%d segments): %d launches, bit-identical; "
            "%.4f ms device (one segment %.4f ms; plain %.3f ms, bound "
            "%.5f ms, %.1fx)"
            % (label, x["B"], x["L"], " carried" if x["carried"] else "",
               x["G"], x["segments"], x["launches"], x["ms"],
               x["one_segment_ms"], x["plain_ms"], x["bound_ms"],
               x["ms"] / x["bound_ms"]))
    log("%s total: %d launches over %d shapes, %.4f ms device (one segment "
        "%.4f ms; plain %.1f ms, bound %.5f ms by %s)"
        % (label, total["launches"], len(by_shape), total["ms"],
           total["one_segment_ms"], total["plain_ms"], total["bound_ms"],
           total["bound_by"]))
    return {"shapes": by_shape, "total": total}


def phase_serve(requests, want, stream_keys, smi: str) -> dict:
    """The serve plane on the card, driven over the wire (phase 8) with
    the server's defaults; then the same requests against a
    ``--confirm-workers auto`` server, for the pooled confirm's effect
    under one interpreter lock."""
    import dataclasses

    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.normalize import Response
    from ingress_plus_tpu_torch.serve.protocol import (
        MODE_STREAM,
        encode_chunk,
        encode_request,
        encode_response_scan,
    )
    from ingress_plus_tpu_torch.utils.stream_corpus import stream_cases
    from ingress_plus_tpu_torch.utils.trace import (
        stage_breakdown_from_metrics,
    )
    from ingress_plus_tpu_torch.weights import load_pack

    cases = stream_cases(STREAM_BODY, STREAM_CHUNK, SEED)
    # the reference: phase 3's CPU verdicts, except for the bodies the
    # Batcher reroutes to the stream lane (no 16 KB truncation there)
    cpu = DetectionPipeline(load_pack(), device="cpu", fail_open=False)
    plan_of = SimpleNamespace(OVERSIZE_THRESHOLD=Batcher.OVERSIZE_THRESHOLD)
    want = list(want)
    rerouted = []
    for i, r in enumerate(requests):
        plan = Batcher._reroute_plan(plan_of, r)
        if plan is not None:
            want[i] = verdict_key(oversized_reference(cpu, r, plan))
            rerouted.append(r.request_id)
    if not rerouted:
        raise SystemExit("serve: no request is large enough to reroute")
    with ServeChild() as srv:
        path = json.loads(srv.get("/healthz")[1])["robustness"][
            "device_path"]
        if path["backend"] != "cuda" or path["scan_impl"] != "pallas3":
            raise SystemExit("serve: /healthz device_path %s, want backend "
                             "cuda and scan impl auto = pallas3" % path)
        shapes0 = kernel_shapes(srv)
        launches0 = kernel_launches(srv.metrics())
        waves = [request_wave(srv.sock, requests, [want])
                 for _ in range(2)]
        # the phase 6 bodies: the response leak as one response-scan
        # frame (rerouted to the stream lane), the others chunked
        sid = 100000
        leak = [c for c in cases if isinstance(c.meta, Response)]
        chunked = [c for c in cases if not isinstance(c.meta, Response)]
        t2 = time.perf_counter()
        got = drive(srv.sock, [(sid + i, [encode_response_scan(
            dataclasses.replace(c.meta, body=c.body), sid + i)])
            for i, c in enumerate(leak)], 1, 1, timeout=300)
        stream_units = []
        for j, c in enumerate(chunked):
            rid = sid + len(leak) + j
            frames = [encode_request(c.meta, rid, mode=2 | MODE_STREAM)]
            for off in range(0, len(c.body), STREAM_CHUNK):
                frames.append(encode_chunk(
                    rid, c.body[off:off + STREAM_CHUNK],
                    last=off + STREAM_CHUNK >= len(c.body)))
            stream_units.append((rid, frames))
        got.update(drive(srv.sock, stream_units, len(stream_units), 1,
                         timeout=300))
        stream_wall = time.perf_counter() - t2
        ref = dict(zip((c.name for c in cases), stream_keys))
        for k, c in enumerate(leak + chunked):
            resp = got[sid + k][0]
            if resp["fail_open"] or \
                    wire_key(c.meta.request_id, resp) != ref[c.name]:
                raise SystemExit("serve: stream %s differs from the cpu "
                                 "reference: %s vs %s"
                                 % (c.name, resp, ref[c.name]))
        metrics = srv.metrics()
        shapes1 = kernel_shapes(srv)
        launches1 = kernel_launches(metrics)
        startup_s = srv.startup_s
    engine_us = check_serve_metrics("defaults", metrics)
    launches = {k: launches1.get(k, 0) - launches0.get(k, 0)
                for k in ("pair_scan", "step_scan")}
    if launches["pair_scan"] <= 0 or launches["step_scan"] <= 0:
        raise SystemExit("serve: kernels of the path never launched: %s"
                         % launches)
    shapes = shape_delta(shapes0, shapes1)
    workers = int(metric_values(metrics, "ipt_confirm_workers")[0][1])
    with ServeChild("--confirm-workers", "auto") as pooled:
        auto_waves = [request_wave(pooled.sock, requests, [want])
                      for _ in range(2)]
        auto_metrics = pooled.metrics()
    check_serve_metrics("--confirm-workers auto", auto_metrics)
    wire = sum(len(c.body) for c in cases)
    res = {
        "card": smi, "scan_impl": path["scan_impl"], "startup_s": startup_s,
        "requests": len(requests), "identical_verdicts": len(requests),
        "rerouted_to_stream_lane": rerouted,
        "connections": SERVE_CONNECTIONS, "window": SERVE_WINDOW,
        **waves[0], "second_wave": waves[1],
        "stage_breakdown": stage_breakdown_from_metrics(metrics),
        "engine_us_sum": engine_us,
        "confirm_workers": workers,
        "streams": len(cases), "stream_wire_bytes": wire,
        "stream_wall_s": stream_wall,
        "stream_mb_per_s": wire / stream_wall / 1e6,
        "launches": launches,
        "device_path": path,
        "confirm_workers_auto": {
            "confirm_workers": int(metric_values(
                auto_metrics, "ipt_confirm_workers")[0][1]),
            "waves": auto_waves,
            "stage_breakdown": stage_breakdown_from_metrics(auto_metrics)},
    }
    log("serve: %d requests over %d connections x %d in flight, identical "
        "to the cpu reference (%d rerouted to the stream lane); %.1f / %.1f "
        "req/s on the wire (two waves), p50 %.2f ms p99 %.2f ms; 7 streams "
        "identical, %.3f MB/s; %d confirm worker(s); kernel launches %s; "
        "--confirm-workers auto (%d): %.1f / %.1f req/s, p50 %.2f ms p99 "
        "%.2f ms"
        % (len(requests), SERVE_CONNECTIONS, SERVE_WINDOW, len(rerouted),
           waves[0]["wire_req_per_s"], waves[1]["wire_req_per_s"],
           waves[0]["p50_ms"], waves[0]["p99_ms"], res["stream_mb_per_s"],
           workers, launches, res["confirm_workers_auto"]["confirm_workers"],
           auto_waves[0]["wire_req_per_s"], auto_waves[1]["wire_req_per_s"],
           auto_waves[0]["p50_ms"], auto_waves[0]["p99_ms"]))
    return res, shapes, traffic_pool(requests, cases)


def phase_serve_kernels(tables, shapes, pool, dev: torch.device) -> dict:
    """Both kernels at the serve path's own shapes (phase 8's
    ``shape_delta``): the pair kernel as ``pallas3`` runs it
    (``ByteScanner``), the step kernel as the stream lane does."""
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import scan_bytes, scan_pairs
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    return {
        "pair_scan": retime_shapes(
            "serve pair", ByteScanner(tables), PAIR_SCAN,
            lambda t, n, *c: scan_pairs(tables, t, n, *c), tables,
            shapes["pair_scan"], pool, dev, "pair"),
        "step_scan": retime_shapes(
            "serve step", StepScanner(tables), STEP_SCAN,
            lambda t, n, *c: scan_bytes(tables, t, n, *c), tables,
            shapes["step_scan"], pool, dev, "step")}


def segment_rows(path: str, shapes) -> list:
    """Each shape's segment plan and times, for the kernels line."""
    return [{"path": path, "launches": a.get("launches", 0),
             **{k: a[k] for k in ("B", "L", "G", "segments", "ms",
                                  "one_segment_ms")}} for a in shapes]


def operator_requests(Request):
    """Requests only the operator's rules flag (and a benign twin each):
    after the promote their wire verdicts must change."""
    out = []
    for i, (uri, ua) in enumerate((
            ("/wp-content/plugins/wp-sync-backdoor.php?x=1", "curl/8.0"),
            ("/api/echo?q=x-ipt-canary~probe=deadbeef", "curl/8.0"),
            ("/index.html", "zgrab-operator/2"),
            ("/render?name=%7B%7B+ipt_ssti_marker+%7D%7D", "curl/8.0"),
            ("/wp-content/plugins/wp-sync.php?x=1", "curl/8.0"),
            ("/api/echo?q=x-ipt-canary-probe", "curl/8.0"))):
        out.append(Request(uri=uri, headers={"host": "shop.example.com",
                                             "user-agent": ua},
                           request_id="operator-%d" % i))
    return out


def compile_rollout_packs(root: str) -> tuple:
    """The packs phase 9 stages, compiled by the port's compiler on this
    host: the bundled rules (held array for array against the committed
    pack), ``base`` (the port's ``rules/crs`` tree, as ``--rules-dir``
    serves it), ``grow`` (base plus the operator's rule file), ``lossy``
    (base without ``942-sqli.conf``), ``overblock`` (base plus a rule
    that blocks benign fixtures) and ``tiny`` (the fault matrix's pack,
    W < 32).  Each tree is a copy under ``root``; each pack is saved
    there for the pushes."""
    from ingress_plus_tpu_torch.compiler import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir
    from ingress_plus_tpu_torch.compiler.sigpack import (
        RULES_DIR,
        load_bundled_rules,
    )
    from ingress_plus_tpu_torch.utils.faults import _matrix_ruleset
    from ingress_plus_tpu_torch.weights import load_pack

    t0 = time.perf_counter()
    rules = load_bundled_rules()
    t1 = time.perf_counter()
    bundled = compile_ruleset(rules)
    t2 = time.perf_counter()
    want = load_pack()
    fields = ([(bundled.tables, want.tables, f) for f in (
        "byte_table", "init_mask", "final_mask", "factor_word", "factor_bit",
        "factor_rule_indptr", "factor_rule_ids", "rule_nfactors",
        "factor_len")] + [(bundled, want, f) for f in (
            "rule_sv_mask", "rule_class", "rule_score", "rule_action",
            "rule_paranoia", "rule_ids")])
    for a, b, f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise SystemExit("rollout: the port's compile of the bundled "
                             "rules differs from the committed pack in %s"
                             % f)
    if ([m.confirm for m in bundled.rules] != [m.confirm for m in want.rules]
            or bundled.version != want.version
            or (bundled.tables.n_head_words, bundled.tables.n_prefix_shared)
            != (want.tables.n_head_words, want.tables.n_prefix_shared)):
        raise SystemExit("rollout: the bundled compile's descriptors differ "
                         "from the committed pack")
    out = {"bundled_parse_s": t1 - t0, "bundled_compile_s": t2 - t1,
           "bundled_rules": bundled.n_rules}
    trees = {"base": {}, "grow": {"add": OPERATOR_RULES},
             "lossy": {"drop": "942-sqli.conf"},
             "overblock": {"add": OVERBLOCK_RULE}}
    packs = {}
    for name, kw in trees.items():
        shutil.copytree(RULES_DIR, os.path.join(root, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
        crs = os.path.join(root, name, "crs")
        if "drop" in kw:
            os.unlink(os.path.join(crs, kw["drop"]))
        if "add" in kw:
            with open(os.path.join(crs, "960-operator.conf"), "w") as f:
                f.write(kw["add"])
        t0 = time.perf_counter()
        packs[name] = compile_ruleset(load_seclang_dir(crs))
        out["%s_compile_s" % name] = time.perf_counter() - t0
    packs["tiny"] = _matrix_ruleset()
    for name, cr in packs.items():
        cr.save(os.path.join(root, "pack-" + name))
        out[name] = {"rules": cr.n_rules, "W": cr.tables.n_words,
                     "version": cr.version}
    out["paths"] = {n: os.path.join(root, "pack-" + n) for n in packs}
    out["rules_dir"] = os.path.join(root, "base", "crs")
    log("rollout packs: bundled %d rules parse %.2fs compile %.2fs, equal "
        "to the committed pack; %s"
        % (bundled.n_rules, out["bundled_parse_s"], out["bundled_compile_s"],
           "; ".join("%s %d rules W=%d" % (n, cr.n_rules, cr.tables.n_words)
                     for n, cr in packs.items())))
    return packs, out


def phase_rollout_kernels(packs, main_inputs, waves, dev) -> dict:
    """Both kernels on the ``grow`` and ``tiny`` tables (another W and
    class count than the bundled pack's) at the main path's shapes: each
    (B, L) of phase 3's launches through ``ByteScanner`` against
    ``scan_pairs``, each stream-wave shape of phase 6 through
    ``StepScanner`` against ``scan_bytes`` with a carried state and
    sticky match of the pack's width.  Bit-identical or fail."""
    from ingress_plus_tpu_torch.ops.pair_scan import ByteScanner
    from ingress_plus_tpu_torch.ops.scan import (
        ScanTables,
        from_numpy_u32,
        scan_bytes,
        scan_pairs,
    )
    from ingress_plus_tpu_torch.ops.step_scan import StepScanner

    rng = np.random.default_rng(SEED + 9)
    pair_in = {tuple(t.shape): (t, n) for t, n in main_inputs}
    step_in = {tuple(w[0].shape): w for w in waves}
    out = {}
    for name in ("grow", "tiny"):
        tables = ScanTables.from_bitap(packs[name].tables, dev)
        W, K1 = tables.n_words, tables.class_table.shape[0]
        checked = []
        for (B, L), (tok, n) in sorted(pair_in.items()):
            t = torch.from_numpy(np.ascontiguousarray(tok)).to(dev)
            ln = torch.from_numpy(np.asarray(n, np.int32)).to(dev)
            m, s = ByteScanner(tables)(t, ln)
            m_ref, s_ref = scan_pairs(tables, t, ln)
            torch.cuda.synchronize()
            if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                raise SystemExit("rollout: pair kernel differs from "
                                 "scan_pairs on %s at B=%d L=%d" % (name, B,
                                                                     L))
            checked.append("pair %dx%d" % (B, L))
        for (B, L), (tok, n, _s, _m) in sorted(step_in.items()):
            match_np, state_np = carried(B, W, rng)
            t = torch.from_numpy(np.ascontiguousarray(tok)).to(dev)
            ln = torch.from_numpy(np.asarray(n, np.int32)).to(dev)
            st = from_numpy_u32(state_np, dev)
            mt = from_numpy_u32(match_np, dev)
            m, s = StepScanner(tables)(t, ln, st, mt)
            m_ref, s_ref = scan_bytes(tables, t, ln, st, mt)
            torch.cuda.synchronize()
            if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                raise SystemExit("rollout: step kernel differs from "
                                 "scan_bytes on %s at B=%d L=%d carried"
                                 % (name, B, L))
            checked.append("step %dx%d carried" % (B, L))
        out[name] = {"W": W, "K1": K1, "checked": checked}
        log("rollout kernels on %s (W=%d, K+1=%d): bit-identical match and "
            "state at %s" % (name, W, K1, ", ".join(checked)))
    return out


def reference_keys(cr, requests) -> tuple:
    """The port's CPU verdict keys of ``requests`` on pack ``cr``, with
    the Batcher's oversized reroute applied (as phase 8 does), and the
    indices of the rerouted requests."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    cpu = DetectionPipeline(cr, device="cpu", fail_open=False)
    keys = [verdict_key(v) for v in run_pipeline(cpu, requests)]
    plan_of = SimpleNamespace(OVERSIZE_THRESHOLD=Batcher.OVERSIZE_THRESHOLD)
    rerouted = []
    for i, r in enumerate(requests):
        plan = Batcher._reroute_plan(plan_of, r)
        if plan is not None:
            keys[i] = verdict_key(oversized_reference(cpu, r, plan))
            rerouted.append(i)
    return keys, rerouted


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 300.0):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def merge_shapes(*deltas) -> dict:
    """{kernel: [shape]} summed over several ``shape_delta`` results."""
    out: dict = {}
    for d in deltas:
        for name, rows in d.items():
            acc = out.setdefault(name, {})
            for s in rows:
                k = (s["B"], s["L"], s["carried"])
                if k not in acc:
                    acc[k] = dict(s)
                    continue
                for f in ("launches", "known", "steps", "odd_rows"):
                    acc[k][f] += s[f]
                acc[k]["lengths"] = s["lengths"]
    return {n: list(acc.values()) for n, acc in out.items()}


def drive_until(srv, requests, wants, states, limit_s: float = 240.0):
    """Waves of ``requests`` until ``/rollout`` reads one of ``states``;
    returns the waves' stats (each with the state it ended in)."""
    out = []
    t0 = time.perf_counter()
    while True:
        st = http_json(srv.port, "GET", "/rollout")[1]
        if st["state"] in states:
            return out, st
        if time.perf_counter() - t0 > limit_s:
            raise SystemExit("rollout: /rollout still %s after %.0fs (%s)"
                             % (st["state"], limit_s, st.get(
                                 "rollback_reason")))
        w = request_wave(srv.sock, requests, wants, ROLLOUT_WINDOW)
        w["state_before"] = st["state"]
        w["fraction_before"] = st["fraction"]
        out.append(w)


def event_time(status: dict, event: str, which: int = -1) -> float:
    ts = [e["ts"] for e in status["history"] if e["event"] == event]
    if not ts:
        raise SystemExit("rollout: no %r event in /rollout history" % event)
    return ts[which]


def phase_rollout(requests, main_inputs, waves, smi: str,
                  dev: torch.device) -> tuple:
    """Phase 9: the compiler and the guarded rollout on the card (see
    the module docstring).  Returns the result, the first server's
    launches by kernel and shape, and the packs."""
    root = tempfile.mkdtemp(prefix="ipt-rollout")
    try:
        return _phase_rollout(root, requests, main_inputs, waves, smi, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_rollout(root, requests, main_inputs, waves, smi, dev):
    from ingress_plus_tpu_torch.control.rollout import (
        RolloutConfig,
        RolloutController,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request

    packs, info = compile_rollout_packs(root)
    kern = phase_rollout_kernels(packs, main_inputs, waves, dev)
    traffic = list(requests) + operator_requests(Request)
    t0 = time.perf_counter()
    keys, rerouted = {}, set()
    for n in ("base", "grow"):
        keys[n], rr = reference_keys(packs[n], traffic)
        rerouted.update(rr)
    ref_s = time.perf_counter() - t0
    changed = sum(a != b for a, b in zip(keys["base"], keys["grow"]))
    if changed < 4:
        raise SystemExit("rollout: grow changes only %d verdicts" % changed)
    # the canary waves leave out the bodies the Batcher reroutes to the
    # stream lane: a promote fails an in-flight stream open by design
    calm = [i for i in range(len(traffic)) if i not in rerouted]
    calm_reqs = [traffic[i] for i in calm]
    calm_keys = {n: [k[i] for i in calm] for n, k in keys.items()}
    # the CPU pipeline's admission report for the same pair of packs
    cpu_inc = DetectionPipeline(packs["base"], device="cpu")
    cpu_cand = DetectionPipeline(packs["grow"], device="cpu")
    cpu_ro = RolloutController(
        SimpleNamespace(pipeline=cpu_inc,
                        _cpu_fallback_ok=Batcher._cpu_fallback_ok),
        RolloutConfig())
    cpu_report = cpu_ro._replay_diff(cpu_inc, cpu_cand)
    lkg = os.path.join(root, "lkg")
    args = ("--rules-dir", info["rules_dir"], "--lkg-dir", lkg)
    res = {"card": smi, "packs": info, "kernels": kern,
           "reference_s": ref_s, "verdicts_grow_changes": changed,
           "knobs": ROLLOUT_KNOBS, "window": ROLLOUT_WINDOW}
    with ServeChild(*args) as srv:
        res["startup_s"] = srv.startup_s
        conf = http_json(srv.port, "GET", "/configuration")[1]
        if conf["ruleset"] != packs["base"].version:
            raise SystemExit("rollout: --rules-dir serves %s, not the base "
                             "compile %s" % (conf["ruleset"],
                                             packs["base"].version))
        serve0, ro0 = kernel_shapes(srv), kernel_shapes(srv, "rollout")
        res["before"] = request_wave(srv.sock, traffic, [keys["base"]],
                                     ROLLOUT_WINDOW)
        # stage grow: admission on the card
        t0 = time.perf_counter()
        status, rep = http_json(srv.port, "POST", "/configuration/ruleset",
                                {"path": info["paths"]["grow"],
                                 **ROLLOUT_KNOBS})
        res["admit_http_s"] = time.perf_counter() - t0
        if status != 200 or not rep.get("staged"):
            raise SystemExit("rollout: grow was not admitted: %d %s"
                             % (status, rep))
        if rep["replay"] != cpu_report:
            raise SystemExit("rollout: the card's admission report %s "
                             "differs from the cpu pipeline's %s"
                             % (rep["replay"], cpu_report))
        st = http_json(srv.port, "GET", "/rollout")[1]
        res["admission_s"] = st["admission_s"]
        res["replay"] = rep["replay"]
        canary, st = drive_until(srv, calm_reqs,
                                 [calm_keys["base"], calm_keys["grow"]],
                                 ("live", "rolled_back", "rejected"))
        if st["state"] != "live":
            raise SystemExit("rollout: grow ended %s (%s)"
                             % (st["state"], st["rollback_reason"]))
        res["canary_waves"] = canary
        res["admit_to_live_s"] = (event_time(st, "live")
                                  - event_time(st, "admitted"))
        res["rollout_status"] = {k: st[k] for k in (
            "candidate_requests", "candidate_failures",
            "candidate_fail_open", "shadow", "diff", "promotions")}
        conf = http_json(srv.port, "GET", "/configuration")[1]
        if conf["ruleset"] != packs["grow"].version:
            raise SystemExit("rollout: live but serving %s" % conf["ruleset"])
        res["after"] = request_wave(srv.sock, traffic, [keys["grow"]],
                                    ROLLOUT_WINDOW)
        # rejections: nothing changes
        res["rejected"] = {}
        for name, stage, reason in (("overblock", "replay", "benign_blocks"),
                                    ("lossy", "replay", "new_fns")):
            status, body = http_json(srv.port, "POST",
                                     "/configuration/ruleset",
                                     {"path": info["paths"][name],
                                      **ROLLOUT_KNOBS})
            if status != 422 or (body.get("stage"), body.get("reason")) != (
                    stage, reason):
                raise SystemExit("rollout: %s was not rejected at %s/%s: "
                                 "%d %s" % (name, stage, reason, status,
                                            body))
            res["rejected"][name] = {k: body[k] for k in ("stage", "reason")}
            res["rejected"][name]["detail"] = {
                k: body["detail"][k] for k in ("new_fns", "benign_new_blocks",
                                               "new_blocks", "score_deltas")}
            if http_json(srv.port, "GET", "/configuration")[1][
                    "ruleset"] != packs["grow"].version:
                raise SystemExit("rollout: rejecting %s changed serving"
                                 % name)
        # base again, aborted mid-canary
        status, body = http_json(srv.port, "POST", "/configuration/ruleset",
                                 {"path": info["paths"]["base"],
                                  **ROLLOUT_KNOBS,
                                  "step_min_requests": 1 << 30})
        if status != 200:
            raise SystemExit("rollout: base was not admitted over grow: %d "
                             "%s" % (status, body))
        part = calm_reqs[:512]
        part_keys = [k[:512] for k in (calm_keys["grow"], calm_keys["base"])]
        drive_until(srv, part, part_keys, ("canary",))
        request_wave(srv.sock, part, part_keys, ROLLOUT_WINDOW)
        status, body = http_json(srv.port, "POST", "/rollout",
                                 {"action": "abort"})
        if not body.get("aborted") or body["state"] != "rolled_back":
            raise SystemExit("rollout: abort mid-canary failed: %s" % body)
        res["abort"] = {"state": body["state"],
                        "reason": body["rollback_reason"],
                        "candidate_requests": body["candidate_requests"]}
        request_wave(srv.sock, part, [part_keys[0]], ROLLOUT_WINDOW)
        # base once more, SIGKILL mid-canary
        status, body = http_json(srv.port, "POST", "/configuration/ruleset",
                                 {"path": info["paths"]["base"],
                                  **ROLLOUT_KNOBS,
                                  "step_min_requests": 1 << 30})
        if status != 200:
            raise SystemExit("rollout: base was not admitted again: %d %s"
                             % (status, body))
        drive_until(srv, part, part_keys, ("canary",))
        metrics = srv.metrics()
        serve1, ro1 = kernel_shapes(srv), kernel_shapes(srv, "rollout")
        srv.child.kill()
        srv.child.wait()
        res["killed_in"] = "canary"
    check_serve_metrics("rollout (first server)", metrics)
    shapes = merge_shapes(shape_delta(serve0, serve1),
                          shape_delta(ro0, ro1))
    res["launches"] = {
        "serve_scope": {k: serve1[k]["launches"] - serve0[k]["launches"]
                        for k in serve1},
        "rollout_scope": {k: ro1[k]["launches"] - ro0[k]["launches"]
                          for k in ro1}}
    with ServeChild(*args) as srv:
        conf = http_json(srv.port, "GET", "/configuration")[1]
        if conf["ruleset"] != packs["grow"].version:
            raise SystemExit("rollout: the restart serves %s, not the LKG "
                             "grow %s" % (conf["ruleset"],
                                          packs["grow"].version))
        res["restart"] = request_wave(srv.sock, traffic, [keys["grow"]],
                                      ROLLOUT_WINDOW)
        res["restart_startup_s"] = srv.startup_s
        check_serve_metrics("rollout (restart)", srv.metrics())
    b, c = res["before"], res["canary_waves"]
    log("rollout: base %s -> grow %s live in %.1fs after admission "
        "(admission %s s on the card; replay equal to the cpu pipeline's: "
        "%s); overblock and lossy rejected at replay; base aborted "
        "mid-canary; SIGKILL mid-canary, the restart serves grow from the "
        "LKG; wire %.1f req/s before (p50 %.2f p99 %.2f ms), %s during the "
        "canary; launches %s"
        % (packs["base"].version, packs["grow"].version,
           res["admit_to_live_s"], json.dumps(res["admission_s"]),
           json.dumps(res["replay"]), b["wire_req_per_s"], b["p50_ms"],
           b["p99_ms"], ", ".join("%.1f req/s (p50 %.2f p99 %.2f ms, %s %s)"
                                  % (w["wire_req_per_s"], w["p50_ms"],
                                     w["p99_ms"], w["state_before"],
                                     w["fraction_before"]) for w in c),
           json.dumps(res["launches"])))
    return res, shapes, packs


def phase_rollout_timing(packs, shapes, pool, dev: torch.device) -> dict:
    """Both kernels at every shape phase 9's first server launched
    (serving cycles of both generations and the rollout's admission and
    shadow work), re-timed as phase 8 does, on the candidate's (grow)
    tables."""
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import (
        ScanTables,
        scan_bytes,
        scan_pairs,
    )
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    tables = ScanTables.from_bitap(packs["grow"].tables, dev)
    return {
        "pair_scan": retime_shapes(
            "rollout pair", ByteScanner(tables), PAIR_SCAN,
            lambda t, n, *c: scan_pairs(tables, t, n, *c), tables,
            shapes.get("pair_scan", []), pool, dev, "pair"),
        "step_scan": retime_shapes(
            "rollout step", StepScanner(tables), STEP_SCAN,
            lambda t, n, *c: scan_bytes(tables, t, n, *c), tables,
            shapes.get("step_scan", []), pool, dev, "step")}


def phase_fault_matrix(dev: torch.device) -> dict:
    """Phase 10: every ported fault scenario on a batcher on the card,
    with the card's invariants (breaker-open batches fail open; nothing
    moves to the host)."""
    from ingress_plus_tpu_torch.utils.faults import (
        SCENARIOS,
        run_fault_matrix,
    )

    t0 = time.perf_counter()
    rep = run_fault_matrix(device=dev)
    wall = time.perf_counter() - t0
    for name, r in rep["scenarios"].items():
        checked = {k: v for k, v in r.items()
                   if k not in ("ok", "violations", "seconds")}
        log("fault %s: %s in %.2fs; %s%s"
            % (name, "ok" if r["ok"] else "FAILED", r["seconds"],
               json.dumps(checked, default=str),
               "" if r["ok"] else " violations: %s" % r["violations"]))
    if not rep["passed"] or len(rep["scenarios"]) != len(SCENARIOS):
        raise SystemExit("fault matrix: %d of %d scenarios ok"
                         % (sum(r["ok"] for r in rep["scenarios"].values()),
                            len(SCENARIOS)))
    return {"scenarios": {n: {"ok": r["ok"], "seconds": r["seconds"]}
                          for n, r in rep["scenarios"].items()},
            "not_ported": rep["not_ported"], "wall_s": wall}


def main() -> int:
    if sys.argv[1:] == ["--stream-cpu-reference"]:
        return stream_cpu_reference()
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        print("usage: chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN
    from ingress_plus_tpu_torch.weights import load_pack

    t0 = time.perf_counter()
    log("torch %s cuda %s on %s (%d cards)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    kernels = (PAIR_SCAN, STEP_SCAN)
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc per source
        libs = list(pool.map(lambda k: k.lib.build(verbose=True), kernels))
    dev = torch.device("cuda")
    for k, lib in zip(kernels, libs):
        k.lib.load(dev)
        log("built %s" % lib.name)
    log("build %.1fs" % (time.perf_counter() - t0))
    smi = nvidia_smi_line()
    log("card: %s" % smi)
    cr = load_pack()
    log("pack: %d rules, W=%d words, %d factors" % (
        cr.n_rules, cr.tables.n_words, cr.tables.n_factors))
    kern = phase_kernel(cr, dev)
    sweep = phase_segment_sweep(kern["tables"], dev)
    if kernels_only:
        step = phase_step_kernel(kern["tables"], dev)
        sass = {"pair_scan": sass_loop_mix(libs[0], "pair", 2),
                "step_scan": sass_loop_mix(libs[1], "byte", 1)}
        log("sass loops: %s" % json.dumps(sass))
        log("detail " + json.dumps({
            "card": smi, "scan_shapes": kern["shapes"], "sweep": sweep,
            "step_scan": step, "sass": sass,
            "seconds": time.perf_counter() - t0}))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    pipe, inputs, requests, want = phase_pipeline(cr, dev)
    main_path = phase_main_shapes(kern["tables"], inputs, dev)
    step = phase_step_kernel(kern["tables"], dev)
    pallas = phase_pallas_pipeline(cr, dev, requests, want)
    stream, stream_waves = phase_stream(cr, dev)
    serve, serve_shapes, pool = phase_serve(requests, want,
                                            stream["cpu_keys"], smi)
    log("serve " + json.dumps(serve))
    serve_k = phase_serve_kernels(kern["tables"], serve_shapes, pool, dev)
    rollout, rollout_shapes, rollout_packs = phase_rollout(
        requests, inputs, stream_waves, smi, dev)
    log("rollout " + json.dumps(rollout))
    rollout_k = phase_rollout_timing(rollout_packs, rollout_shapes, pool,
                                     dev)
    fault_matrix = phase_fault_matrix(dev)
    sass = {"pair_scan": sass_loop_mix(libs[0], "pair", 2),
            "step_scan": sass_loop_mix(libs[1], "byte", 1)}
    log("sass loops: %s" % json.dumps(sass))
    detail = {
        "card": smi, "pipeline": pipe, "main_path": main_path,
        "scan_shapes": kern["shapes"], "edges": kern["edges"],
        "sweep": sweep, "step_scan": step, "pallas_pipeline": pallas,
        "stream": stream, "serve": serve, "serve_kernels": serve_k,
        "rollout": rollout, "rollout_kernels": rollout_k,
        "fault_matrix": fault_matrix, "sass": sass,
        "seconds": time.perf_counter() - t0}
    log("detail " + json.dumps(detail))
    tot = main_path["total"]
    step_paths = {"stream": stream["retimed"]["total"],
                  "pallas_batch": pallas["retimed"]["total"]}
    step_tot = {k: sum(p[k] for p in step_paths.values())
                for k in ("launches", "ms", "one_segment_ms", "plain_ms",
                          "bound_ms", "ops_ms", "bytes_ms")}
    step_tot["bound_by"] = ("operations"
                            if step_tot["ops_ms"] >= step_tot["bytes_ms"]
                            else "bytes")
    pair_segments = segment_rows("pallas3 batch path",
                                 main_path["shapes"].values())
    for c in ("raw_byte", "class_id"):
        pair_segments += segment_rows(
            "phase 2 %s" % c, [{"B": r["B"], "L": r["L"], **r[c]}
                               for r in kern["shapes"]])
    step_segments = (
        segment_rows("stream lane", stream["retimed"]["shapes"].values())
        + segment_rows("pallas batch path",
                       pallas["retimed"]["shapes"].values())
        + segment_rows("phase 4", step["shapes"]))
    source = {"pair_scan": ("ingress_plus_tpu_torch/csrc/pair_scan.cu",
                            "ingress_plus_tpu/ops/pallas_scan.py:270"),
              "step_scan": ("ingress_plus_tpu_torch/csrc/step_scan.cu",
                            "ingress_plus_tpu/ops/pallas_scan.py:49")}

    def entry(name, path, totals, err, **more):
        """One kernels-line entry: every number over one path's
        launches."""
        return {"name": name, "route": "cuda", "source": source[name][0],
                "replaces": source[name][1], "path": path,
                "launches": totals["launches"], "max_abs_err": err,
                **{k: totals[k] for k in ("ms", "one_segment_ms",
                                          "plain_ms", "bound_ms",
                                          "bound_by")},
                "library_ms": None, **more}

    serve_entries = [entry(
        name, "serve plane (phase 8): %s" % what,
        serve_k[name]["total"], serve_k[name]["total"]["max_abs_err"],
        parity="bit-identical match and state at each of the serve path's "
               "%d (B, L, carried) shapes" % len(serve_k[name]["shapes"]),
        shape="the server's %d launches, each shape's device time once "
              "per launch of it (rows cut from the wire traffic to the "
              "shape's latest lengths); bound from the work the server "
              "counted" % serve_k[name]["total"]["launches"],
        segments=segment_rows("serve path",
                              serve_k[name]["shapes"].values()))
        for name, what in (("pair_scan", "batches on pallas3 (raw_byte)"),
                           ("step_scan", "stream lane and oversized "
                                         "bodies"))]
    rollout_entries = [entry(
        name, "rollout (phase 9): %s" % what, rollout_k[name]["total"],
        rollout_k[name]["total"]["max_abs_err"],
        parity="bit-identical match and state at each of the phase 9 "
               "server's %d (B, L, carried) shapes on the grow pack's "
               "tables (W=%d); both kernels also on the grow and tiny "
               "tables at the main path's shapes"
               % (len(rollout_k[name]["shapes"]),
                  rollout["kernels"]["grow"]["W"]),
        shape="the phase 9 server's %d launches (serving cycles of both "
              "generations: %d; the rollout's admission and shadow work: "
              "%d), each shape's device time once per launch of it, on "
              "the candidate's (grow) tables"
              % (rollout_k[name]["total"]["launches"],
                 rollout["launches"]["serve_scope"][name],
                 rollout["launches"]["rollout_scope"][name]),
        segments=segment_rows("rollout path",
                              rollout_k[name]["shapes"].values()))
        for name, what in (("pair_scan", "admission replay, warm, smoke "
                                         "and shadow scans, and the "
                                         "canary's batches on pallas3"),
                           ("step_scan", "the rerouted body before and "
                                         "after the rollout"))]
    print(json.dumps({"kernels": serve_entries + rollout_entries + [entry(
        "pair_scan", "library: pallas3 batch path (phase 3)", tot,
        max(s[c]["max_abs_err"] for s in kern["shapes"]
            for c in ("raw_byte", "class_id")),
        configurations=["raw_byte (pallas3)", "class_id (pallas2)"],
        parity="bit-identical match and state, both configurations, B=%d x "
               "L in %s, B=%d x L in %s split and unsplit, every main-path "
               "bucket; edges %s"
               % (SCAN_B, list(SCAN_LS), SPLIT_B, list(SPLIT_LS),
                  kern["edges"]),
        shape="the batch path's %d launches, raw_byte, summed"
              % tot["launches"],
        segments=pair_segments), entry(
        "step_scan", "library: stream lane and pallas batch path "
                     "(phases 5, 6)", step_tot,
        max(s["max_abs_err"] for s in step["shapes"]),
        launches_by_path={"stream": stream["launches"],
                          "pallas_batch": pallas["launches"]},
        parity="bit-identical match and state: B=%d x L in %s, B=%d x L in "
               "%s split and unsplit; edges %s; chained carry %s; every "
               "stream wave and pallas bucket"
               % (SCAN_B, list(SCAN_LS), SPLIT_B, list(SPLIT_LS),
                  step["edges"], step["chain"]),
        shape="the stream lane's %d waves and the pallas batch path's %d "
              "launches, summed" % (stream["launches"], pallas["launches"]),
        segments=step_segments)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
