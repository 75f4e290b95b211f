#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to its plain
versions.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. Build the pair-scan kernel from ``ingress_plus_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the card's name and power limit.
2. Kernel against plain, both configurations: the CUDA kernel
   (``ByteScanner`` raw-byte, ``PairScanner`` class-id) and the plain
   ``ops/scan.py::scan_pairs`` on the same CUDA tensors -- B=1024 seeded
   rows with attack substrings, L in {64, 2048, 16384}, ragged lengths
   (0, 1, odd, L), a carried-in sticky match and state; then edge shapes
   (1001 rows, odd L, the largest class table).  Match and state must be
   bit-identical.
3. The main path: ``DetectionPipeline(device="cuda")`` (scan impl
   ``pallas3``) on the bundled pack at full width, over
   ``generate_corpus(n=2048, seed=20260729)`` plus 10 large-body requests
   (every L-bucket up to 16384 is hit), in batches of 256.  The same
   requests through ``DetectionPipeline(device="cpu")`` (the plain scan)
   must give identical (attack, blocked, sorted rule_ids, score, classes)
   for every request, and the kernel must have launched once per bucket.
   Then the kernel again on each of those launches' own buckets:
   bit-identical to the plain version, timed.
4. Print the kernels line (the main path's launches, summed), the
   nvidia-smi line, and the result line.

Kernel times are device times: 20 launches captured in one CUDA graph,
CUDA events around the replay, the median of the replays, per launch.
The plain version's times are CUDA events around single host-driven
calls.  The bound is the larger of bytes over the HBM rate and the
recurrence's LOP3 / shift / shared-memory instruction counts over the
SM pipes' rates (see ``bound``); ``sass_loop_mix`` reports how many
instructions the compiled loop actually spends per pair.
"""

from __future__ import annotations

import json
import random
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 256
SEED = 20260729
SCAN_B = 1024
SCAN_LS = (64, 2048, 16384)
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
#: per (row, word) of the recurrence in csrc/pair_scan.cu, its bitwise
#: parts fused into LOP3: (LOP3, shifts, class-table reads) for one full
#: pair and for the half pair an odd length ends with
FULL_PAIR = (5, 3, 2)
HALF_PAIR = (2, 1, 1)
ATTACKS = (b"1' UNION SELECT password FROM users--", b"<script>alert(1)</script>",
           b";cat /etc/passwd", b"../../etc/shadow", b"${jndi:ldap://x/a}")


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
    match = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    match[rng.random((B, W)) < 0.9] = 0        # sparse sticky bits
    state = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    return toks, lengths, match, state


def bound(lengths: np.ndarray, L: int, W: int, K1: int,
          token_bytes: int) -> dict:
    """Least time for one call, with the work this call's lengths need:
    the larger of bytes / HBM rate (each input read once, each output
    written once) and the recurrence's instructions over the SM pipe that
    runs them slowest: LOP3 on the ALU pipe, every instruction through
    issue, class-table reads through shared memory."""
    n = np.clip(lengths.astype(np.int64), 0, L)
    full, half = W * int((n // 2).sum()), W * int((n % 2).sum())
    lop3, shifts, lds = (f * full + h * half
                         for f, h in zip(FULL_PAIR, HALF_PAIR))
    B = lengths.shape[0]
    nbytes = (B * L * token_bytes + B * 4          # tokens, lengths
              + 2 * B * W * 4                      # match + state in
              + 2 * B * W * 4                      # match + state out
              + K1 * W * 4 + 257 * 4 + 2 * W * 4)  # tables
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


def sass_loop_mix(lib_path) -> dict:
    """Instructions per pair in each kernel's hottest loop, read from the
    built library's SASS (``cuobjdump -sass``): the innermost loop (a
    backward branch) with the most shared-memory loads, its pairs counted
    as its 32-bit ``LDS`` (class-table reads) / 2.  Says how far the
    compiled loop is from the recurrence's own count."""
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
        name = "raw_byte" if "ILb1E" in part.split("\n", 1)[0] else "class_id"
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
            table = sum(op == "LDS" for op in body)
            if table and (best is None or table > best[0]):
                best = (table, body)
        if best is None:
            out[name] = {"error": "no loop with 32-bit LDS found"}
            continue
        pairs = best[0] / 2
        kinds = {"lop3": 0, "shift": 0, "lds": 0, "other": 0}
        for op in best[1]:
            kind = ("lop3" if op.startswith("LOP3")
                    else "shift" if op.startswith(("SHF", "IMAD.SHL"))
                    else "lds" if op.startswith("LDS") else "other")
            kinds[kind] += 1
        out[name] = {"pairs_per_iteration": pairs,
                     "instructions_per_pair": len(best[1]) / pairs,
                     **{k + "_per_pair": v / pairs for k, v in kinds.items()}}
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
    configs = {"raw_byte": ByteScanner(tables),
               "class_id": PairScanner(tables)}
    shapes = []
    for L in SCAN_LS:
        toks_np, len_np, match_np, state_np = scan_inputs(L, W, rng)
        toks = torch.from_numpy(toks_np).to(dev)
        lens = torch.from_numpy(len_np).to(dev)
        match = from_numpy_u32(match_np, dev)
        state = from_numpy_u32(state_np, dev)
        m_ref, s_ref = scan_pairs(tables, toks, lens, state, match)
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: scan_pairs(tables, toks, lens, state,
                                              match),
                           reps=3 if L >= 8192 else 10)
        row = {"B": SCAN_B, "L": L, "plain_ms": plain_ms}
        for name, scanner in configs.items():
            m, s = scanner(toks, lens, state, match)
            torch.cuda.synchronize()
            err = max(int((m.long() - m_ref.long()).abs().max()),
                      int((s.long() - s_ref.long()).abs().max()))
            if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                raise SystemExit(
                    "kernel %s disagrees with scan_pairs at L=%d: "
                    "match diff words=%d state diff words=%d"
                    % (name, L, int((m != m_ref).sum()),
                       int((s != s_ref).sum())))
            if name == "raw_byte":
                fn = lambda: scanner(toks, lens, state, match)
                tok_bytes = 1
            else:
                # time the kernel alone: class ids mapped beforehand
                cls = classes_for(tables.byte_class, toks, lens).to(
                    torch.int32).contiguous()
                fn = lambda: PAIR_SCAN(cls, lens, tables.class_table,
                                       tables.init_mask, tables.final_mask,
                                       state=state, match=match)
                tok_bytes = 4
            ms = device_ms(fn)
            b = bound(len_np, L, W, K1, tok_bytes)
            row[name] = {"ms": ms, "max_abs_err": err, **b,
                         "parity": "bit-identical"}
            log("kernel pair_scan[%s] B=%d L=%d W=%d K1=%d: bit-identical "
                "match+state; %.4f ms device (plain %.3f ms, bound %.4f ms "
                "by %s/%s, %.2fx)"
                % (name, SCAN_B, L, W, K1, ms, plain_ms, b["bound_ms"],
                   b["bound_by"], b["pipe"], ms / b["bound_ms"]))
        shapes.append(row)
    return {"shapes": shapes, "edges": edge_parity(tables, rng),
            "tables": tables}


def edge_parity(tables, rng: np.random.Generator) -> str:
    """Shapes the main path does not produce but the kernel accepts: a
    row count that is no multiple of 8, an odd L (the plain version pads
    one dead column), and the largest class table (K+1 = 257: the raw
    byte table plus the dead row, fed byte values as class ids), which
    needs more than 48 KB of shared memory.  Bit-identical or fail."""
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
    m2, s2 = PAIR_SCAN(toks.to(torch.int32).contiguous(), lens, raw,
                       tables.init_mask, tables.final_mask, match=match)
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


def phase_pipeline(cr, dev: torch.device) -> dict:
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
    want = run_pipeline(cpu, requests)
    cpu_wall = time.perf_counter() - t1

    def key(v):
        return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids),
                v.score, v.classes)

    bad = [(a.request_id, key(a), key(b))
           for a, b in zip(got, want) if key(a) != key(b)]
    if len(got) != len(requests) or bad:
        raise SystemExit("verdicts differ between cuda and cpu pipelines "
                         "on %d requests, first: %s" % (len(bad), bad[:1]))
    if any(v.fail_open for v in got):
        raise SystemExit("a cuda verdict failed open")
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
    # the (tokens, lengths) of every launch the main path made: the
    # pipeline's own bucketing of the same batches, one launch per bucket
    inputs = [(tok, ln) for i in range(0, len(requests), BATCH)
              for tok, ln, _, _ in gpu._build_scan_buckets(
                  requests[i:i + BATCH])[0]]
    if len(inputs) != launches:
        raise SystemExit("the main path launched the kernel %d times for "
                         "%d buckets" % (launches, len(inputs)))
    return res, inputs


def phase_main_shapes(tables, inputs, dev: torch.device) -> dict:
    """The kernel at each launch of the main path, on that launch's own
    bucket (raw-byte configuration, as ``pallas3`` runs it): parity with
    the plain version, device time, the plain version's time and the
    bound.  Totals are one pass over the main path's launches."""
    from ingress_plus_tpu_torch.ops.pair_scan import ByteScanner
    from ingress_plus_tpu_torch.ops.scan import scan_pairs

    scanner = ByteScanner(tables)
    W, K1 = tables.n_words, tables.class_table.shape[0]
    by_shape: dict = {}
    for tok_np, len_np in inputs:
        toks = torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev)
        lens = torch.from_numpy(np.asarray(len_np, np.int32)).to(dev)
        m, s = scanner(toks, lens)
        m_ref, s_ref = scan_pairs(tables, toks, lens)
        torch.cuda.synchronize()
        if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
            raise SystemExit("kernel disagrees with scan_pairs on a main-path "
                             "bucket B=%d L=%d" % tuple(toks.shape))
        B, L = toks.shape
        b = bound(np.asarray(len_np), L, W, K1, 1)
        agg = by_shape.setdefault("%dx%d" % (B, L), {
            "B": B, "L": L, "launches": 0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})
        agg["launches"] += 1
        agg["ms"] += device_ms(lambda: scanner(toks, lens), reps=10)
        agg["plain_ms"] += time_ms(lambda: scan_pairs(tables, toks, lens),
                                   reps=1, warmup=0)
        for k in ("bound_ms", "ops_ms", "bytes_ms"):
            agg[k] += b[k]
    total = {k: sum(a[k] for a in by_shape.values())
             for k in ("launches", "ms", "plain_ms", "bound_ms", "ops_ms",
                       "bytes_ms")}
    total["bound_by"] = ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes")
    for key, a in sorted(by_shape.items(), key=lambda kv: kv[1]["L"]):
        log("main path B=%d L=%d: %d launches, bit-identical; %.4f ms device "
            "(plain %.3f ms, bound %.5f ms, %.1fx)"
            % (a["B"], a["L"], a["launches"], a["ms"], a["plain_ms"],
               a["bound_ms"], a["ms"] / a["bound_ms"]))
    log("main path total: %d launches, %.4f ms device (plain %.1f ms, "
        "bound %.5f ms by %s)" % (total["launches"], total["ms"],
                                  total["plain_ms"], total["bound_ms"],
                                  total["bound_by"]))
    return {"shapes": by_shape, "total": total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, build_library
    from ingress_plus_tpu_torch.weights import load_pack

    t0 = time.perf_counter()
    log("torch %s cuda %s on %s (%d cards)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    log("building %s" % build_library(verbose=True).name)
    PAIR_SCAN.library(torch.device("cuda"))
    log("build %.1fs" % (time.perf_counter() - t0))
    smi = nvidia_smi_line()
    cr = load_pack()
    log("pack: %d rules, W=%d words, %d factors" % (
        cr.n_rules, cr.tables.n_words, cr.tables.n_factors))
    dev = torch.device("cuda")
    kern = phase_kernel(cr, dev)
    pipe, inputs = phase_pipeline(cr, dev)
    main_path = phase_main_shapes(kern["tables"], inputs, dev)
    sass = sass_loop_mix(build_library())
    log("sass pair loop: %s" % json.dumps(sass))
    detail = {
        "card": smi, "pipeline": pipe, "main_path": main_path,
        "scan_shapes": kern["shapes"], "edges": kern["edges"],
        "sass": sass, "seconds": time.perf_counter() - t0}
    log("detail " + json.dumps(detail))
    tot = main_path["total"]
    print(json.dumps({"kernels": [{
        "name": "pair_scan",
        "route": "cuda",
        "source": "ingress_plus_tpu_torch/csrc/pair_scan.cu",
        "replaces": "ingress_plus_tpu/ops/pallas_scan.py:270",
        "configurations": ["raw_byte (pallas3)", "class_id (pallas2)"],
        "parity": "bit-identical match and state, both configurations, "
                  "L in %s, every main-path bucket; edges %s"
                  % (list(SCAN_LS), kern["edges"]),
        "launches": pipe["launches"],
        "max_abs_err": max(s[c]["max_abs_err"] for s in kern["shapes"]
                           for c in ("raw_byte", "class_id")),
        "shape": "the main path's %d launches, raw_byte, summed"
                 % tot["launches"],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
