#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to its plain
versions.

Run from the repository root:  python3 chip_smoke.py
(``--kernels-only`` stops after phases 1, 2 and 4 and the segment sweep:
a quick check of both kernels.  ``--sanitize-child [--checked]`` runs
phase 19's child alone: the case plan on the card, each launch against
its plain version.)

Both kernels split each row's serial chain into segments
(``ingress_plus_tpu_torch/ops/segments.py``); every launch below runs at
the plan's segment length, and every shape the plan splits is also timed
at one segment (the same kernel unsplit) in the same run.

Phases (any failure ends the run with a non-zero exit code):

1. Build both kernels from ``ingress_plus_tpu_torch/csrc`` (one nvcc per
   source, sm_90a), the native confirm twin (``csrc/libdetect.cc``, g++),
   phase 17's front door binaries (``native/``, g++ and gcc) and phase
   19's builds (both kernels checked, ``-DSCAN_CHECK``, and without
   ``-lineinfo``; the sidecar and loadgen under ASan+UBSan, the sidecar
   under TSan), all started together, each build timed; print the card's
   name and power limit.
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
3. The main path: ``DetectionPipeline(device="cuda")`` (the
   constructor's impl on a card, ``pallas3``: only the server's ``auto``
   measures) on the bundled pack at full width, over
   ``generate_corpus(n=2048, seed=20260729)`` plus 10 large-body requests
   (every L-bucket up to 16384 is hit), in batches of 256.  The same
   requests through ``DetectionPipeline(device="cpu")`` (the plain scan)
   must give identical (attack, blocked, sorted rule_ids, score, classes)
   for every request, and the kernel must have launched once per bucket.
   Both pipelines confirm with the native twin (a set
   ``IPT_NO_NATIVE_CONFIRM`` fails the run).
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
   launch per bucket, each launch re-run on its bucket and timed.  Then
   ``scan_impl="take"`` on the card (the step kernel again) over phase
   3's first 512 requests: verdicts identical to phase 3's CPU verdicts,
   one step-kernel launch per bucket, no pair-kernel launch, each launch
   re-run on its bucket against ``scan_bytes`` and timed.
6. The stream lane: seven concurrent 1 MiB streams
   (``utils/stream_corpus.py``: benign form text, SQLi across a 64 KiB
   boundary, a split %-escape, a gzip body with an attack at its inflated
   tail, a base64 body, an attack only in the URI, a response leak),
   driven chunk by chunk through ``StreamEngine`` on the card and, in a
   child process (``chip_smoke.py --stream-cpu-reference``), on the CPU;
   verdicts identical, planted attacks found, none failed open, one
   kernel launch per wave.  While the child runs, every wave again on its
   own inputs, timed, and against its slice of one ``scan_bytes`` call
   over all the waves' rows stacked: bit-identical.  The CPU child starts
   with the script, so that it runs beside phases 1-5.
8. The serve plane: ``python -m ingress_plus_tpu_torch.serve`` with its
   defaults but ``--scan-impl pallas3`` as a child process (platform
   cuda, one inline confirm worker, warmup on); once ``/readyz``
   answers, phase 3's requests over the UDS wire protocol on several
   pipelined connections (``serve/client.py``), then the first 512 of them
   again (the second wave), then
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
   Then the same waves to a second server with ``--confirm-workers
   auto`` and otherwise its defaults, so ``--scan-impl auto`` (the
   pooled confirm against the inline walk, one interpreter lock either
   way).  Its startup bake-off must print times for ``take``,
   ``pallas``, ``pallas2`` and ``pallas3``, the impl ``/healthz``
   reports must be the least of the finite times, and the bake-off's
   launches (19 a candidate at 512 x 256: one eager pass and two CUDA
   graph captures) must all be tallied under
   ``/debug/kernels?scope=autoselect``, so none under ``serve``.  Which
   impl wins is no gate: that server's kernel launches are not held.  Prints wire req/s, client-side p50/p99, the
   server's stage breakdown, the confirm workers and the streamed MB/s.
   The port's promlint (``analysis/promlint.py``) finds nothing on the
   first server's ``/metrics`` after its traffic.
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
   with ``--rules-dir`` (base), ``--lkg-dir`` and ``--scan-impl
   pallas3`` (so that its pair launches are re-timed as one path), its
   defaults otherwise:
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
   waves' req/s and p50/p99, runs ``python -m
   ingress_plus_tpu_torch.control.dbg rollout`` against the server once
   grow is live (exit 0), and re-times the first server's launches
   (both generations' serving cycles and the rollout's admission and
   shadow work, ``/debug/kernels?scope=rollout``) on grow's tables.
10. The fault matrix: ``run_fault_matrix()`` on a batcher on the card,
    every ported scenario ``ok`` with the card's invariants (breaker-open
    batches fail open, none blocks, nothing moves to the host); one line
    per scenario.
11. The post plane and the learned scoring head on the card.  The
    feature export (``utils/export_corpus.build_feature_dataset``, n=2048,
    the bundled rules, the benign fixtures) on the card and, in a child
    process (``chip_smoke.py --features-cpu-reference``), on the CPU:
    ``x``, ``x_candidates``, ``y`` and ``rule_ids`` byte-identical.  Head
    1 trained (``learn/train.py``) on the card's features, its
    fingerprint equal to the head trained on the CPU's; head 2 with
    another calibration margin.  One server with the post plane
    (``--spool-dir``, ``--export-url`` to an HTTP collector in this
    script, ``--export-interval-s 0.5``, brute/dirbust thresholds 8/12),
    ``--artifact-dir``, ``--lkg-dir``, ``--scan-impl pallas3`` and
    ``--scoring-head`` head 1: a wave
    of phase 3's requests (without the rerouted bodies), the benign
    fixtures, a login flood and a wordlist sweep, every wire verdict the
    CPU pipeline's under head 1, ``ipt_scorer_diff_total`` its
    ``scorer_diff``; the collector's and the spool's attack records
    (folded by tenant, client, class) and the ``/wallarm-status``
    counters equal to a CPU ``PostChannel`` fed the same (request,
    verdict) pairs, one brute event for the flood's client and one
    dirbust event for the sweep's; the served rules plus the operator's
    rule file saved into ``--artifact-dir`` is staged by the
    ``RulesetWatcher`` and aborted; head 2 staged over ``POST
    /configuration/scoring`` to live under waves, every wire verdict one
    head's CPU verdict and the wave after live head 2's; the scorer LKG
    equal to the CPU ``persist_lkg_scorer`` of head 2 (``.json`` and
    pointer bytes, equal arrays); every phase 8 health counter 0.  The
    ``dbg`` views ``conf``, ``health``, ``metrics``, ``latency``,
    ``tenants``, ``rules``, ``drift``, ``breaker``, ``faults`` and
    ``scoring`` (``python -m ingress_plus_tpu_torch.control.dbg``
    children, all at once) against the server exit 0 with output.  The
    server's launches re-timed at their shapes on the bundled tables.
12. The native confirm twin, the tooling and the 2x pack; (a) and (e)
    run between phases 5 and 6, beside phase 6's CPU child, and (b), (c)
    and (d), whose rates move with the host's load, after phase 11.  (a)
    The twin
    against the Python detectors on every string the main path's confirm
    stage passes them over phase 3's requests (a card pipeline's run,
    recorded) and on a seeded fuzz: identical booleans.  (b)
    ``python -m ingress_plus_tpu_torch.utils.microbench --confirm`` on the
    card as two child processes, with the twin and with
    ``IPT_NO_NATIVE_CONFIRM=1``: req/s, confirm and wall time per config,
    the same verdict digest; then two servers with their defaults but
    ``--scan-impl pallas3`` (an A/B of the confirm alone, no bake-off),
    one with the twin and one without, both up, given phase 3's requests
    (without the rerouted bodies) in turns (twin, Python, Python, twin):
    every verdict phase 3's CPU verdict, wire req/s, p50/p99 and the
    confirm stage's p50/p99.  (c) ``bench_scan_modes`` on the card: MB/s
    per (B, L) and scan mode, each kernel bit-identical to its plain
    version.  (d) ``python -m ingress_plus_tpu_torch.utils.evalf1
    --platform cuda`` and ``--platform cpu`` as children side by side:
    tp, fp, fn, tn and every other count equal.  (e) ``scale_rules(
    load_bundled_rules(), 2.0)`` compiled by the port: its word tiles and
    shared-memory slice logged, ``ByteScanner`` and ``StepScanner``
    bit-identical to ``scan_pairs`` and ``scan_bytes`` at B=1024 x L in
    {64, 2048} and B=8 x L=16384 (carried state, sticky match), timed;
    phase 3's first 512 requests through a card pipeline on it, verdicts
    equal to the CPU pipeline's, its launches re-run on their buckets.
13. The mesh (``parallel/``) on the one card, after phase 12.  (a) A 1x1
    mesh on the card with ``pallas2`` (the pair kernel on the shard's
    class-id tables) and with ``take`` (the step kernel): on every
    bucket of phase 3's requests, rule hits, class hits and scores
    equal the plain CPU mesh step's, and a subset of the single-device
    engine's (the mesh gates stream-variants row by row, the single
    engine request by request, as in the JAX package); a card pipeline
    on each over phase 3's requests gives phase 3's CPU verdicts, one
    launch of the impl's kernel per bucket and none of the other.  (b)
    A 2x4 mesh whose eight entries all name the card: every step equals
    the 1x1's, eight launches a bucket, and every shard's
    ``PairScanner`` is bit-identical to ``scan_pairs`` on its tables
    (match and state) at each bucket shape as the step lays it out;
    then every one of those launches again on its own rows and shard,
    bit-identical and timed against the bound: the kernels line's 2x4
    entry.  Then ``MeshEngine.autoselect_scan_impl()`` on the 2x4: it
    times ``take`` and ``pallas2`` (a warm step, then 5 rounds of 17
    global-rows steps each, all launches under the ``autoselect`` launch
    scope and none in the shards' serving tally), installs the one with
    the lesser median, and every bucket's step then equals the plain CPU
    step.
    (c) ``ring_scan`` over four entries of the card on phase 6's seven
    bodies equals one contiguous ``StepScanner`` scan.  (d) ``python -m
    ingress_plus_tpu_torch.serve --mesh 1x1 --scan-impl pallas2`` on the
    card answers phase
    3's traffic over the wire with the CPU reference's verdicts
    (``/healthz``: cuda, ``pallas2``); its ``/debug/kernels`` launches
    (equal to its mesh's per-shard count) are re-run by shape on the
    shard's tables, bit-identical and timed against the bound: the
    kernels line's "mesh" entry.
14. The fleet.  Two card backends (the server's defaults, one process
    each) behind ``--front``, and a second front over the first backend
    alone.  A wave of phase 3's traffic through the two-backend front
    gives the direct server's verdicts, one per request, with traffic
    on both; then waves in turns through one backend and through two
    (one, two, two, one): wire req/s and client p50/p99 of each.  One
    backend is SIGKILLed 30% into a wave: every request gets exactly
    one verdict (the reference's, or the front's fail-open one, which
    never blocks), the node is ejected; restarted on its socket and
    port, it is re-admitted (``state=up``, ``readmissions >= 1``) and a
    wave passes with no fail-open.  ``python -m
    ingress_plus_tpu_torch.control.fleetobs --once`` sees both nodes up;
    an aggregator child's ``/fleet/metrics`` ``ipt_requests_total``
    equals the sum of the nodes' own; ``python -m
    ingress_plus_tpu_torch.control.retuned --once`` against it prints
    one typed cycle record.  Both backends' health counters read 0.
    The port's promlint (``fleet=True``) finds nothing on the
    aggregator's ``/fleet/metrics``, and ``dbg fleet`` against it exits 0.
15. The quality gates on the card.  (a) ``utils/quality_report.py
    build_report(n_benign=10000)`` on a card pipeline (``pallas3``): its
    evasion, benign, benign-fixture and ruleset blocks equal the
    committed ``reports/QUALITY.json`` (read as data; notes aside).  (b)
    ``utils/prefilter_gate.py run_gate(n=2048, fuzz_per_attack=2,
    seed=20260729)`` on a card pipeline with a CPU pipeline as its
    reference: 0 prefilter losses, the masked prefilter matrix equal to
    the CPU's on every chunk, and the counts the JAX package's gate
    gives at that size (``GATE_JAX``).  Wall seconds and req/s of each;
    their pair launches re-timed by shape.  (c) ``python -m
    ingress_plus_tpu_torch.analysis`` (rulecheck), ``--conc`` and
    ``--evade`` run beside (a) and (b) and exit 0 (the ``dbg`` and
    promlint checks run in phases 8, 9, 11 and 14).
16. The controller render layer on the card: BASELINE.json config #4
    (``config4_manifests``: 256 Ingresses in 64 namespaces, each
    namespace with its own 1-4 of the pack's attack tags, 16 with a
    ``wallarm-acl``; a ConfigMap with two ACLs).
    ``control/deploy.py write_static`` renders the port's manifests; the
    ``serve-0`` container's command runs with its rendered env and only
    these changes, each printed: this run's Python for ``python``, the
    socket, spool and LKG paths in a temporary directory, a free
    ``--http-port``, and no ``--rules-dir`` (the bundled pack: the
    ``rules/crs`` tree alone holds 252 of its 2009 rules), and
    ``--scan-impl pallas3`` added (its pair launches are re-timed as one
    path; the rendered ``auto`` would run a bake-off).  Seconds to
    ``/readyz`` beside the rendered liveness probe's delay.
    ``SyncController.sync``: sync 1 ``reload``, the rendered nginx.conf
    lint-clean, tenants 1..256, both pushes landed at the first attempt,
    257 mask rows on ``/configuration``; phase 3's requests, each with a
    seeded tenant in 0..256 and client IP (``config4_traffic``), over
    the wire: every verdict equals the port's CPU pipeline's under
    ``tenant_masks`` of the synced tags and the pushed ACLs; sync 2 (32
    Ingresses retagged, the ACL content changed) ``dynamic`` with the
    text unchanged, both pushes landed, a second wave held to the new
    state; sync 3 ``noop`` with no POST.  The server's pair (and step)
    launches re-run by shape, bit-identical and timed; every health
    counter 0.
17. The front door: the port's servers (each with ``--scan-impl
    pallas3``, so that their launches re-time as one path) behind the
    repository's own C++
    sidecar, loadgen and nginx module harness, built from ``native/``
    with its Makefiles' flags into ``build/native`` (``ops/cuda_build.py
    build_native``; never in ``native/``).  Every unix socket path comes
    from ``utils/uds.py socket_path`` (it fits AF_UNIX whatever
    ``TMPDIR`` is).  Four legs, each of which logs ``FAILED phase 17 leg
    X`` and the last lines of every child's log before the run fails.
    (A) One server (block, a 60 s hard deadline) behind the sidecar
    (ewma, a 60 s deadline, a 64 MiB upstream buffer: no fail-open can
    be timing's): phase 3's requests through it on ``serve/client.py``,
    then phase 8's response-leak frame and 8 chunked streams of its
    bodies; every verdict equal to phase 8's references; the sidecar's
    fail-open, ``bad_frames`` and ``late_responses`` counters 0,
    ``responses == requests_in``.  (B) BASELINE.json config #1:
    ``export_corpus.export`` writes 10000 labeled frames in monitoring
    mode; loadgen (4 connections x 8 in flight) replays them through a
    sidecar (60 s) to a ``--mode monitoring`` server and straight at it,
    in turns (sidecar, direct, direct, sidecar): each run ``fail_open ==
    0``, ``blocked == 0`` and ``attacks`` equal to the card library
    pipeline's (``mode="monitoring"``) on the decoded frames; rps, p50,
    p90, p99, p999 of each and the sidecar hop's rps over direct,
    measured.  (C) Two servers from the rendered ``serve-0`` and
    ``serve-1`` commands (phase 16's changes) behind the rendered
    ``detect-sidecar`` command (its deadline, 50 ms, kept; only the
    binary, the socket paths, the status port and the upstream list, cut
    to the two servers, changed and printed); loadgen replays B's first
    4096 frames at 4 x 8 and 8 x 32: rps, p50, p99, the fail-open share,
    the sidecar's counters and the servers' fail-open and degraded
    verdicts printed; asserted only what holds at any host speed
    (``front_invariants``: answers equal requests, ``bad_frames`` and
    ``fail_open_upstream`` 0, every request answered or failed open and
    every late verdict back, the reference's attacks between ``attacks
    - degraded`` and ``attacks + fail_open``, ``blocked`` 0).  (D) A
    server on ``tests/test_shim.py``'s three rules with its ACLs pushed:
    ``shim_harness`` straight at it passes every check its source names
    (``HARNESS-OK``), ``shim_selftest`` through a sidecar gives the six
    cases the test wants.  Servers A, B, C's launches are re-run by shape
    on the bundled tables, D's on its rules' tables, bit-identical and
    timed; health counters 0 on A, B and D.
18. The JAX package's own verdict test files on the card: the eight of
    :data:`CARD_FILES` (ROADMAP's group 1 but ``test_skip_after``, which
    builds no pipeline, and ``test_tenant_fairness``, which times its own
    paths on the host clock), each rewritten onto the port by
    ``tests/torch_ported_tests.py ported(name, {}, device="cuda")`` into
    one tiny module of a temporary directory, all run by one ``python -m
    pytest`` child.  Their pipelines take the card's constructor impl
    (``pallas3`` batches; ``StepScanner`` for the stream lane and
    ``take``; a server the files start on ``auto`` runs its bake-off) on the
    files' own small packs (their own word and class counts), under the
    files' hand-written expectations.  Fails unless the child exits
    0, no case fails or errors, every file passes as many cases as its
    CPU leg (``tests/test_torch_<name>[_ref].py``, run whole) less the
    :data:`CARD_EXCLUDE` cases, and every file made a pair or a step
    kernel launch (``ScanKernel.launches``, the tally behind
    ``/debug/kernels``, read in the child).  Prints, before the kernels
    line, ``phase 18`` and per file the passed, excluded, pair and step
    launches and seconds, beside the card's name and power limit.
19. The port's native code under the sanitizers, all at once: (a)
    compute-sanitizer (found beside nvcc; missing, the run fails) with
    each of ``memcheck``, ``racecheck``, ``synccheck`` and ``initcheck``
    (``--error-exitcode``, checking only ``pair_scan_kernel`` and
    ``step_scan_kernel``; memcheck and initcheck with
    ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``) over a ``--sanitize-child``:
    every case of ``sanitize_plan`` (the main path's shapes, B=8 split and
    unsplit, a partial last block split and unsplit, lengths 0, 1, odd,
    L-1, L and L+1, carried and not) on the bundled pack (W=225) and the
    2x pack (W=285), through ``ByteScanner``'s, ``PairScanner``'s and
    ``StepScanner``'s tables, each launch bit-identical to its plain
    version.  A tool passes only with exit 0, its summary line at 0 and
    the child's bit-identity; a tool that says it cannot instrument the
    card (``SANITIZE_REFUSED``) is recorded as refused, anything else
    fails the run.  (b) The same plan through the kernels' checked build
    (``csrc/scan_common.cuh``: bulk-copy spans inside their buffers and
    slots, every staged token equal to device memory, halo and row
    checks, and a shadow of each warp's buffers that finds two lanes'
    conflicting accesses between two ``__syncwarp``, a refill of a buffer
    another lane read since the last one, and a wait on the wrong
    mbarrier phase): bit-identical, 0 check failures.  (c) The ASan+UBSan
    sidecar (with the ASan loadgen), then the TSan sidecar, in front of
    one card server on ``tests/test_sanitizers.py``'s three rules, 200
    requests each: all answered, attacks found, no sanitizer report.
    (d) ``cuobjdump -sass`` of both kernels equal with and without
    ``-lineinfo``.  Prints the phase 19 line before the kernels line.
20. Read each kernel's compiled loop (SASS); print the phase 18 and 19
    lines, the kernels line, the nvidia-smi line and the result line.

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
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
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
#: phase 8's second wave: the first this many of phase 3's requests
SECOND_WAVE = 512
#: a server that serves one kernel by design (its launch gates and
#: re-times hold the pair kernel; an A/B that differs in confirm alone)
#: runs no bake-off: it names its impl, the server's ``--scan-impl auto``
#: of the card's constructor (``--mesh``: ``pallas2``)
PINNED_IMPL = ("--scan-impl", "pallas3")
MESH_PINNED_IMPL = ("--scan-impl", "pallas2")
#: ``--scan-impl auto`` on a card: the single engine's bake-off
#: candidates at its shape, and each candidate's launches there: the
#: graphed chains of ``k_diff_time`` (one eager pass, then 17 and 1
#: passes captured, every later call a replay, which the wrappers do not
#: count)
BAKE_OFF_IMPLS = ("take", "pallas", "pallas2", "pallas3")
BAKE_OFF_SHAPE = (512, 256)
BAKE_OFF_LAUNCHES = 1 + 17 + 1
#: the mesh's bake-off: warm step, then rounds of timed steps
MESH_BAKE_OFF_ITERS = 17
#: phase 5: the requests the ``take`` pipeline runs (phase 3's first)
TAKE_REQUESTS = 512
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


#: phase 18: the JAX package's verdict test files run on the card
CARD_FILES = ("test_exclusions", "test_acl_modes", "test_anomaly_mode",
              "test_confirm_targets", "test_family_coverage",
              "test_pipeline", "test_stream", "test_rule_stats")
#: phase 18: file -> the tests left out on the card, each one that
#: asserts a fact of the CPU only (``scan_impl="pair"``, which a card
#: engine refuses; a count of CPU compiles).  None: every case of the
#: eight files passes on an H100 as it stands
CARD_EXCLUDE: dict = {}
#: phase 18: the pytest child's limit
CARD_FILES_LIMIT_S = 240

#: the run's start, for the seconds every log line carries
T0 = time.perf_counter()


def log(*a) -> None:
    print("[%7.1fs]" % (time.perf_counter() - T0), *a, flush=True)


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
                      t.final_mask,
                      byte_class=getattr(scanner, "byte_class", None),
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
    from ingress_plus_tpu_torch.models.libdetect import native_library
    from ingress_plus_tpu_torch.models.pipeline import (
        DetectionPipeline,
        PipelineStats,
    )
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN

    requests = phase3_requests()
    gpu = DetectionPipeline(cr, device=dev, fail_open=False)
    cpu = DetectionPipeline(cr, device="cpu", fail_open=False)
    if dev.type == "cuda" and gpu.engine.scan_impl != "pallas3":
        raise SystemExit("cuda pipeline runs %r, not pallas3"
                         % gpu.engine.scan_impl)
    if native_library() is None:
        raise SystemExit("the main path's confirm stage would run the "
                         "Python detectors: IPT_NO_NATIVE_CONFIRM is set")
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
    log("pipeline: %d requests, identical verdicts cuda vs cpu (both "
        "confirmed by the native twin), %d kernel launches; %.1f req/s on "
        "the card (host clock, confirm stage included; prep %.3fs engine "
        "%.3fs confirm %.3fs)"
        % (len(requests), launches, res["req_per_s_confirm_included"],
           res["prep_s"], res["engine_s"], res["confirm_s"]))
    inputs = bucket_inputs(gpu, requests)
    if len(inputs) != launches:
        raise SystemExit("the main path launched the kernel %d times for "
                         "%d buckets" % (launches, len(inputs)))
    return res, inputs, requests, want


def retime_launches(label: str, scanner, kernel, plain_fn, tables, inputs,
                    dev: torch.device, kind: str, inner: int = 20,
                    reps: int = 10, batch_plain: bool = False,
                    class_ids: bool = False) -> dict:
    """A kernel at each launch a path made, on that launch's own inputs
    ``(tokens, lengths[, state, match])``: parity of the ``scanner``'s
    launch with the plain version (match and state), device time at the
    plan's segment length and, where the plan splits, at one segment,
    the plain version's time (CUDA events around the host-driven call
    that gives the parity reference) and the bound (``kind`` "pair" or
    "step").  Totals are one pass over the path's launches.

    ``batch_plain``: the launches share one L, and the plain version
    runs once over all of their rows stacked (its cost is per step, so
    one call costs about what one launch's did); each launch is held
    against its slice of that call, whose time is the total's
    ``plain_ms`` (the shapes then have none of their own).

    ``class_ids``: the scanner is a ``PairScanner``; the timed launch
    takes the int32 class ids (``classes_for``, mapped beforehand), 4
    bytes a token in the bound, as ``retime_shapes`` does."""
    from ingress_plus_tpu_torch.ops.scan import classes_for, from_numpy_u32

    W, K1 = tables.n_words, tables.class_table.shape[0]
    run = forced(kernel, scanner)
    by_shape: dict = {}
    stacked = []        # batch_plain: each launch's (args, match, state)

    def plain_call(args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = plain_fn(*args)
        b.record()
        b.synchronize()
        return ref, a.elapsed_time(b)

    def check(B, L, got, ref):
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise SystemExit("%s: kernel disagrees with its plain version on "
                             "a launch B=%d L=%d" % (label, B, L))

    for inp in inputs:
        tok_np, len_np = inp[0], np.asarray(inp[1], np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev),
                torch.from_numpy(len_np).to(dev)]
        carried = len(inp) > 2
        if carried:
            args += [from_numpy_u32(inp[2], dev), from_numpy_u32(inp[3], dev)]
        B, L = args[0].shape
        got = scanner(*args)
        plain_ms = 0.0
        if batch_plain:
            stacked.append((args, got))
        else:
            torch.cuda.synchronize()
            ref, plain_ms = plain_call(args)
            check(B, L, got, ref)
        kargs = args
        if class_ids:
            kargs = [classes_for(tables.byte_class, args[0], args[1]).to(
                torch.int32).contiguous()] + args[1:]
        bd = bound(len_np, L, W, K1, 4 if class_ids else 1, carried, kind)
        tm = timed_plan(lambda seg: run(*kargs, segment=seg), B, L, W,
                        inner, reps)
        agg = by_shape.setdefault("%dx%d" % (B, L), {
            "B": B, "L": L, "G": tm["G"], "segments": tm["segments"],
            "launches": 0, "ms": 0.0, "one_segment_ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0})
        agg["launches"] += 1
        agg["ms"] += tm["ms"]
        agg["one_segment_ms"] += tm["one_segment_ms"]
        agg["plain_ms"] += plain_ms
        for k in ("bound_ms", "ops_ms", "bytes_ms"):
            agg[k] += bd[k]
    total = {k: sum(a[k] for a in by_shape.values())
             for k in ("launches", "ms", "one_segment_ms", "plain_ms",
                       "bound_ms", "ops_ms", "bytes_ms")}
    if stacked:
        torch.cuda.synchronize()
        (m_ref, s_ref), total["plain_ms"] = plain_call(
            [torch.cat(col) for col in zip(*(a for a, _ in stacked))])
        row = 0
        for args, got in stacked:
            B, L = args[0].shape
            check(B, L, got, (m_ref[row:row + B], s_ref[row:row + B]))
            row += B
        total["plain_rows"] = row
    total["bound_by"] = ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes")
    for key, a in sorted(by_shape.items(),
                         key=lambda kv: (kv[1]["L"], kv[1]["B"])):
        log("%s B=%d L=%d G=%d (%d segments): %d launches, bit-identical; "
            "%.4f ms device (one segment %.4f ms; plain %s; bound %.5f ms, "
            "%.1fx)"
            % (label, a["B"], a["L"], a["G"], a["segments"], a["launches"],
               a["ms"], a["one_segment_ms"],
               "in the stacked call" if batch_plain
               else "%.3f ms" % a["plain_ms"], a["bound_ms"],
               a["ms"] / a["bound_ms"]))
    log("%s total: %d launches, %.4f ms device (one segment %.4f ms; plain "
        "%.1f ms%s, bound %.5f ms by %s)"
        % (label, total["launches"], total["ms"], total["one_segment_ms"],
           total["plain_ms"],
           " in one call over all %d rows" % total["plain_rows"]
           if batch_plain else "", total["bound_ms"], total["bound_by"]))
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
    res["take"] = take_pipeline(cr, dev, requests[:TAKE_REQUESTS],
                                want[:TAKE_REQUESTS])
    return res


def take_pipeline(cr, dev: torch.device, requests, want) -> dict:
    """The batch path on ``scan_impl="take"``: on a card the step kernel
    (``StepScanner``), as ``pallas`` runs it.  Its verdicts must equal
    phase 3's CPU verdicts; the step kernel launches once per bucket and
    the pair kernel not at all.  Each launch is then re-run on its
    bucket, against ``scan_bytes``, timed."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
    from ingress_plus_tpu_torch.ops.scan import scan_bytes
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    gpu = DetectionPipeline(cr, device=dev, scan_impl="take",
                            fail_open=False)
    if gpu.engine.scanner_for() is None:
        raise SystemExit("take on cuda has no kernel scanner")
    STEP_SCAN.launches = 0                       # count this path only
    pair0 = PAIR_SCAN.launches
    t0 = time.perf_counter()
    got = run_pipeline(gpu, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = STEP_SCAN.launches
    check_verdicts("take pipeline", got, want)
    buckets = len(bucket_inputs(gpu, requests))
    if launches <= 0 or launches != buckets:
        raise SystemExit("the take pipeline launched the step kernel %d "
                         "times for %d buckets" % (launches, buckets))
    if PAIR_SCAN.launches != pair0:
        raise SystemExit("the take pipeline launched the pair kernel")
    log("take pipeline: %d requests, identical verdicts to the cpu "
        "pipeline, %d step-kernel launches (= buckets), no pair-kernel "
        "launch; %.1f req/s (host clock, confirm included)"
        % (len(requests), launches, len(requests) / wall))
    tables = gpu.engine.tables.scan
    return {"requests": len(requests), "identical_verdicts": len(requests),
            "launches": launches, "wall_s": wall,
            "retimed": retime_launches(
                "take path", StepScanner(tables), STEP_SCAN,
                lambda t, n: scan_bytes(tables, t, n), tables,
                bucket_inputs(gpu, requests), dev, "step")}


def stream_cpu_child() -> subprocess.Popen:
    """The stream lane's CPU reference (``--stream-cpu-reference``) as a
    child process; phase 6 reads it."""
    return subprocess.Popen(
        [sys.executable, __file__, "--stream-cpu-reference"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_stream(cr, dev: torch.device, child: subprocess.Popen) -> tuple:
    """Seven concurrent 1 MiB streams through ``StreamEngine`` on the card
    and on the CPU (BASELINE config #5: the ``child`` of
    :func:`stream_cpu_child`), then every wave again on its own inputs.
    Returns the result and the waves' inputs."""
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
    # the CPU reference runs in a child process (one thread), started
    # with the script; it is waited for, or killed, before return
    try:
        tables = gpu.engine.tables.scan
        retimed = retime_launches(
            "stream wave", eng.scanner(), STEP_SCAN,
            lambda t, n, s, m: scan_bytes(tables, t, n, s, m), tables,
            eng.recorded, dev, "step", inner=10, reps=5, batch_plain=True)
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
    """``python -m ingress_plus_tpu_torch.serve`` with ``args`` (and
    ``env``, default this process's environment) as a child process on a
    temporary socket and a free HTTP port, ready once ``/readyz`` answers
    200; stopped (terminate, then kill) on exit."""

    def __init__(self, *args: str, env: dict = None, sock: str = None,
                 port: int = None, argv: list = None):
        self.args = args
        self.env = env
        self.sock = sock
        self.port = port
        #: a whole command line to run instead (phase 16: the rendered
        #: one), which names ``sock`` and ``port`` itself
        self.argv = argv

    def __enter__(self):
        self.start()
        return self.ready()

    def start(self) -> "ServeChild":
        """Start the child (``ready`` waits for it): several children
        start side by side.  ``sock`` and ``port``, when given, are
        reused (a restart); else a temporary socket and a free port."""
        from ingress_plus_tpu_torch.utils.uds import socket_path

        self.tmp = tempfile.mkdtemp(prefix="ipt")
        self.sock = self.sock or socket_path(self.tmp, "serve.sock")
        self.port = self.port or free_port()
        self.log_path = os.path.join(self.tmp, "serve.log")
        argv = self.argv or [
            sys.executable, "-m", "ingress_plus_tpu_torch.serve",
            "--socket", self.sock, "--http-port", str(self.port), *self.args]
        with open(self.log_path, "w") as logf:
            self.child = subprocess.Popen(
                argv, stdout=logf, stderr=subprocess.STDOUT, env=self.env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        self.t_start = time.perf_counter()
        return self

    def ready(self) -> "ServeChild":
        """Wait until ``/readyz`` answers 200; stops the child on
        failure."""
        try:
            t0 = self.t_start
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
        log("serve %s: ready in %.1fs (%s)" % (" ".join(self.argv
                                                      or self.args),
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


def check_serve_metrics(what: str, metrics: str,
                        zero: tuple = SERVE_ZERO) -> float:
    """Fail unless every ``zero`` series reads 0 and engine_us is above
    0; returns engine_us."""
    nonzero = {n: v for n in zero
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
    return {k: v for k, v in json.loads(body).items()
            if k in ("pair_scan", "step_scan")}


def check_auto_select(what: str, srv) -> dict:
    """A ``--scan-impl auto`` server's startup bake-off: its stderr line
    must list every candidate of :data:`BAKE_OFF_IMPLS`, the impl
    ``/healthz`` reports must be the least of the finite times, and the
    bake-off's launches must all sit under the ``autoselect`` launch
    scope: :data:`BAKE_OFF_LAUNCHES` a candidate at
    :data:`BAKE_OFF_SHAPE` (state carried by the per-byte impls).  As
    the bake-off makes exactly that many, none of them is left to the
    serving cycles' tally.  Which impl wins is no gate.  Returns the times (ms a pass), the winner, the bake-off's
    seconds and launches."""
    found = re.findall(r"scan impl auto-select: (\w+)  \(([^)]*)\)  "
                       r"bake-off ([0-9.]+)s", srv.log())
    if len(found) != 1:
        raise SystemExit("%s: %d auto-select lines in the server's log"
                         % (what, len(found)))
    best, listed, secs = found[0]
    ms = {k: float(v[:-2]) for k, v in (x.split("=") for x in
                                        listed.split(", "))}
    impl = json.loads(srv.get("/healthz")[1])["robustness"][
        "device_path"]["scan_impl"]
    finite = [v for v in ms.values() if v < float("inf")]
    if sorted(ms) != sorted(BAKE_OFF_IMPLS) or not finite \
            or best != impl or ms[impl] != min(finite):
        raise SystemExit("%s: the bake-off timed %s and installed %s; the "
                         "server serves %s" % (what, ms, best, impl))
    n = 2 * BAKE_OFF_LAUNCHES
    want = {"pair_scan": [(*BAKE_OFF_SHAPE, False, n)],
            "step_scan": [(*BAKE_OFF_SHAPE, True, n)]}
    got = {k: [(x["B"], x["L"], x["carried"], x["launches"])
               for x in v["shapes"]]
           for k, v in kernel_shapes(srv, "autoselect").items()}
    if got != want:
        raise SystemExit("%s: the bake-off's launches under the autoselect "
                         "scope are %s, want %s" % (what, got, want))
    return {"impl": impl, "ms": ms, "seconds": float(secs),
            "launches": {k: sum(x[3] for x in v) for k, v in got.items()}}


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
                  pool: np.ndarray, dev: torch.device, kind: str,
                  class_ids: bool = False) -> dict:
    """A kernel at each (B, L, carried) shape another process launched
    it at (``shape_delta``): rows of ``pool`` cut to that shape's latest
    lengths (and a seeded carried state and sticky match where the
    launches carried one), through ``scanner`` -- parity with the plain
    version, device time at the plan's segment length and unsplit, the
    plain version's time (one host-driven call).  Each shape's times
    count once per launch of it; the bound counts the work that process's
    launches asked for.  Same result layout as ``retime_launches``.
    ``class_ids``: the scanner is a ``PairScanner``, whose launch takes
    int32 class ids (``classes_for``, mapped beforehand and left out of
    the timed launch), 4 bytes a token in the bound."""
    from ingress_plus_tpu_torch.ops.scan import classes_for, from_numpy_u32

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
        kargs = args
        if class_ids:
            kargs = [classes_for(tables.byte_class, args[0], args[1]).to(
                torch.int32).contiguous()] + args[1:]
        tm = timed_plan(lambda seg: run(*kargs, segment=seg), B, L, W,
                        reps=10)
        bd = bound_counts(B, L, W, K1, 4 if class_ids else 1, s["carried"],
                          kind, s["steps"], s["odd_rows"], k)
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


def wire_wants(requests, want) -> tuple:
    """The verdicts a server gives ``requests`` on the wire: phase 3's
    CPU verdicts ``want``, except for the bodies the Batcher reroutes to
    the stream lane (no 16 KB truncation there), which get the CPU
    stream engine's on the whole body.  Returns (wants, rerouted ids)."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.weights import load_pack

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
    return want, rerouted


def phase_serve(requests, want, stream_keys, smi: str) -> dict:
    """The serve plane on the card, driven over the wire (phase 8) with
    the server's defaults; then the same requests against a
    ``--confirm-workers auto`` server, for the pooled confirm's effect
    under one interpreter lock."""
    from ingress_plus_tpu_torch.utils.stream_corpus import stream_cases
    from ingress_plus_tpu_torch.utils.trace import (
        stage_breakdown_from_metrics,
    )

    cases = stream_cases(STREAM_BODY, STREAM_CHUNK, SEED)
    want, rerouted = wire_wants(requests, want)
    with ServeChild(*PINNED_IMPL) as srv:
        path = json.loads(srv.get("/healthz")[1])["robustness"][
            "device_path"]
        if path["backend"] != "cuda" or path["scan_impl"] != "pallas3":
            raise SystemExit("serve: /healthz device_path %s, want backend "
                             "cuda and scan impl pallas3" % path)
        shapes0 = kernel_shapes(srv)
        launches0 = kernel_launches(srv.metrics())
        waves = [request_wave(srv.sock, requests, [want]),
                 request_wave(srv.sock, requests[:SECOND_WAVE],
                              [want[:SECOND_WAVE]])]
        # the phase 6 bodies: the response leak as one response-scan
        # frame (rerouted to the stream lane), the others chunked
        stream_wall = stream_wave("serve", srv.sock, cases, stream_keys,
                                  STREAM_CHUNK, len(cases) - 1)["wall_s"]
        metrics = srv.metrics()
        shapes1 = kernel_shapes(srv)
        launches1 = kernel_launches(metrics)
        startup_s = srv.startup_s
    engine_us = check_serve_metrics("defaults", metrics)
    promlint_samples = lint_exposition("serve (phase 8) /metrics", metrics)
    launches = {k: launches1.get(k, 0) - launches0.get(k, 0)
                for k in ("pair_scan", "step_scan")}
    if launches["pair_scan"] <= 0 or launches["step_scan"] <= 0:
        raise SystemExit("serve: kernels of the path never launched: %s"
                         % launches)
    shapes = shape_delta(shapes0, shapes1)
    workers = int(metric_values(metrics, "ipt_confirm_workers")[0][1])
    with ServeChild("--confirm-workers", "auto") as pooled:
        # the defaults' --scan-impl auto: the startup bake-off
        auto = check_auto_select("serve", pooled)
        log("serve: scan impl auto-select: %s (%s ms a pass), bake-off "
            "%.2f s, launches %s under the autoselect scope"
            % (auto["impl"], auto["ms"], auto["seconds"], auto["launches"]))
        auto_waves = [request_wave(pooled.sock, requests, [want]),
                      request_wave(pooled.sock, requests[:SECOND_WAVE],
                                   [want[:SECOND_WAVE]])]
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
        "promlint_samples": promlint_samples,
        "confirm_workers_auto": {
            "scan_impl": auto["impl"], "auto_select": auto,
            "confirm_workers": int(metric_values(
                auto_metrics, "ipt_confirm_workers")[0][1]),
            "waves": auto_waves,
            "stage_breakdown": stage_breakdown_from_metrics(auto_metrics)},
    }
    log("serve: %d requests over %d connections x %d in flight, identical "
        "to the cpu reference (%d rerouted to the stream lane); %.1f / %.1f "
        "req/s on the wire (two waves), p50 %.2f ms p99 %.2f ms; 7 streams "
        "identical, %.3f MB/s; %d confirm worker(s); kernel launches %s; "
        "--confirm-workers auto (%d, on %s): %.1f / %.1f req/s, p50 %.2f ms "
        "p99 %.2f ms"
        % (len(requests), SERVE_CONNECTIONS, SERVE_WINDOW, len(rerouted),
           waves[0]["wire_req_per_s"], waves[1]["wire_req_per_s"],
           waves[0]["p50_ms"], waves[0]["p99_ms"], res["stream_mb_per_s"],
           workers, launches, res["confirm_workers_auto"]["confirm_workers"],
           auto["impl"],
           auto_waves[0]["wire_req_per_s"], auto_waves[1]["wire_req_per_s"],
           auto_waves[0]["p50_ms"], auto_waves[0]["p99_ms"]))
    return res, shapes, traffic_pool(requests, cases)


def phase_serve_kernels(tables, shapes, pool, dev: torch.device,
                        label: str = "serve") -> dict:
    """Both kernels at a server's own shapes (``shape_delta``; phase 8's,
    phase 11's): the pair kernel as ``pallas3`` runs it
    (``ByteScanner``), the step kernel as the stream lane does."""
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import scan_bytes, scan_pairs
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    return {
        "pair_scan": retime_shapes(
            label + " pair", ByteScanner(tables), PAIR_SCAN,
            lambda t, n, *c: scan_pairs(tables, t, n, *c), tables,
            shapes["pair_scan"], pool, dev, "pair"),
        "step_scan": retime_shapes(
            label + " step", StepScanner(tables), STEP_SCAN,
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


def reference_keys(cr, requests, **state) -> tuple:
    """The port's CPU verdict keys of ``requests`` on pack ``cr`` (and
    ``state``: the pipeline's tenant masks and ACLs, phase 16), with the
    Batcher's oversized reroute applied (as phase 8 does), and the
    indices of the rerouted requests."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    cpu = DetectionPipeline(cr, device="cpu", fail_open=False, **state)
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
    args = ("--rules-dir", info["rules_dir"], "--lkg-dir", lkg) + PINNED_IMPL
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
        res["dbg"] = dbg_views("rollout (phase 9)", srv.port, ("rollout",))
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


# ------------------------------------------------- phase 11: post + head

#: phase 11: the post plane's knobs on the server (the export cadence and
#: the rate detectors' thresholds), and the staged head's calibration
#: margin (head 1 keeps the trainer's default, 1e-4).  A margin of 0.1
#: lowers the threshold past four benign large-body requests of the wave
#: (learned score 3.7907 against head 1's 3.7960), and the rollout's
#: verdict-diff gate rolls such a head back, as it should
POST_ARGS = ("--export-interval-s", "0.5", "--brute-threshold", "8",
             "--dirbust-threshold", "12")
HEAD2_MARGIN = 1e-3
#: phase 11: the dbg views run against the server once its traffic ran
PHASE11_DBG = ("conf", "health", "metrics", "latency", "tenants", "rules",
               "drift", "breaker", "faults", "scoring")
#: the clients of the login flood and the wordlist sweep
FLOOD_CLIENT = "203.0.113.77"
SWEEP_CLIENT = "198.51.100.9"


def phase3_requests() -> list:
    """Phase 3's requests: the seeded corpus plus the large bodies."""
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    requests = [lr.request for lr in generate_corpus(n=2048, seed=SEED)]
    return requests + large_body_requests(Request)


def post_traffic(requests) -> tuple:
    """Phase 11's wave: ``requests`` without the bodies the Batcher
    reroutes to the stream lane (``calm``), then the benign fixtures
    (where a head changes verdicts), the login flood and the sweep.
    Returns (traffic, number of calm requests)."""
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.utils.benign_fixtures import fixture_requests

    plan_of = SimpleNamespace(OVERSIZE_THRESHOLD=Batcher.OVERSIZE_THRESHOLD)
    calm = [r for r in requests if Batcher._reroute_plan(plan_of, r) is None]
    return calm + fixture_requests() + rate_requests(Request), len(calm)


def post_cpu_reference(out: str, n: int) -> int:
    """Phase 11's CPU side, in a child process beside the card work: the
    feature export on the CPU (saved at ``out``-features), heads 1 and 2
    trained on it, both heads' CPU pipeline verdict keys and
    ``scorer_diff`` over the wave, a CPU ``PostChannel`` fed the wave's
    (request, head 1 verdict) pairs (its folded export and status), and
    ``persist_lkg_scorer`` of head 2 (at ``out``-lkg).  Prints it as
    JSON."""
    from ingress_plus_tpu_torch.learn.head import persist_lkg_scorer
    from ingress_plus_tpu_torch.learn.train import (
        TrainConfig,
        train_from_dataset,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.post import PostChannel
    from ingress_plus_tpu_torch.post.brute import BruteConfig
    from ingress_plus_tpu_torch.serve.protocol import (
        decode_request,
        encode_request,
    )
    from ingress_plus_tpu_torch.utils.export_corpus import (
        build_feature_dataset,
    )
    from ingress_plus_tpu_torch.weights import load_pack

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    ds = build_feature_dataset(n=n, device="cpu")
    ds.save(out + "-features")
    features_s = time.perf_counter() - t0
    heads = {"head1": train_from_dataset(ds),
             "head2": train_from_dataset(ds, TrainConfig(margin=HEAD2_MARGIN))}
    traffic, n_calm = post_traffic(phase3_requests())
    cr = load_pack()
    res = {"features_s": features_s, "n_calm": n_calm,
           "versions": {k: h.version for k, h in heads.items()}}
    verdicts = {}
    for name, h in heads.items():
        cpu = DetectionPipeline(cr, device="cpu", fail_open=False,
                                scoring_head=h)
        verdicts[name] = run_pipeline(cpu, traffic)
        res[name] = {"keys": [verdict_key(v) for v in verdicts[name]],
                     "scorer_diff": dict(cpu.stats.scorer_diff)}
    # the post channel, each request as the server decodes it off the
    # wire (its id is the wire id, as request_wave numbers them)
    spool = tempfile.mkdtemp(prefix="ipt-post-cpu")
    try:
        channel = PostChannel(spool_dir=spool, brute_config=BruteConfig(
            threshold=8, dirbust_threshold=12))
        for i, (r, v) in enumerate(zip(traffic, verdicts["head1"])):
            _, mode, wire = decode_request(
                encode_request(r, i + 1, mode=2)[8:])
            wire.mode = mode
            channel.record(wire, v)
        channel.exporter.flush_once()
        res["attacks"] = attack_totals(spooled(spool))
        res["status"] = channel.status()
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    persist_lkg_scorer(heads["head2"], out + "-lkg")
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


def rate_requests(Request) -> list:
    """A login flood (12 clean credential posts from one client) and a
    wordlist sweep (15 distinct paths from another), shaped like
    ``tests/test_brute_e2e.py``'s."""
    out = []
    for i in range(12):
        body = b"user=admin&pass=hunter%d" % i
        out.append(Request(
            method="POST", uri="/account/login",
            headers={"host": "shop.example.com",
                     "x-real-ip": FLOOD_CLIENT,
                     "content-type": "application/x-www-form-urlencoded",
                     "content-length": str(len(body))},
            body=body, request_id="flood-%d" % i))
    for i in range(15):
        out.append(Request(
            uri="/backup/%02d/config.old" % i,
            headers={"host": "shop.example.com",
                     "x-real-ip": SWEEP_CLIENT},
            request_id="sweep-%d" % i))
    return out


class Sink:
    """An HTTP collector on a free local port: keeps every record the
    exporter POSTs."""

    def __init__(self):
        import http.server
        import threading

        self.records: list = []
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                sink.records.extend(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = "http://127.0.0.1:%d/collect" % self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def attack_totals(records) -> dict:
    """Exported attack records folded by (tenant, client, class): the
    counts and blocked counts summed, the max score kept.  The exporter
    aggregates each drain on its own, so one key may span records (how
    many depends on arrival, and is not kept)."""
    out: dict = {}
    for r in records:
        k = "%s|%s|%s" % (r["tenant"], r["client"], r["class"])
        t = out.setdefault(k, {"count": 0, "blocked": 0, "max_score": 0})
        t["count"] += r["count"]
        t["blocked"] += r["blocked"]
        t["max_score"] = max(t["max_score"], r["max_score"])
    return out


def spooled(spool: str) -> list:
    out = []
    for name in sorted(os.listdir(spool)):
        if name.startswith("attacks") and name.endswith(".jsonl"):
            with open(os.path.join(spool, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


#: the /wallarm-status counters held against the CPU channel (the queue,
#: the exporter's own tallies, the order-dependent top-k sketch and the
#: clock are not)
STATUS_COUNTERS = ("requests", "attacks", "blocked", "monitored",
                   "fail_open", "by_class", "by_tenant", "shed_by_tenant",
                   "degraded_by_tenant")


def lkg_files(d: str, version: str) -> tuple:
    """A scorer LKG's pointer and ``.json`` bytes and its arrays."""
    from ingress_plus_tpu_torch.learn.head import SCORER_LKG_POINTER

    with open(os.path.join(d, SCORER_LKG_POINTER), "rb") as f:
        ptr = f.read()
    with open(os.path.join(d, "scorer-%s.json" % version), "rb") as f:
        meta = f.read()
    with np.load(os.path.join(d, "scorer-%s.npz" % version)) as z:
        arrays = {k: z[k] for k in z.files}
    return ptr, meta, arrays


def phase_post_scoring(requests, smi: str, dev: torch.device,
                       server_args=(), n_features: int = 2048) -> tuple:
    """Phase 11: the post plane and the learned scoring head on the card
    (see the module docstring).  ``requests`` are phase 3's (the CPU
    child rebuilds them); ``server_args`` are added to the server's
    command line.  Returns the result and the server's launches by
    kernel and shape."""
    root = tempfile.mkdtemp(prefix="ipt-post")
    try:
        return _phase_post_scoring(root, requests, smi, dev,
                                   tuple(server_args), n_features)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_post_scoring(root, requests, smi, dev, server_args, n_features):
    from ingress_plus_tpu_torch.compiler import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.learn.train import (
        TrainConfig,
        train_from_dataset,
    )
    from ingress_plus_tpu_torch.utils.export_corpus import (
        build_feature_dataset,
    )

    t_phase = time.perf_counter()
    res = {"card": smi}
    traffic, n_calm = post_traffic(requests)
    calm = traffic[:n_calm]
    # 1. the CPU side in a child (features, heads, references), beside
    # the card's feature export, the heads and the server's startup
    ref_base = os.path.join(root, "cpu")
    child = subprocess.Popen(
        [sys.executable, __file__, "--post-cpu-reference", ref_base,
         str(n_features)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        ds = build_feature_dataset(n=n_features, device=dev)
        res["features_card_s"] = time.perf_counter() - t0
        head1 = train_from_dataset(ds)
        head2 = train_from_dataset(ds, TrainConfig(margin=HEAD2_MARGIN))
        if head2.version == head1.version:
            raise SystemExit("post: head 2 equals head 1")
        head_paths = {}
        for name, h in (("head1", head1), ("head2", head2)):
            head_paths[name] = os.path.join(root, name)
            h.save(head_paths[name])
        # the pack the watcher will push: the served rules plus the
        # operator's rule file
        t0 = time.perf_counter()
        grow = compile_ruleset(load_bundled_rules()
                               + parse_seclang(OPERATOR_RULES))
        res["grow_compile_s"] = time.perf_counter() - t0
        spool = os.path.join(root, "spool")
        artifacts = os.path.join(root, "artifacts")
        lkg = os.path.join(root, "lkg")
        os.makedirs(artifacts)
        sink = Sink()
        try:
            with ServeChild("--spool-dir", spool, "--export-url", sink.url,
                            *POST_ARGS, "--artifact-dir", artifacts,
                            "--lkg-dir", lkg, "--scoring-head",
                            head_paths["head1"], *PINNED_IMPL,
                            *server_args) as srv:
                out, err = child.communicate(timeout=900)
                if child.returncode != 0:
                    raise SystemExit("post: the cpu reference failed:\n"
                                     + err[-4000:])
                ref = json.loads(out.strip().splitlines()[-1])
                _post_serve(res, srv, sink, ds, ref, ref_base, traffic, calm,
                            (head1, head2), head_paths, grow, spool,
                            artifacts, root)
                metrics = srv.metrics()
                shapes = res.pop("_shapes")
            check_serve_metrics("post plane and scoring head", metrics)
        finally:
            sink.close()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    res["export_delivered"] = metric_values(
        metrics, "ipt_post_attacks_exported_total")[0][1]
    res["export_errors"] = metric_values(
        metrics, "ipt_post_export_errors_total")[0][1]
    if res["export_errors"]:
        raise SystemExit("post: %d export errors" % res["export_errors"])
    # the scorer LKG the promote wrote: the CPU persist's files
    got = lkg_files(lkg, head2.version)
    want = lkg_files(ref_base + "-lkg", head2.version)
    if got[0] != want[0] or got[1] != want[1] or \
            sorted(got[2]) != sorted(want[2]) or any(
                got[2][k].dtype != want[2][k].dtype
                or not np.array_equal(got[2][k], want[2][k])
                for k in want[2]):
        raise SystemExit("post: the scorer LKG differs from the cpu "
                         "persist_lkg_scorer of head 2")
    res["seconds"] = time.perf_counter() - t_phase
    w, a = res["wave"], res["after"]
    log("post plane and scoring head: features card == cpu (%d rows x %d "
        "rules; card %.1fs, cpu %.1fs), head fingerprints equal (%s, %s); "
        "head 1 flips %s; %d wire verdicts equal the cpu pipeline's under "
        "head 1, %.1f req/s p50 %.2f ms p99 %.2f ms; export equal to the "
        "cpu channel's (%d keys, %d records, rate events %s; delivered %d, "
        "errors %d); watcher staged grow %s %.1fs after the save "
        "(admission %s s), aborted; head 2 admitted (%s s) and live in "
        "%.1fs over %d waves; after live %.1f req/s p50 %.2f ms p99 %.2f "
        "ms; scorer LKG equal to the cpu's; launches %s; %.1fs; %s"
        % (ds.n, ds.n_features, res["features_card_s"],
           res["features_cpu_s"], head1.version, head2.version,
           json.dumps(res["scorer_flips"]), len(traffic),
           w["wire_req_per_s"], w["p50_ms"], w["p99_ms"],
           res["export"]["keys"], res["export"]["records"],
           json.dumps(res["export"]["rate_events"]),
           res["export_delivered"], res["export_errors"], grow.version,
           res["watcher"]["staged_after_s"],
           json.dumps(res["watcher"]["admission_s"]),
           json.dumps(res["head2_admission_s"]),
           res["head2_admit_to_live_s"], len(res["head2_waves"]),
           a["wire_req_per_s"], a["p50_ms"], a["p99_ms"],
           json.dumps(res["launches"]), res["seconds"], smi))
    return res, shapes


def _post_serve(res, srv, sink, ds, ref, ref_base, traffic, calm, heads,
                head_paths, grow, spool, artifacts, root) -> None:
    """Phase 11 against its running server (steps 1-7 of the module
    docstring's phase 11, after the startup); fills ``res``."""
    from ingress_plus_tpu_torch.learn.features import FeatureDataset

    head1, head2 = heads
    res["startup_s"] = srv.startup_s
    res["features_cpu_s"] = ref["features_s"]
    cpu_ds = FeatureDataset.load(ref_base + "-features")
    for k in ("x", "x_candidates", "y", "rule_ids"):
        a, b = getattr(ds, k), getattr(cpu_ds, k)
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            raise SystemExit("post: the card's feature export differs from "
                             "the cpu's in %s" % k)
    if ref["versions"] != {"head1": head1.version, "head2": head2.version}:
        raise SystemExit("post: heads trained on the card's features %s "
                         "differ from the cpu's %s"
                         % ([head1.version, head2.version], ref["versions"]))
    if ref["n_calm"] != len(calm):
        raise SystemExit("post: the cpu reference's wave differs")
    res["features"] = {"rows": ds.n, "rules": ds.n_features,
                       "attacks": int(ds.y.sum()),
                       "confirmed_bits": int(ds.x.sum()),
                       "candidate_bits": int(ds.x_candidates.sum()),
                       "fingerprint": ds.fingerprint()}
    res["heads"] = {n: {"version": h.version, "threshold": h.threshold,
                        "baseline": h.provenance["baseline"]["learned"]}
                    for n, h in (("head1", head1), ("head2", head2))}
    res["head_flips_head1_vs_head2"] = sum(
        a != b for a, b in zip(ref["head1"]["keys"], ref["head2"]["keys"]))
    if res["head_flips_head1_vs_head2"]:
        raise SystemExit("post: head 2 changes %d verdicts of the wave; the "
                         "rollout's verdict-diff gate would roll it back"
                         % res["head_flips_head1_vs_head2"])
    sc = json.loads(srv.get("/scoring")[1])
    if not sc["active"] or sc["head"]["version"] != head1.version:
        raise SystemExit("post: the server does not serve head 1: %s" % sc)
    serve0, ro0 = kernel_shapes(srv), kernel_shapes(srv, "rollout")
    # 4. the wave: every wire verdict the CPU's under head 1
    res["wave"] = request_wave(srv.sock, traffic, [ref["head1"]["keys"]])
    diff = {lab: v for lab, v in metric_values(
        srv.metrics(), "ipt_scorer_diff_total")}
    want_diff = {'{kind="%s"}' % k: float(v)
                 for k, v in ref["head1"]["scorer_diff"].items()}
    if diff != want_diff:
        raise SystemExit("post: ipt_scorer_diff_total %s, the cpu "
                         "pipeline's scorer_diff %s" % (diff, want_diff))
    res["scorer_flips"] = ref["head1"]["scorer_diff"]
    # 6 (started now, checked after 5): the watcher's push
    t_push = time.perf_counter()
    grow.save(os.path.join(root, "grow"))
    for ext in (".npz", ".json"):       # the JSON lands last
        shutil.copy(os.path.join(root, "grow" + ext),
                    os.path.join(artifacts, "grow" + ext))
    # 5. the export, against the CPU channel
    want_attacks = ref["attacks"]
    deadline = time.perf_counter() + 15
    while True:
        got_sink = attack_totals(sink.records)
        got_spool = attack_totals(spooled(spool))
        if got_sink == want_attacks == got_spool:
            break
        if time.perf_counter() > deadline:
            bad = {k: (got_sink.get(k), got_spool.get(k), w)
                   for k, w in want_attacks.items()
                   if not got_sink.get(k) == got_spool.get(k) == w}
            bad.update({k: (v, "not exported by the cpu channel")
                        for k, v in got_sink.items()
                        if k not in want_attacks})
            raise SystemExit("post: the export differs from the cpu "
                             "channel's: %s" % json.dumps(bad)[:4000])
        time.sleep(0.25)
    for cls, client in (("brute", FLOOD_CLIENT), ("dirbust", SWEEP_CLIENT)):
        n = sum(1 for r in sink.records
                if r["class"] == cls and r["client"] == client)
        if n != 1:
            raise SystemExit("post: %d %s events for %s, want 1"
                             % (n, cls, client))
    status = json.loads(srv.get("/wallarm-status")[1])
    want_status = ref["status"]
    for k in STATUS_COUNTERS:
        if status[k] != want_status[k]:
            raise SystemExit("post: /wallarm-status %s %s, the cpu "
                             "channel's %s" % (k, status[k], want_status[k]))
    rate = {k: v for k, v in status["export_events"].items()
            if k.split(":")[0] in ("brute", "dirbust")}
    want_rate = {k: v for k, v in want_status["export_events"].items()
                 if k.split(":")[0] in ("brute", "dirbust")}
    if rate != want_rate:
        raise SystemExit("post: /wallarm-status rate events %s, the cpu "
                         "channel's %s" % (rate, want_rate))
    res["export"] = {"keys": len(want_attacks), "records": len(sink.records),
                     "rate_events": rate,
                     "status": {k: status[k] for k in (
                         "requests", "attacks", "blocked")}}
    # 6. the watcher's push lands: grow staged, then aborted
    deadline = time.perf_counter() + 40
    while True:
        st = http_json(srv.port, "GET", "/rollout")[1]
        if st["candidate"] == grow.version and st["state"] in (
                "admitted", "shadow", "canary"):
            break
        if st["state"] == "rejected" or time.perf_counter() > deadline:
            raise SystemExit("post: the watcher's push of %s did not "
                             "stage: %s" % (grow.version, st))
        time.sleep(0.25)
    res["watcher"] = {"staged_after_s": time.perf_counter() - t_push,
                      "state": st["state"], "admission_s": st["admission_s"],
                      "replay": st["last_admission"]["replay"]}
    status, body = http_json(srv.port, "POST", "/rollout",
                             {"action": "abort"})
    if not body.get("aborted") or body["state"] != "rolled_back":
        raise SystemExit("post: abort of the watcher's push failed: %s"
                         % body)
    # 7. head 2, staged to live under waves
    calm_keys = {n: ref[n]["keys"][:len(calm)] for n in ("head1", "head2")}
    status, rep = http_json(srv.port, "POST", "/configuration/scoring",
                            {"path": head_paths["head2"], **ROLLOUT_KNOBS})
    if status != 200 or not rep.get("staged"):
        raise SystemExit("post: head 2 was not admitted: %d %s"
                         % (status, rep))
    st = http_json(srv.port, "GET", "/rollout")[1]
    res["head2_admission_s"] = st["admission_s"]
    res["head2_replay"] = rep["replay"]
    waves, st = drive_until(srv, calm,
                            [calm_keys["head1"], calm_keys["head2"]],
                            ("live", "rolled_back", "rejected"))
    if st["state"] != "live":
        m = srv.metrics()
        raise SystemExit("post: head 2 ended %s (%s; diff %s, shadow %s, "
                         "candidate requests %d; ladder %s, degraded %s)"
                         % (st["state"], st["rollback_reason"], st["diff"],
                            st["shadow"], st["candidate_requests"],
                            metric_values(m, "ipt_degraded_mode"),
                            metric_values(m, "ipt_degraded_verdicts_total")))
    res["head2_waves"] = waves
    res["head2_rollout"] = {k: st[k] for k in (
        "candidate_requests", "shadow", "diff", "promotions")}
    res["head2_admit_to_live_s"] = (event_time(st, "live")
                                    - event_time(st, "admitted"))
    sc = json.loads(srv.get("/scoring")[1])
    if sc["head"]["version"] != head2.version:
        raise SystemExit("post: live, but /scoring serves %s"
                         % sc["head"]["version"])
    res["after"] = request_wave(srv.sock, traffic, [ref["head2"]["keys"]])
    serve1, ro1 = kernel_shapes(srv), kernel_shapes(srv, "rollout")
    res["_shapes"] = merge_shapes(shape_delta(serve0, serve1),
                                  shape_delta(ro0, ro1))
    res["launches"] = {
        "serve_scope": {k: serve1[k]["launches"] - serve0[k]["launches"]
                        for k in serve1},
        "rollout_scope": {k: ro1[k]["launches"] - ro0[k]["launches"]
                          for k in ro1}}
    if res["launches"]["serve_scope"]["pair_scan"] <= 0:
        raise SystemExit("post: the server never launched the pair kernel")
    res["dbg"] = dbg_views("post (phase 11)", srv.port, PHASE11_DBG)


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
            "wall_s": wall}


# ---------------------------------- phase 12: native confirm and tooling

#: phase 12 (b): the confirm bench children's corpus and best-of (cut
#: from 1024 and 3 to keep the whole run inside its time budget with
#: phases 13 and 14)
CONFIRM_REQS = 512
CONFIRM_ITERS = 2
#: phase 12 (d): the F1 gate's corpus size, card and CPU children alike
#: (cut from 2048 for the same reason)
F1_N = 1024
#: phase 12 (e): the scaled pack's factor, the kernels' shapes on it, and
#: the requests its pipelines take (phase 3's first)
SCALE_FACTOR = 2.0
SCALE_SHAPES = ((SCAN_B, 64), (SCAN_B, 2048), (SPLIT_B, 16384))
SCALE_REQUESTS = 512
F1_COUNTS = ("n", "tp", "fp", "fn", "tn", "blocked", "precision", "recall",
             "f1", "per_class_recall", "per_family")


def repo_child(args, env=None) -> subprocess.Popen:
    """``python -m <args>`` from the repository root, output captured."""
    return subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def child_json(what: str, proc: subprocess.Popen, timeout: float) -> dict:
    """The last stdout line of a ``repo_child`` as JSON; killed, and the
    run failed, on a timeout or a non-zero exit."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise SystemExit("%s failed (rc %s):\n%s" % (what, proc.returncode,
                                                     err[-4000:]))
    return json.loads(out.strip().splitlines()[-1])


def cli_start(runs: dict) -> dict:
    """``python -m`` children of this checkout, all started together:
    ``runs`` maps a name to its argument list."""
    return {name: repo_child(args) for name, args in runs.items()}


def cli_collect(what: str, procs: dict, timeout: float = 300.0) -> dict:
    """Wait for ``cli_start``'s children: each must exit 0 with output on
    stdout (else all are killed and the run fails).  {name: the number
    of lines it printed}."""
    t0 = time.perf_counter()
    out = {}
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if proc.returncode != 0 or not so.strip():
                raise SystemExit("%s: %s exited with %s:\n%s\n%s"
                                 % (what, name, proc.returncode,
                                    so[-2000:], se[-2000:]))
            out[name] = len(so.strip().splitlines())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("%s: %s exited 0 (lines printed: %s)"
        % (what, ", ".join(procs), json.dumps(out)))
    return out


def dbg_views(what: str, port: int, cmds) -> dict:
    """``python -m ingress_plus_tpu_torch.control.dbg <cmd> --server``
    against a server (or, for ``fleet``, the aggregator) on ``port``."""
    return cli_collect(what + ": dbg", cli_start({
        cmd: ["ingress_plus_tpu_torch.control.dbg", cmd, "--server",
              "127.0.0.1:%d" % port] for cmd in cmds}))


def lint_exposition(what: str, text: str, fleet: bool = False) -> int:
    """The port's promlint on a Prometheus exposition: no finding, or the
    run fails.  The number of samples it read."""
    from ingress_plus_tpu_torch.analysis.promlint import check_exposition

    findings = check_exposition(text, fleet=fleet)
    if findings:
        raise SystemExit("%s: promlint finds %d: %s"
                         % (what, len(findings), findings[:5]))
    n = sum(1 for ln in text.splitlines() if ln and not ln.startswith("#"))
    log("%s: promlint clean on %d samples" % (what, n))
    return n


def confirm_strings(pl, requests) -> dict:
    """Every argument string the confirm stage hands ``detect_sqli`` and
    ``detect_xss`` over ``requests`` (one run of ``pl``), by detector."""
    from ingress_plus_tpu_torch.models import libdetect

    seen = {"sqli": [], "xss": []}
    real = {"sqli": libdetect.detect_sqli, "xss": libdetect.detect_xss}

    def recorder(kind):
        def rec(data, max_len=4096):
            seen[kind].append(bytes(data))
            return real[kind](data, max_len)
        return rec

    libdetect.detect_sqli = recorder("sqli")
    libdetect.detect_xss = recorder("xss")
    try:
        run_pipeline(pl, requests)
    finally:
        libdetect.detect_sqli = real["sqli"]
        libdetect.detect_xss = real["xss"]
    return seen


def fuzz_strings(seed: int) -> list:
    """Seeded fuzz over a grammar-shaped alphabet (quotes, comments,
    keywords, operators) and NUL-free binary strings."""
    words = [b"union", b"select", b"from", b"or", b"and", b"sleep", b"like",
             b"<script", b"onload", b"javascript:", b"data:", b"base64",
             b"&#", b"0x41", b"--", b"/*", b"*/", b"''", b'""']
    alphabet = list(b"'\"`\\-#/*;=<>()|&!~^@,. \t\n0123456789abcxyzOSUN_$")
    rng = random.Random(seed)
    out = []
    for _ in range(3000):
        out.append(b"".join(
            rng.choice(words) if rng.random() < 0.3
            else bytes([rng.choice(alphabet)])
            for _ in range(rng.randint(1, 24))))
    for _ in range(500):
        out.append(bytes(rng.randrange(1, 256)
                         for _ in range(rng.randint(0, 200))))
    return out


def native_parity(dev: torch.device, requests) -> dict:
    """(a) The twin against the Python detectors on every string the
    main path's confirm stage passes them over ``requests``, plus the
    seeded fuzz: identical booleans, or fail."""
    from ingress_plus_tpu_torch.models import libdetect
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.weights import load_pack

    lib = libdetect.native_library()
    if lib is None:
        raise SystemExit("the native confirm twin is switched off "
                         "(IPT_NO_NATIVE_CONFIRM is set)")
    seen = confirm_strings(DetectionPipeline(load_pack(), device=dev,
                                             fail_open=False), requests)
    fuzz = fuzz_strings(SEED)
    python = {"sqli": libdetect.detect_sqli_py,
              "xss": libdetect.detect_xss_py}
    native = {"sqli": lib.ipt_detect_sqli, "xss": lib.ipt_detect_xss}
    res = {}
    for kind in ("sqli", "xss"):
        unique = sorted(set(seen[kind])) + fuzz
        nul, hits, bad = 0, 0, []
        for data in unique:
            window = data[:4096]
            if b"\x00" in window:
                nul += 1            # the dispatch's Python path
                continue
            want = python[kind](data)
            if bool(native[kind](window, len(window))) != want:
                bad.append(data[:80])
            hits += want
        if bad:
            raise SystemExit("native %s differs from Python on %d strings, "
                             "first %r" % (kind, len(bad), bad[0]))
        res[kind] = {"calls": len(seen[kind]),
                     "unique": len(set(seen[kind])), "fuzz": len(fuzz),
                     "nul_windows": nul, "true": hits}
    log("native confirm twin: identical to the Python detectors on every "
        "string the main path's confirm stage passed them (%d requests) "
        "and on %d fuzz strings: %s" % (len(requests), len(fuzz),
                                        json.dumps(res)))
    return res


def confirm_ab(platform: str = "cuda") -> dict:
    """(b) ``microbench --confirm`` on ``platform`` (the card) twice, as
    child processes: with the twin and with ``IPT_NO_NATIVE_CONFIRM=1``."""
    out = {}
    for tag, off in (("native", False), ("python", True)):
        env = dict(os.environ)
        env.pop("IPT_NO_NATIVE_CONFIRM", None)
        if off:
            env["IPT_NO_NATIVE_CONFIRM"] = "1"
        t0 = time.perf_counter()
        r = child_json("microbench --confirm (%s)" % tag, repo_child(
            ["ingress_plus_tpu_torch.utils.microbench", "--confirm",
             "--reqs", str(CONFIRM_REQS), "--iters", str(CONFIRM_ITERS),
             "--platform", platform], env), 600)
        r["child_s"] = time.perf_counter() - t0
        if r["device"] != platform or r["native"] != (not off):
            raise SystemExit("microbench --confirm (%s) ran device %s, "
                             "native %s" % (tag, r["device"], r["native"]))
        out[tag] = r
        for cfg in ("mixed/off", "mixed/qr+memo", "flood/qr+memo"):
            c = r[cfg]
            log("confirm A/B %s %s: %.1f req/s, confirm_us %d of %d us "
                "wall (%.1f%%), memo hits %d"
                % (tag, cfg, c["req_per_s"], c["confirm_ms"] * 1e3,
                   c["wall_ms"] * 1e3, 100 * c["confirm_ms"] / c["wall_ms"],
                   c["memo_hits"]))
    if out["native"]["verdicts_sha256"] != out["python"]["verdicts_sha256"]:
        raise SystemExit("microbench --confirm: verdicts differ between the "
                         "native twin and the Python detectors")
    log("confirm A/B: the same verdicts (%s) with the twin and without"
        % out["native"]["verdicts_sha256"][:16])
    return out


def serve_confirm_ab(requests, want) -> dict:
    """(b) on the wire: two servers with their defaults but
    :data:`PINNED_IMPL` (an A/B of the confirm alone), one with the
    twin and one with ``IPT_NO_NATIVE_CONFIRM=1``, both up at once and
    given phase 3's requests (without the bodies the Batcher reroutes) in
    turns: twin, Python, Python, twin.  Every verdict is phase 3's CPU
    verdict; per server the waves' rates and latencies and the confirm
    stage's p50/p99 from its ``/metrics``."""
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.utils.trace import (
        stage_breakdown_from_metrics,
    )

    plan_of = SimpleNamespace(OVERSIZE_THRESHOLD=Batcher.OVERSIZE_THRESHOLD)
    calm = [i for i, r in enumerate(requests)
            if Batcher._reroute_plan(plan_of, r) is None]
    reqs, wants = [requests[i] for i in calm], [[want[i] for i in calm]]
    env = dict(os.environ)
    env.pop("IPT_NO_NATIVE_CONFIRM", None)
    out = {"requests": len(reqs), "native": {"waves": []},
           "python": {"waves": []}}
    with ServeChild(*PINNED_IMPL, env=env) as twin, \
            ServeChild(*PINNED_IMPL,
                       env=dict(env, IPT_NO_NATIVE_CONFIRM="1")) as py:
        servers = {"native": twin, "python": py}
        for tag in ("native", "python", "python", "native"):
            out[tag]["waves"].append(
                request_wave(servers[tag].sock, reqs, wants))
        for tag, srv in servers.items():
            metrics = srv.metrics()
            check_serve_metrics("confirm A/B (%s)" % tag, metrics)
            out[tag]["confirm_stage"] = stage_breakdown_from_metrics(
                metrics)["confirm"]
    for tag in ("native", "python"):
        w, c = out[tag]["waves"], out[tag]["confirm_stage"]
        log("serve confirm A/B %s: %s req/s on the wire, p50 %s ms, p99 %s "
            "ms; confirm stage p50 %.0f us p99 %.0f us"
            % (tag, " / ".join("%.1f" % x["wire_req_per_s"] for x in w),
               " / ".join("%.2f" % x["p50_ms"] for x in w),
               " / ".join("%.2f" % x["p99_ms"] for x in w),
               c["p50_us"], c["p99_us"]))
    return out


def f1_card_vs_cpu(platform: str = "cuda") -> dict:
    """(d) ``evalf1 --platform cuda`` (``platform``) and ``--platform
    cpu`` as child processes side by side: tp, fp, fn, tn (and every
    other count) equal."""
    # the CPU child on one thread, so that it leaves the card child's
    # host cores alone
    procs = [repo_child(["ingress_plus_tpu_torch.utils.evalf1", "--n",
                         str(F1_N), "--platform", p],
                        dict(os.environ, OMP_NUM_THREADS="1")
                        if p == "cpu" else None)
             for p in (platform, "cpu")]
    card, cpu = [child_json("evalf1 child", proc, 600) for proc in procs]
    if (card["platform"], cpu["platform"]) != (platform, "cpu"):
        raise SystemExit("evalf1 ran on %s and %s" % (card["platform"],
                                                      cpu["platform"]))
    diff = [k for k in F1_COUNTS if card[k] != cpu[k]]
    if diff:
        raise SystemExit("evalf1: the card's %s differ from the CPU's"
                         % diff)
    log("evalf1 n=%d: card = cpu: tp %d fp %d fn %d tn %d, F1 %.4f; "
        "%.1f req/s on the card, %.1f on the cpu (children side by side)"
        % (card["n"], card["tp"], card["fp"], card["fn"], card["tn"],
           card["f1"], card["req_s"], cpu["req_s"]))
    return {"card": {k: card[k] for k in F1_COUNTS + ("req_s",)},
            "cpu_req_s": cpu["req_s"]}


def scaled_pack(dev: torch.device, requests) -> dict:
    """(e) The 2x pack: ``scale_rules(load_bundled_rules(), 2.0)``
    compiled by the port; both kernels against their plain versions at
    ``SCALE_SHAPES`` (carried state and sticky match), timed; a card
    pipeline on it over phase 3's first requests against the CPU's, its
    launches re-run on their buckets."""
    from ingress_plus_tpu_torch.compiler import compile_ruleset
    from ingress_plus_tpu_torch.compiler.packgen import scale_rules
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import (
        ScanTables,
        from_numpy_u32,
        scan_bytes,
        scan_pairs,
    )
    from ingress_plus_tpu_torch.ops.segments import WORD_TILE
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner

    t0 = time.perf_counter()
    cr = compile_ruleset(scale_rules(load_bundled_rules(), SCALE_FACTOR))
    compile_s = time.perf_counter() - t0
    tables = ScanTables.from_bitap(cr.tables, dev)
    W, K1 = tables.n_words, tables.class_table.shape[0]
    tiles = -(-W // WORD_TILE)
    res = {"factor": SCALE_FACTOR, "rules": cr.n_rules, "W": W, "K1": K1,
           "word_tiles": tiles, "last_tile_words": W - WORD_TILE * (tiles - 1),
           "table_slice_bytes": K1 * WORD_TILE * 4, "compile_s": compile_s,
           "shapes": []}
    log("2x pack: %d rules, W=%d words = %d word tiles (the last holds %d "
        "words), K+1=%d: each block's class-table slice %d B of shared "
        "memory; compiled in %.2fs"
        % (cr.n_rules, W, tiles, res["last_tile_words"], K1,
           res["table_slice_bytes"], compile_s))
    rng = np.random.default_rng(SEED + 12)
    kernels = {"pair_scan": (PAIR_SCAN, ByteScanner(tables), scan_pairs,
                             "pair"),
               "step_scan": (STEP_SCAN, StepScanner(tables), scan_bytes,
                             "step")}
    for B, L in SCALE_SHAPES:
        toks_np, len_np, match_np, state_np = (
            scan_inputs if B == SCAN_B else split_inputs)(L, W, rng)
        args = (torch.from_numpy(toks_np).to(dev),
                torch.from_numpy(len_np).to(dev),
                from_numpy_u32(state_np, dev), from_numpy_u32(match_np, dev))
        for name, (kernel, scanner, plain, kind) in kernels.items():
            m_ref, s_ref = plain(tables, *args)
            m, s = scanner(*args)
            torch.cuda.synchronize()
            if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                raise SystemExit(
                    "2x pack: %s disagrees with its plain version at B=%d "
                    "L=%d: match diff words=%d state diff words=%d"
                    % (name, B, L, int((m != m_ref).sum()),
                       int((s != s_ref).sum())))
            err = max(int((m.long() - m_ref.long()).abs().max()),
                      int((s.long() - s_ref.long()).abs().max()))
            run = forced(kernel, scanner)
            tm = timed_plan(lambda seg: run(*args, segment=seg), B, L, W)
            plain_ms = time_ms(lambda: plain(tables, *args),
                               reps=2 if L >= 8192 else 5)
            b = bound(len_np, L, W, K1, 1, carried=True, kernel=kind)
            res["shapes"].append({"kernel": name, "B": B, "L": L, **tm,
                                  "plain_ms": plain_ms, "max_abs_err": err,
                                  **b})
            log("2x pack %s B=%d L=%d W=%d K1=%d G=%d (%d segments): "
                "bit-identical match+state; %.4f ms device (one segment "
                "%.4f ms; plain %.3f ms, bound %.4f ms by %s/%s, %.2fx)"
                % (name, B, L, W, K1, tm["G"], tm["segments"], tm["ms"],
                   tm["one_segment_ms"], plain_ms, b["bound_ms"],
                   b["bound_by"], b["pipe"], tm["ms"] / b["bound_ms"]))
    reqs = requests[:SCALE_REQUESTS]
    gpu = DetectionPipeline(cr, device=dev, fail_open=False)
    cpu = DetectionPipeline(cr, device="cpu", fail_open=False)
    want = [verdict_key(v) for v in run_pipeline(cpu, reqs)]
    PAIR_SCAN.launches = 0                       # count this path only
    t1 = time.perf_counter()
    got = run_pipeline(gpu, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = PAIR_SCAN.launches
    check_verdicts("2x pack pipeline", got, want)
    inputs = bucket_inputs(gpu, reqs)
    if launches <= 0 or launches != len(inputs):
        raise SystemExit("the 2x pack pipeline launched the pair kernel %d "
                         "times for %d buckets" % (launches, len(inputs)))
    log("2x pack pipeline: %d requests, identical verdicts cuda vs cpu, %d "
        "pair-kernel launches (= buckets); %.1f req/s (host clock, confirm "
        "included, first run)" % (len(reqs), launches, len(reqs) / wall))
    res.update(requests=len(reqs), identical_verdicts=len(reqs),
               launches=launches, wall_s=wall,
               attacks=sum(v.attack for v in got))
    res["retimed"] = retime_launches(
        "2x pack path", ByteScanner(tables), PAIR_SCAN,
        lambda t, n: scan_pairs(tables, t, n), tables, inputs, dev, "pair")
    return res


def phase_native_kernels(dev: torch.device, requests) -> dict:
    """Phase 12 (a) and (e) (the module docstring): checks and device
    times, run beside phase 6's CPU child."""
    t0 = time.perf_counter()
    res = {"native": native_parity(dev, requests),
           "scaled": scaled_pack(dev, requests)}
    res["seconds"] = time.perf_counter() - t0
    return res


def phase_tooling_ab(dev: torch.device, requests, want) -> dict:
    """Phase 12 (b), (c) and (d): rates that move with the host's load,
    run after phase 11 with nothing else running."""
    from ingress_plus_tpu_torch.utils.microbench import bench_scan_modes

    t0 = time.perf_counter()
    res = {"confirm_ab": confirm_ab(dev.type),
           "serve_confirm_ab": serve_confirm_ab(requests, want)}
    scan = bench_scan_modes(device=dev)
    if not scan["interpret_parity"]["ok"]:
        raise SystemExit("microbench --scan: a kernel differs from its "
                         "plain version: %s" % scan["interpret_parity"])
    res["scan_modes"] = scan
    res["f1"] = f1_card_vs_cpu(dev.type)
    res["seconds"] = time.perf_counter() - t0
    return res



# ---------------------------------------------- phase 13: the mesh

#: phase 13 (b): the mesh whose eight entries all name the one card
MESH_SHAPE = (2, 4)
#: phase 13 (c): the ring's shards (entries of the one card)
RING_SHARDS = 4


def mesh_buckets(pl, requests) -> list:
    """Every (tokens, lengths, row_req, row_sv) bucket of a pipeline's
    run over ``requests`` in batches of BATCH, with its batch's Q pad."""
    out = []
    for i in range(0, len(requests), BATCH):
        batch = requests[i:i + BATCH]
        q = pl._pad_q(len(batch))
        out += [(b, q) for b in pl._build_scan_buckets(batch)[0]]
    return out


def same_outputs(what: str, got, want) -> None:
    """(rule hits, class hits, scores) exactly equal, or fail."""
    for name, g, w in zip(("rule hits", "class hits", "scores"), got, want):
        if g.shape != w.shape or not (g == w).all():
            raise SystemExit("mesh %s: %s differ from the reference"
                             % (what, name))


def mesh_rows(tok: np.ndarray, ln: np.ndarray, n_data: int) -> tuple:
    """A bucket as the mesh step lays it out (``MeshEngine._dispatch``):
    rows padded to n_data * B_s (B_s a power of two, at least 8), L to
    even; the (B_s, L) slice of each data row."""
    B, L = tok.shape
    B_s = max(8, 1 << int(np.ceil(np.log2(max(1, -(-B // n_data))))))
    tok2 = np.zeros((n_data * B_s, L + L % 2), np.uint8)
    len2 = np.zeros((n_data * B_s,), np.int32)
    tok2[:B, :L] = tok
    len2[:B] = ln
    return [(tok2[d * B_s:(d + 1) * B_s], len2[d * B_s:(d + 1) * B_s])
            for d in range(n_data)]


def mesh_launches(srv) -> int:
    status, body = srv.get("/debug/kernels")
    if status != 200:
        raise SystemExit("mesh: /debug/kernels answered %d" % status)
    return sum(sum(r) for r in json.loads(body)["mesh"]["shard_launches"])


def phase_mesh(cr, dev: torch.device, requests, want, cases,
               pool: np.ndarray) -> dict:
    """Phase 13: ``parallel/`` on the one card (module docstring)."""
    from ingress_plus_tpu_torch.models.engine import (
        CARD_ROUNDS,
        DetectionEngine,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, PairScanner
    from ingress_plus_tpu_torch.ops.scan import ScanTables, scan_pairs
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner
    from ingress_plus_tpu_torch.parallel import make_mesh
    from ingress_plus_tpu_torch.parallel.serve_mesh import MeshEngine
    from ingress_plus_tpu_torch.parallel.stream import ring_scan

    t0 = time.perf_counter()
    # (a) the 1x1 mesh on the card against the plain CPU mesh step
    cpu = DetectionPipeline(cr, device="cpu", fail_open=False)
    buckets = mesh_buckets(cpu, requests)
    ref_mesh = MeshEngine(cr, make_mesh(1, 1, devices=["cpu"]))
    refs = [ref_mesh.detect(*b, q) for b, q in buckets]
    # the mesh step gates stream-variants row by row, the single engine
    # request by request (as in the JAX package): its rule hits must be
    # a subset of the single engine's, and the verdicts equal
    single = DetectionEngine(cr, device=dev)
    wider = 0
    for (b, q), ref in zip(buckets, refs):
        rh1 = single.detect(*b, q)[0]
        if (ref[0] & ~rh1).any():
            raise SystemExit("mesh: a rule hit the single-device engine "
                             "does not have")
        wider += int((rh1 & ~ref[0]).sum())
    res = {"buckets": len(buckets), "single_engine_extra_rule_hits": wider,
           "impls": {}}
    one = {}
    for impl, kernel, other in (("pallas2", PAIR_SCAN, STEP_SCAN),
                                ("take", STEP_SCAN, PAIR_SCAN)):
        eng = MeshEngine(cr, make_mesh(1, 1, devices=[dev]), scan_impl=impl)
        for (b, q), ref in zip(buckets, refs):
            same_outputs("1x1 %s step" % impl, eng.detect(*b, q), ref)
        pl = DetectionPipeline(cr, device=dev, fail_open=False, engine=eng)
        run_pipeline(pl, requests[:BATCH])          # warm-up (not counted)
        torch.cuda.synchronize()
        PAIR_SCAN.launches = STEP_SCAN.launches = 0
        t1 = time.perf_counter()
        got = run_pipeline(pl, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {"pair_scan": PAIR_SCAN.launches,
                    "step_scan": STEP_SCAN.launches}
        check_verdicts("1x1 mesh %s pipeline" % impl, got, want)
        if kernel.launches != len(buckets) or other.launches:
            raise SystemExit("mesh: the 1x1 %s pipeline launched %s for %d "
                             "buckets" % (impl, launches, len(buckets)))
        res["impls"][impl] = {"launches": launches, "wall_s": wall,
                              "req_per_s_confirm_included":
                                  len(requests) / wall}
        one[impl] = eng
        log("mesh (a): 1x1 %s on %s: %d buckets equal the plain cpu step, "
            "%d verdicts equal the cpu pipeline, %s, %.1f req/s"
            % (impl, dev, len(buckets), len(requests), launches,
               len(requests) / wall))

    # (b) the 2x4 mesh, every entry the one card
    n_data, n_model = MESH_SHAPE
    eng24 = MeshEngine(cr, make_mesh(n_data, n_model,
                                     devices=[dev] * (n_data * n_model)))
    if eng24.scan_impl != "pallas2":
        raise SystemExit("mesh: the constructor's impl on cuda is %s"
                         % eng24.scan_impl)
    ones = [one["pallas2"].detect(*b, q) for b, q in buckets]
    PAIR_SCAN.launches = 0
    for (b, q), ref in zip(buckets, ones):
        same_outputs("2x4 step", eng24.detect(*b, q), ref)
    if PAIR_SCAN.launches != n_data * n_model * len(buckets):
        raise SystemExit("mesh: the 2x4 step launched %d times for %d "
                         "buckets" % (PAIR_SCAN.launches, len(buckets)))
    sh = eng24.sharded
    seen, checked = set(), 0
    for b, _q in buckets:
        tok, ln = b[0], b[1]
        if tok.shape in seen:
            continue
        seen.add(tok.shape)
        for rows_tok, rows_len in mesh_rows(tok, ln, n_data):
            t_d = torch.from_numpy(rows_tok).to(dev)
            n_d = torch.from_numpy(rows_len)
            for s_ in range(n_model):
                tabs = sh.shard_tables(dev, s_).scan
                m, st = sh.scanner(dev, s_)(t_d, n_d)
                m_ref, s_ref = scan_pairs(tabs, t_d, n_d.to(dev))
                if not (torch.equal(m, m_ref) and torch.equal(st, s_ref)):
                    raise SystemExit("mesh: shard %d's PairScanner differs "
                                     "from scan_pairs at %dx%d"
                                     % (s_, *rows_tok.shape))
                checked += 1
    # every launch of the 2x4 steps again, on its own rows and shard:
    # bit-identical to scan_pairs, timed as phase 3's launches are
    rows = [r for b, _q in buckets for r in mesh_rows(b[0], b[1], n_data)]
    per_shard = []
    for s_ in range(n_model):
        tabs = sh.shard_tables(dev, s_).scan
        per_shard.append(retime_launches(
            "pair mesh 2x4 shard %d" % s_, sh.scanner(dev, s_), PAIR_SCAN,
            lambda t, n, tabs=tabs: scan_pairs(tabs, t, n), tabs, rows, dev,
            "pair", class_ids=True))
    total24 = {k: sum(r["total"][k] for r in per_shard)
               for k in ("launches", "ms", "one_segment_ms", "plain_ms",
                         "bound_ms", "ops_ms", "bytes_ms")}
    total24["bound_by"] = ("operations"
                           if total24["ops_ms"] >= total24["bytes_ms"]
                           else "bytes")
    total24["max_abs_err"] = 0
    if total24["launches"] != n_data * n_model * len(buckets):
        raise SystemExit("mesh: %d 2x4 launches re-timed for %d made"
                         % (total24["launches"],
                            n_data * n_model * len(buckets)))
    res["mesh_2x4"] = {"launches": n_data * n_model * len(buckets),
                       "w_shard": sh.st.w_shard, "k_max": sh.st.k_max,
                       "shard_checks": checked,
                       "shapes": sorted("%dx%d" % x for x in seen)}
    res["retimed_2x4"] = {"total": total24, "shapes": [
        {"shard": i, **a} for i, r in enumerate(per_shard)
        for a in r["shapes"].values()]}
    log("mesh (b): 2x4 on one card (w_shard %d, k_max %d): %d steps equal "
        "the 1x1's; %d (shard, data row, shape) launches bit-identical to "
        "scan_pairs; %d launches %.4f ms device (bound %.5f ms, %.1fx)"
        % (sh.st.w_shard, sh.st.k_max, len(buckets), checked,
           total24["launches"], total24["ms"], total24["bound_ms"],
           total24["ms"] / total24["bound_ms"]))
    # the mesh's bake-off (global rows, as MeshEngine serves); its
    # launches are the autoselect scope's, none the shards' serving tally
    scoped = {k.name: k.scope_launches("autoselect")
              for k in (PAIR_SCAN, STEP_SCAN)}
    served0 = [list(r) for r in sh.shard_launches]
    t1 = time.perf_counter()
    timings = eng24.autoselect_scan_impl()
    bake_s = time.perf_counter() - t1
    scoped = {k.name: k.scope_launches("autoselect") - scoped[k.name]
              for k in (PAIR_SCAN, STEP_SCAN)}
    steps = (1 + CARD_ROUNDS * MESH_BAKE_OFF_ITERS) * n_data * n_model
    if sorted(timings) != ["pallas2", "take"] \
            or eng24.scan_impl != min(timings, key=timings.get) \
            or scoped != {"pair_scan": steps, "step_scan": steps} \
            or [list(r) for r in sh.shard_launches] != served0:
        raise SystemExit("mesh: the 2x4 bake-off timed %s, installed %s, "
                         "launched %s under the autoselect scope"
                         % (timings, eng24.scan_impl, scoped))
    for (b, q), ref in zip(buckets, refs):
        same_outputs("2x4 step on %s after the bake-off" % eng24.scan_impl,
                     eng24.detect(*b, q), ref)
    res["mesh_2x4"]["auto_select"] = {
        "impl": eng24.scan_impl, "seconds": bake_s,
        "ms_per_step": {k: v * 1e3 / MESH_BAKE_OFF_ITERS
                        for k, v in timings.items()},
        "launches": scoped}
    log("mesh (b): the 2x4 bake-off installed %s (%s ms a step of 256 rows "
        "x 256 bytes, median of %d rounds), %.2f s; %s launches under the "
        "autoselect scope; every bucket equals the plain cpu step after it"
        % (eng24.scan_impl, res["mesh_2x4"]["auto_select"]["ms_per_step"],
           CARD_ROUNDS, bake_s, scoped))

    # (c) the ring over RING_SHARDS entries of the card, phase 6's bodies
    bodies = [c.body for c in cases]
    L = max(len(x) for x in bodies)
    L = -(-L // RING_SHARDS) * RING_SHARDS
    toks = np.zeros((len(bodies), L), np.uint8)
    lens = np.asarray([len(x) for x in bodies], np.int32)
    for i, x in enumerate(bodies):
        toks[i, :len(x)] = np.frombuffer(x, np.uint8)
    tables = ScanTables.from_bitap(cr.tables, dev)
    ring_mesh = make_mesh(1, RING_SHARDS, devices=[dev] * RING_SHARDS)
    STEP_SCAN.launches = 0
    ring = ring_scan(tables, ring_mesh, toks, lens)
    ring_launches = STEP_SCAN.launches
    whole, _ = StepScanner(tables)(torch.from_numpy(toks).to(dev),
                                   torch.from_numpy(lens))
    torch.cuda.synchronize()
    if not torch.equal(ring, whole) or not bool(ring.any()):
        raise SystemExit("mesh: ring_scan differs from the contiguous scan")
    tok_dev = torch.from_numpy(toks).to(dev)
    len_host = torch.from_numpy(lens)
    res["ring"] = {
        "bodies": len(bodies), "L": L, "shards": RING_SHARDS,
        "launches": ring_launches,
        "ring_ms": time_ms(lambda: ring_scan(tables, ring_mesh, toks, lens),
                           reps=3),
        "contiguous_ms": time_ms(lambda: StepScanner(tables)(tok_dev,
                                                             len_host),
                                 reps=3)}
    log("mesh (c): ring_scan over %d shards of the card on %d bodies "
        "(L=%d) equals one contiguous scan; %d launch(es), %.2f ms vs "
        "%.2f ms contiguous (host clock around the call, CUDA events)"
        % (RING_SHARDS, len(bodies), L, ring_launches, res["ring"]["ring_ms"],
           res["ring"]["contiguous_ms"]))

    # (d) the server with --mesh 1x1 on the card, over the wire
    wants, rerouted = wire_wants(requests, want)
    with ServeChild("--mesh", "1x1", *MESH_PINNED_IMPL) as srv:
        path = json.loads(srv.get("/healthz")[1])["robustness"][
            "device_path"]
        if path["backend"] != "cuda" or path["scan_impl"] != "pallas2":
            raise SystemExit("mesh: /healthz device_path %s, want cuda "
                             "and pallas2" % path)
        info = json.loads(srv.get("/rules/stats")[1])["device"]["mesh"]
        shapes0, mesh0 = kernel_shapes(srv), mesh_launches(srv)
        wave = request_wave(srv.sock, requests, [wants])
        shapes1, mesh1 = kernel_shapes(srv), mesh_launches(srv)
        metrics = srv.metrics()
    check_serve_metrics("--mesh 1x1", metrics)
    shapes = shape_delta(shapes0, shapes1)
    served = sum(x["launches"] for x in shapes["pair_scan"])
    if served <= 0 or served != mesh1 - mesh0:
        raise SystemExit("mesh: the server's pallas2 launches %d, its "
                         "shards' %d" % (served, mesh1 - mesh0))
    tabs = one["pallas2"].sharded.shard_tables(dev, 0).scan
    retimed = retime_shapes(
        "pair mesh", PairScanner(tabs), PAIR_SCAN,
        lambda t, n, *c: scan_pairs(tabs, t, n, *c), tabs,
        shapes["pair_scan"], pool, dev, "pair", class_ids=True)
    res["serve"] = {"mesh": {k: info[k] for k in ("data", "model",
                                                  "w_shard", "k_max")},
                    "rerouted_to_stream_lane": rerouted,
                    "pallas2_launches": served, **wave}
    res["retimed"] = retimed
    res["seconds"] = time.perf_counter() - t0
    log("mesh (d): --mesh 1x1 server: %d verdicts equal the cpu reference, "
        "%.1f req/s on the wire, p50 %.2f ms p99 %.2f ms; %d pallas2 "
        "launches; phase 13 %.1f s"
        % (len(requests), wave["wire_req_per_s"], wave["p50_ms"],
           wave["p99_ms"], served, res["seconds"]))
    return res


# --------------------------------------------- phase 14: the fleet

#: phase 14: the front's probe cadence (s)
FRONT_PROBE_S = "0.2"
#: phase 14: the share of a wave's time after which a backend is killed
KILL_AT = 0.3


def front_nodes(front) -> dict:
    status, body = front.get("/front/nodes")
    if status != 200:
        raise SystemExit("fleet: /front/nodes answered %d" % status)
    return {r["name"]: r for r in json.loads(body)}


def wait_node(front, name: str, pred, what: str, limit_s: float = 60.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        row = front_nodes(front)[name]
        if pred(row):
            return row, time.perf_counter() - t0
        time.sleep(0.1)
    raise SystemExit("fleet: node %s never %s: %s" % (name, what, row))


def kill_wave(front, victim, requests, wants, after_s: float) -> dict:
    """``requests`` through ``front`` with ``victim`` SIGKILLed
    ``after_s`` into the wave: one verdict per request, each the
    reference's or the front's fail-open one (never a block)."""
    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.protocol import encode_request

    units = [(i + 1, [encode_request(r, i + 1, mode=2)])
             for i, r in enumerate(requests)]
    box = {}

    def run():
        try:
            box["out"] = drive(front.sock, units, SERVE_CONNECTIONS,
                               SERVE_WINDOW, timeout=300)
        except BaseException as e:          # reported on the main thread
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    th.start()
    time.sleep(after_s)
    victim.child.kill()
    victim.child.wait()
    killed_at = time.perf_counter() - t0
    th.join(timeout=600)
    if "error" in box or th.is_alive():
        raise SystemExit("fleet: the kill wave failed: %s"
                         % box.get("error", "timeout"))
    out = box["out"]
    if sorted(out) != list(range(1, len(requests) + 1)):
        raise SystemExit("fleet: %d of %d verdicts came back"
                         % (len(out), len(requests)))
    fail_open = 0
    for i, r in enumerate(requests):
        resp = out[i + 1][0]
        if resp["fail_open"]:
            fail_open += 1
            if resp["blocked"]:
                raise SystemExit("fleet: a fail-open verdict blocked")
        elif wire_key(r.request_id, resp) != wants[i]:
            raise SystemExit("fleet: verdict %s differs from the cpu "
                             "reference" % r.request_id)
    return {"requests": len(requests), "verdicts": len(out),
            "fail_open": fail_open, "killed_at_s": killed_at,
            "wall_s": time.perf_counter() - t0}


def repo_json(args, timeout: float) -> dict:
    """A ``python -m`` child of this checkout; its stdout as JSON."""
    proc = subprocess.run([sys.executable, "-m", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise SystemExit("fleet: %s exited with %d:\n%s"
                         % (args[0], proc.returncode, proc.stderr[-3000:]))
    return json.loads(proc.stdout)


def phase_fleet(requests, want, smi: str) -> dict:
    """Phase 14: two card backends behind the front (module docstring)."""
    t0 = time.perf_counter()
    wants, _ = wire_wants(requests, want)
    res = {"card": smi}
    n0, n1 = ServeChild(), ServeChild()
    children = [n0, n1]
    aggregator = []
    try:
        for n in (n0, n1):
            n.start()
        for n in (n0, n1):
            n.ready()

        def backend(name, n):
            return "%s=%s@127.0.0.1:%d" % (name, n.sock, n.port)

        two = ServeChild("--front", "--backend", backend("n0", n0),
                         "--backend", backend("n1", n1),
                         "--probe-interval-s", FRONT_PROBE_S)
        one = ServeChild("--front", "--backend", backend("n0", n0),
                         "--probe-interval-s", FRONT_PROBE_S)
        children += [two, one]
        for f in (two, one):
            f.start()
        for f in (two, one):
            f.ready()
        first = request_wave(two.sock, requests, [wants])
        rows = front_nodes(two)
        if min(rows[n]["forwarded"] for n in ("n0", "n1")) <= 0:
            raise SystemExit("fleet: the front used one backend: %s" % rows)
        res["through_front"] = {**first, "forwarded": {
            n: rows[n]["forwarded"] for n in rows}}
        log("fleet: %d verdicts through the front equal the direct "
            "server's; forwarded %s" % (len(requests),
                                        res["through_front"]["forwarded"]))
        # one backend against two on the one card, in turns
        turns = []
        for name, f in (("one", one), ("two", two), ("two", two),
                        ("one", one)):
            w = request_wave(f.sock, requests, [wants])
            turns.append({"backends": name, **{k: w[k] for k in (
                "wire_req_per_s", "p50_ms", "p99_ms", "wall_s")}})
            log("fleet: %s backend(s) behind the front: %.1f req/s, p50 "
                "%.2f ms p99 %.2f ms" % (name, w["wire_req_per_s"],
                                         w["p50_ms"], w["p99_ms"]))
        res["one_vs_two"] = turns
        # SIGKILL n1 mid-wave, then restart it on its socket and port
        res["kill"] = kill_wave(two, n1, requests, wants,
                                KILL_AT * first["wall_s"])
        row, _ = wait_node(two, "n1", lambda r: r["state"] != "up",
                           "ejected")
        res["kill"]["eject_reason"] = row["eject_reason"]
        n1b = ServeChild(sock=n1.sock, port=n1.port)
        children.append(n1b)
        n1b.start().ready()
        row, secs = wait_node(
            two, "n1", lambda r: r["state"] == "up" and r["readmissions"] >= 1,
            "re-admitted")
        res["restart"] = {"state": row["state"],
                          "readmissions": row["readmissions"],
                          "startup_s": n1b.startup_s,
                          "readmitted_after_ready_s": secs}
        after = request_wave(two.sock, requests, [wants])
        res["after_restart"] = {k: after[k] for k in (
            "wire_req_per_s", "p50_ms", "p99_ms")}
        log("fleet: n1 SIGKILLed %.2f s into a wave: %d of %d verdicts, %d "
            "failed open; ejected (%s), restarted, re-admitted %d time(s); "
            "then %.1f req/s"
            % (res["kill"]["killed_at_s"], res["kill"]["verdicts"],
               len(requests), res["kill"]["fail_open"],
               res["kill"]["eject_reason"], row["readmissions"],
               after["wire_req_per_s"]))
        # the fleet telemetry plane and the retune daemon over both
        nodes = ["n0=127.0.0.1:%d" % n0.port, "n1=127.0.0.1:%d" % n1b.port]
        node_args = [a for n in nodes for a in ("--node", n)]
        health = repo_json(["ingress_plus_tpu_torch.control.fleetobs",
                            *node_args, "--once"], 120)
        if health["nodes_up"] != 2:
            raise SystemExit("fleet: fleetobs --once: %s" % health)
        agg_port = free_port()
        aggregator.append(subprocess.Popen(
            [sys.executable, "-m", "ingress_plus_tpu_torch.control.fleetobs",
             *node_args, "--port", str(agg_port), "--interval-s", "0.5"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.abspath(__file__))))
        per_node = {n: metric_values(c.metrics(), "ipt_requests_total")[0][1]
                    for n, c in (("n0", n0), ("n1", n1b))}
        fleet_total, t1 = None, time.perf_counter()
        while time.perf_counter() - t1 < 30:
            try:
                status, body = http_get(agg_port, "/fleet/metrics", 5)
            except OSError:
                status = 0
            if status == 200:
                vals = metric_values(body.decode(), "ipt_requests_total")
                if vals:
                    fleet_total = vals[0][1]
                    if fleet_total == sum(per_node.values()):
                        break
            time.sleep(0.25)
        if fleet_total != sum(per_node.values()):
            raise SystemExit("fleet: /fleet/metrics ipt_requests_total %s, "
                             "nodes %s" % (fleet_total, per_node))
        res["promlint_fleet_samples"] = lint_exposition(
            "fleet (phase 14) /fleet/metrics", body.decode(), fleet=True)
        res["dbg"] = dbg_views("fleet (phase 14)", agg_port, ("fleet",))
        lkg = tempfile.mkdtemp(prefix="ipt")
        rec = repo_json(["ingress_plus_tpu_torch.control.retuned",
                         "--fleet-url", "127.0.0.1:%d" % agg_port,
                         *node_args, "--lkg-dir", lkg, "--once"], 300)
        shutil.rmtree(lkg, ignore_errors=True)
        if not (rec.get("result", "").startswith(("skip:", "rollout:"))
                and rec.get("cycle") == 1):
            raise SystemExit("fleet: retuned --once: %s" % rec)
        res["telemetry"] = {"fleetobs_once_nodes_up": health["nodes_up"],
                            "fleet_requests_total": fleet_total,
                            "per_node": per_node,
                            "retuned": {k: rec.get(k) for k in (
                                "cycle", "result", "detail")}}
        log("fleet: fleetobs: ipt_requests_total %s = sum of nodes %s; "
            "retuned --once: %s" % (fleet_total, per_node, rec["result"]))
        for c in (n0, n1b):
            check_serve_metrics("fleet backend", c.metrics())
    finally:
        for proc in aggregator:
            proc.terminate()
            proc.wait(timeout=30)
        for c in reversed(children):
            if getattr(c, "child", None) is not None:   # started
                c.__exit__(None, None, None)
    res["seconds"] = time.perf_counter() - t0
    return res

# --------------------------------------------- phase 15: quality gates

#: phase 15: benign requests of the quality report; the prefilter-loss
#: gate's corpus size, mutants per attack and seed
QUALITY_BENIGN = 10_000
GATE_N = 2048
GATE_FUZZ = 2
GATE_SEED = 20260729
#: what the JAX package's gate gives at that size, fuzz and seed on the
#: CPU: ``ingress_plus_tpu.utils.prefilter_gate.run_gate(n=2048,
#: fuzz_per_attack=2, seed=20260729)``
GATE_JAX = {"requests_base": 2048, "requests_fuzzed": 1178,
            "requests_total": 3226, "rules": 2009,
            "confirm_only_rule_hits": 6987, "normal_rule_hits": 6987,
            "mismatches": 0, "ruleset_version": "cfd7d977236656ca"}
#: the quality report's yardstick, read as data
QUALITY_JSON = os.path.join("reports", "QUALITY.json")
QUALITY_BLOCKS = ("evasion", "benign", "benign_fixture", "ruleset")


def quality_traffic() -> list:
    """The requests phase 15 sends (the mutants aside): the evasion
    corpus, the benign corpus, the fixtures and the gate's corpus."""
    from ingress_plus_tpu_torch.utils.benign_fixtures import fixture_corpus
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus
    from ingress_plus_tpu_torch.utils.evasion import (
        generate_benign,
        generate_evasion,
    )

    return ([s.labeled.request for s in generate_evasion()]
            + [b.request for b in generate_benign(n=QUALITY_BENIGN)]
            + [f.request for f in fixture_corpus()]
            + [lr.request for lr in generate_corpus(
                n=GATE_N, attack_fraction=0.3, seed=GATE_SEED)])


def phase_quality(dev: torch.device) -> tuple:
    """Phase 15: the quality report and the prefilter-loss gate on card
    pipelines, with the analyzers' CLIs beside them (module docstring).
    Returns (result, the pair kernel's launches by shape, the traffic
    pool)."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
    from ingress_plus_tpu_torch.utils.prefilter_gate import run_gate
    from ingress_plus_tpu_torch.utils.quality_report import build_report

    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           QUALITY_JSON)) as f:
        yardstick = json.load(f)
    analyzers = cli_start({
        "rulecheck": ["ingress_plus_tpu_torch.analysis"],
        "concheck": ["ingress_plus_tpu_torch.analysis", "--conc"],
        "evadecheck": ["ingress_plus_tpu_torch.analysis", "--evade"]})
    try:
        def grid():
            return {"pair_scan": {"launches": PAIR_SCAN.scope_launches(),
                                  "shapes": PAIR_SCAN.shape_snapshot()}}

        # (a) the quality report on a card pipeline
        before = grid()
        PAIR_SCAN.launches = 0
        t1 = time.perf_counter()
        rep = build_report(n_benign=QUALITY_BENIGN, device=dev)
        torch.cuda.synchronize()
        report_s = time.perf_counter() - t1
        report_launches = PAIR_SCAN.launches
        if (rep["platform"], rep["scan_impl"]) != ("cuda", "pallas3"):
            raise SystemExit("quality: the report ran on %s/%s"
                             % (rep["platform"], rep["scan_impl"]))
        for block in QUALITY_BLOCKS:
            got, want = dict(rep[block]), dict(yardstick[block])
            got.pop("note", None)
            want.pop("note", None)
            if got != want:
                raise SystemExit("quality: the card's %s block differs from "
                                 "%s: %s vs %s"
                                 % (block, QUALITY_JSON,
                                    json.dumps(got)[:1500],
                                    json.dumps(want)[:1500]))
        sent = sum(rep[b]["total"]
                   for b in ("evasion", "benign", "benign_fixture"))
        log("quality (a): the card's report equals %s: evasion %d/%d, "
            "benign FPs %d/%d, fixture FPs %d/%d, %d rules; %d requests in "
            "%.1f s, %.1f req/s, %d pair launches"
            % (QUALITY_JSON, rep["evasion"]["detected"],
               rep["evasion"]["total"], rep["benign"]["false_positives"],
               rep["benign"]["total"],
               rep["benign_fixture"]["false_positives"],
               rep["benign_fixture"]["total"], rep["ruleset"]["n_rules"],
               sent, report_s, sent / report_s, report_launches))

        # (b) the gate on a card pipeline, the CPU's prefilter beside it
        cpu = DetectionPipeline(compile_ruleset(load_bundled_rules()),
                                mode="monitoring", device="cpu")
        t2 = time.perf_counter()
        gate = run_gate(n=GATE_N, fuzz_per_attack=GATE_FUZZ, seed=GATE_SEED,
                        device=dev, reference=cpu, progress=False)
        torch.cuda.synchronize()
        gate_s = time.perf_counter() - t2
        launches = PAIR_SCAN.launches
        after = grid()
        if report_launches <= 0 or launches <= report_launches:
            raise SystemExit("quality: the pair kernel launched %d times in "
                             "the report and %d in the gate"
                             % (report_launches, launches - report_launches))
        if (gate["platform"], gate["scan_impl"]) != ("cuda", "pallas3"):
            raise SystemExit("quality: the gate ran on %s/%s"
                             % (gate["platform"], gate["scan_impl"]))
        bad = {k: (gate[k], v) for k, v in GATE_JAX.items() if gate[k] != v}
        if bad or gate["reference_unequal_chunks"]:
            raise SystemExit("quality: the card's gate against the JAX "
                             "package's counts (card, jax): %s; prefilter "
                             "unequal to the cpu's on %d of %d chunks; "
                             "samples %s"
                             % (bad, gate["reference_unequal_chunks"],
                                gate["reference_chunks"],
                                gate["mismatch_samples"][:3]))
        log("quality (b): the card's gate: %d requests (%d fuzzed), %d "
            "confirm-only rule hits = normal, 0 mismatches, the JAX "
            "package's counts; the masked prefilter equals the cpu's on "
            "%d of %d chunks; %.1f s, %.1f req/s, %d pair launches"
            % (gate["requests_total"], gate["requests_fuzzed"],
               gate["confirm_only_rule_hits"], gate["reference_chunks"],
               gate["reference_chunks"], gate_s,
               gate["requests_total"] / gate_s,
               launches - report_launches))
    except BaseException:
        for proc in analyzers.values():
            proc.kill()
            proc.wait()
        raise
    res = {
        "report": {"requests": sent, "wall_s": report_s,
                   "req_per_s": sent / report_s,
                   "launches": report_launches,
                   **{b: {k: rep[b][k] for k in (
                       "total", "detected", "false_positives", "n_rules")
                       if k in rep[b]} for b in QUALITY_BLOCKS}},
        "gate": {"wall_s": gate_s,
                 "req_per_s": gate["requests_total"] / gate_s,
                 "launches": launches - report_launches,
                 **{k: gate[k] for k in (
                     *GATE_JAX, "reference_chunks",
                     "reference_unequal_chunks")}},
        "launches": launches,
        "analyzers": cli_collect("quality (c): analyzers", analyzers),
    }
    shapes = shape_delta(before, after)["pair_scan"]
    if sum(x["launches"] for x in shapes) != launches:
        raise SystemExit("quality: %d pair launches counted, %d tallied by "
                         "shape" % (launches,
                                    sum(x["launches"] for x in shapes)))
    res["seconds"] = time.perf_counter() - t0
    return res, shapes, traffic_pool(quality_traffic(), [])


# ------------------------------- phase 16: the controller sync, config #4

#: phase 16: BASELINE.json config #4 -- 64 namespaces x 4 Ingresses, each
#: namespace with its own subset of the bundled pack's attack-* tags
CONFIG4_SEED = 20260801
CONFIG4_NAMESPACES = 64
CONFIG4_PER_NAMESPACE = 4
#: the Ingresses of this many namespaces change their tags in sync 2
CONFIG4_RETAGGED = 8
CONFIG4_ACL_INGRESSES = 16
#: every attack-* tag of the bundled pack
CONFIG4_TAGS = ("attack-generic", "attack-java", "attack-leak", "attack-lfi",
                "attack-nodejs", "attack-php", "attack-protocol",
                "attack-rce", "attack-rfi", "attack-scanner",
                "attack-session", "attack-sqli", "attack-xss")
#: the ConfigMap's ACL content, by revision (sync 1, sync 2)
CONFIG4_ACLS = {
    1: {"edge": {"deny": ["203.0.113.0/24"],
                 "greylist": ["198.51.100.0/24"]},
        "partners": {"allow": ["192.0.2.0/24"]}},
    2: {"edge": {"deny": ["203.0.113.0/25"],
                 "greylist": ["198.51.100.0/24"]},
        "partners": {"allow": ["192.0.2.0/25"],
                     "deny": ["203.0.113.128/25"]}},
}


def config4_manifests(revision: int = 1,
                      sidecar_http: str = "127.0.0.1:9901") -> tuple:
    """Config #4 as k8s-style dicts: (256 Ingress dicts, ConfigMap dict).
    Every Ingress has its own host and 1-3 paths (some ``Exact``),
    ``wallarm-mode: block``, ``detection-backend: tpu`` and its
    namespace's ``detection-rule-tags`` (1-4 attack tags, seeded, a
    subset no other namespace has); 16
    carry a ``wallarm-acl``.  ``revision`` 2 changes only the tags of
    ``CONFIG4_RETAGGED`` namespaces and the ACL content."""
    rng = random.Random(CONFIG4_SEED)
    ns_tags: list = []

    def fresh(r):
        """A tag subset no namespace has yet."""
        while True:
            tags = sorted(r.sample(CONFIG4_TAGS, r.randint(1, 4)))
            if tags not in ns_tags:
                return tags

    for _ in range(CONFIG4_NAMESPACES):
        ns_tags.append(fresh(rng))
    n = CONFIG4_NAMESPACES * CONFIG4_PER_NAMESPACE
    acl_of = {i: ("partners" if k % 4 == 3 else "edge") for k, i in
              enumerate(sorted(rng.sample(range(n), CONFIG4_ACL_INGRESSES)))}
    shapes = [(rng.randint(1, 3), rng.random() < 0.3) for _ in range(n)]
    if revision == 2:
        rng2 = random.Random(CONFIG4_SEED + 1)
        for ns in rng2.sample(range(CONFIG4_NAMESPACES), CONFIG4_RETAGGED):
            ns_tags[ns] = fresh(rng2)
    prefix = "nginx.ingress.kubernetes.io/"
    items = []
    for i in range(n):
        ns, k = divmod(i, CONFIG4_PER_NAMESPACE)
        ann = {prefix + "wallarm-mode": "block",
               prefix + "detection-backend": "tpu",
               prefix + "detection-rule-tags": ",".join(ns_tags[ns])}
        if i in acl_of:
            ann[prefix + "wallarm-acl"] = acl_of[i]
        n_paths, exact = shapes[i]
        paths = [{"path": p, "pathType": "Prefix",
                  "backend": {"service": {"name": "app-%03d" % i,
                                          "port": {"number": 8080}}}}
                 for p in ("/", "/api", "/static")[:n_paths]]
        if exact:
            paths[-1]["path"] = "/login"
            paths[-1]["pathType"] = "Exact"
        items.append({
            "metadata": {"name": "app-%d" % k,
                         "namespace": "tenant-%02d" % ns,
                         "annotations": ann},
            "spec": {"rules": [{
                "host": "app%d.tenant-%02d.example.com" % (k, ns),
                "http": {"paths": paths}}]}})
    configmap = {"data": {
        "enable-detection": "true", "detection-backend": "tpu",
        "default-mode": "block", "sidecar-http": sidecar_http,
        "acls": json.dumps(CONFIG4_ACLS[revision], sort_keys=True)}}
    return items, configmap


def config4_traffic(n: int, tenants: int, acl_tenants) -> list:
    """(tenant, client_ip) for ``n`` requests, seeded: tenants uniform in
    0..``tenants``; a quarter of the ACL'd tenants' requests come from
    203.0.113.0/24 and a tenth from 192.0.2.0/24, a tenth of the others'
    from 203.0.113.0/24 (no ACL binds them), the rest from 10.0.0.0/8."""
    rng = random.Random(CONFIG4_SEED + 2)
    acl_tenants = set(acl_tenants)
    out = []
    for _ in range(n):
        t = rng.randint(0, tenants)
        u = rng.random()
        bound = t in acl_tenants
        if u < (0.25 if bound else 0.1):
            ip = "203.0.113.%d" % rng.randint(1, 254)
        elif bound and u < 0.35:
            ip = "192.0.2.%d" % rng.randint(1, 254)
        else:
            ip = "10.%d.%d.%d" % (rng.randint(0, 255), rng.randint(0, 255),
                                  rng.randint(1, 254))
        out.append((t, ip))
    return out


def rendered_container(text: str, name: str) -> dict:
    """One container of a rendered manifest (``control/deploy.py``'s
    layout): its ``command`` argv (empty where it has none), its ``env``
    and its liveness probe's ``initialDelaySeconds``."""
    lines = text.splitlines()
    at = lines.index("        - name: %s" % name)
    end = next((k for k in range(at + 1, len(lines))
                if lines[k].startswith("        - name: ")), len(lines))
    out = {"command": [], "env": {}, "liveness_delay_s": None}
    key = None
    for ln in lines[at + 1:end]:
        if ln.startswith("          ") and not ln.startswith("           "):
            key = ln.strip().rstrip(":")
            continue
        item = ln.strip()
        if key == "command" and item.startswith("- "):
            out["command"].append(item[2:].strip('"'))
        elif key == "env" and item.startswith("- {"):
            kv = dict(p.split(": ", 1) for p in item[3:-1].split(", "))
            out["env"][kv["name"]] = kv["value"].strip('"')
        elif key == "livenessProbe" and \
                item.startswith("initialDelaySeconds:"):
            out["liveness_delay_s"] = int(item.split(":")[1])
    return out


def served_command(rendered: list, root: str, port: int,
                   name: str = "serve-0") -> tuple:
    """A rendered serve container's argv (``name``) with this run's
    changes: this run's Python for ``python``, the socket (through
    ``utils/uds.py socket_path``), spool and LKG paths under ``root``,
    ``--http-port`` a free port, ``--rules-dir`` dropped (the server
    serves the bundled pack).  Returns (argv, socket, changes)."""
    from ingress_plus_tpu_torch.utils.uds import socket_path

    argv = list(rendered)
    if argv[:1] != ["python"]:
        raise SystemExit("controller: the render runs %r, not python"
                         % argv[:1])
    argv[0] = sys.executable
    changes = ["python -> %s" % sys.executable]
    paths = {"--socket": socket_path(root, name + ".sock"),
             "--spool-dir": os.path.join(root, name, "spool"),
             "--lkg-dir": os.path.join(root, name, "lkg"),
             "--http-port": str(port)}
    for flag, value in paths.items():
        k = argv.index(flag)
        changes.append("%s %s -> %s" % (flag, argv[k + 1], value))
        argv[k + 1] = value
    k = argv.index("--rules-dir")
    changes.append("--rules-dir %s dropped (the bundled pack)" % argv[k + 1])
    del argv[k:k + 2]
    return argv, paths["--socket"], changes


def config4_keys(cr, requests, tags, acl_payload) -> list:
    """The port's CPU verdict keys of ``requests`` under one controller
    state: the tenant masks of ``tags`` and the ACLs and bindings of the
    pushed ``acl_payload`` (None: no masks, no ACLs), with the Batcher's
    oversized reroute applied as the server does."""
    from ingress_plus_tpu_torch.control.sync import tenant_masks
    from ingress_plus_tpu_torch.models.acl import AclStore

    store = AclStore()
    binding = {}
    if acl_payload is not None:
        store.swap(acl_payload["acls"])
        binding = {int(t): name
                   for t, name in acl_payload["tenant_acl"].items()}
    return reference_keys(
        cr, requests,
        tenant_rule_mask=tenant_masks(cr, tags) if tags else None,
        acl_store=store, tenant_acl=binding)[0]


def phase_controller(requests, smi: str, server_args=()) -> tuple:
    """Phase 16: config #4 through the port's controller render layer
    onto a card server (see the module docstring).  ``requests`` are
    phase 3's; ``server_args`` are added to the rendered command (none
    on the card).  Returns the result and the server's launches by
    kernel and shape."""
    root = tempfile.mkdtemp(prefix="ipt16")
    try:
        return _phase_controller(root, requests, smi, tuple(server_args))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_controller(root, requests, smi, server_args):
    import dataclasses

    from ingress_plus_tpu_torch.control.admission import lint_rendered
    from ingress_plus_tpu_torch.control.deploy import write_static
    from ingress_plus_tpu_torch.control.objects import ConfigMap, Ingress
    from ingress_plus_tpu_torch.control.sync import (
        SyncController,
        tenant_masks,
    )
    from ingress_plus_tpu_torch.weights import load_pack

    t_phase = time.perf_counter()
    res = {"card": smi}
    # 1. the deploy render, and the server its serve-0 container runs
    write_static(os.path.join(root, "static"))
    with open(os.path.join(root, "static", "deployment.yaml")) as f:
        serve0 = rendered_container(f.read(), "serve-0")
    port = free_port()
    argv, sock, changes = served_command(serve0["command"], root, port)
    argv += list(server_args + PINNED_IMPL)
    changes += ["%s added" % a for a in server_args + PINNED_IMPL]
    log("controller: rendered serve-0: %s; env %s; run with these changes: "
        "%s" % (" ".join(serve0["command"]), serve0["env"] or "none",
                "; ".join(changes)))
    res.update(rendered_command=serve0["command"], rendered_env=serve0["env"],
               changes=changes)
    srv = ServeChild(argv=argv, env=dict(os.environ, **serve0["env"]),
                     sock=sock, port=port).start()
    # the objects and the CPU references are host work, done while the
    # server starts
    sidecar = "127.0.0.1:%d" % port
    objects = {}
    for rev in (1, 2):
        items, cm = config4_manifests(rev, sidecar)
        objects[rev] = ([Ingress.from_dict(d) for d in items],
                        ConfigMap.from_dict(cm))
    cr = load_pack()
    try:
        srv.ready()
        res["startup_s"] = srv.startup_s
        res["liveness_initial_delay_s"] = serve0["liveness_delay_s"]
        log("controller: /readyz after %.1f s; the rendered liveness probe "
            "waits %s s" % (srv.startup_s, serve0["liveness_delay_s"]))
        sc = SyncController()
        posts = []
        post = sc._post

        def counted(path, obj):
            posts.append(path)
            return post(path, obj)

        sc._post = counted
        # 2. sync 1: reload, both pushes land at the first attempt
        t = time.perf_counter()
        r1 = sc.sync(*objects[1])
        sync1_s = time.perf_counter() - t
        cfg = r1.configuration
        tags1 = cfg.tenant_tags()
        problems = lint_rendered(r1.rendered)
        if (r1.action != "reload" or problems or r1.errors
                or not (r1.pushed_tenants and r1.pushed_acls)
                or sorted(tags1) != list(range(1, 257)) or len(posts) != 2):
            raise SystemExit(
                "controller: sync 1 gave action %s, lint %s, errors %s, "
                "pushed %s/%s, %d tenants, %d posts"
                % (r1.action, problems[:3], r1.errors[:3], r1.pushed_tenants,
                   r1.pushed_acls, len(tags1), len(posts)))
        status, conf = http_json(port, "GET", "/configuration")
        if status != 200 or conf["tenants"] != 257 or \
                conf["acls"] != sorted(CONFIG4_ACLS[1]):
            raise SystemExit("controller: /configuration after sync 1: %d %s"
                             % (status, conf))
        distinct = len(np.unique(tenant_masks(cr, tags1)[1:], axis=0))
        acl_tenants = sorted(cfg.tenant_acls())
        log("controller: sync 1 %s in %.3f s: %d servers, %d tenants (%d "
            "distinct masks), %d ACL bindings, nginx.conf %d lines, lint "
            "clean; both pushes landed at the first attempt; the server "
            "holds %d mask rows"
            % (r1.action, sync1_s, len(cfg.servers), len(tags1), distinct,
               len(acl_tenants), r1.rendered.count("\n"), conf["tenants"]))
        traffic = config4_traffic(len(requests), 256, acl_tenants)
        reqs = [dataclasses.replace(r, tenant=t, client_ip=ip)
                for r, (t, ip) in zip(requests, traffic)]
        t = time.perf_counter()
        plain = config4_keys(cr, reqs, None, None)
        masked = config4_keys(cr, reqs, tags1, None)
        want1 = config4_keys(cr, reqs, tags1, sc._channels["acl"].payload)
        ref_s = time.perf_counter() - t
        shapes0 = kernel_shapes(srv)
        launches0 = kernel_launches(srv.metrics())
        # 3. wave 1 under sync 1's state
        wave1 = request_wave(sock, reqs, [want1])
        acl_blocked = sum(1 for k in map(json.loads, want1)
                          if k[2] and "acl" in k[5])
        res.update(
            sync1={"action": r1.action, "seconds": sync1_s,
                   "servers": len(cfg.servers), "tenants": len(tags1),
                   "distinct_masks": distinct,
                   "acl_bindings": len(acl_tenants),
                   "rendered_lines": r1.rendered.count("\n"),
                   "server_mask_rows": conf["tenants"]},
            wave1={**wave1, "identical_verdicts": len(reqs),
                   "changed_by_masks": sum(a != b for a, b in
                                           zip(plain, masked)),
                   "changed_by_acls": sum(a != b for a, b in
                                          zip(masked, want1)),
                   "acl_blocked": acl_blocked},
            cpu_reference_s=ref_s)
        log("controller: wave 1, %d requests over the wire, identical to the "
            "cpu pipeline under the pushed masks and ACLs; the masks changed "
            "%d verdicts against the unmasked pipeline's, the ACLs %d more "
            "(%d blocked by an ACL); %.1f req/s, p50 %.2f ms, p99 %.2f ms"
            % (len(reqs), res["wave1"]["changed_by_masks"],
               res["wave1"]["changed_by_acls"], acl_blocked,
               wave1["wire_req_per_s"], wave1["p50_ms"], wave1["p99_ms"]))
        # 4. sync 2: some namespaces' tags and the ACL content change
        n_posts = len(posts)
        r2 = sc.sync(*objects[2])
        tags2 = r2.configuration.tenant_tags()
        retagged = sum(tags1[t] != tags2[t] for t in tags1)
        if (r2.action != "dynamic" or r2.rendered != r1.rendered
                or r2.errors or not (r2.pushed_tenants and r2.pushed_acls)
                or len(posts) - n_posts != 2
                or retagged != CONFIG4_RETAGGED * CONFIG4_PER_NAMESPACE):
            raise SystemExit(
                "controller: sync 2 gave action %s, same text %s, errors "
                "%s, pushed %s/%s, %d posts, %d retagged"
                % (r2.action, r2.rendered == r1.rendered, r2.errors[:3],
                   r2.pushed_tenants, r2.pushed_acls, len(posts) - n_posts,
                   retagged))
        status, conf = http_json(port, "GET", "/configuration")
        if status != 200 or conf["tenants"] != 257:
            raise SystemExit("controller: /configuration after sync 2: %d %s"
                             % (status, conf))
        want2 = config4_keys(cr, reqs, tags2, sc._channels["acl"].payload)
        wave2 = request_wave(sock, reqs, [want2])
        # 5. sync 3: nothing changed, nothing posted
        n_posts = len(posts)
        r3 = sc.sync(*objects[2])
        if r3.action != "noop" or len(posts) != n_posts or r3.errors:
            raise SystemExit("controller: sync 3 gave action %s with %d "
                             "posts, errors %s"
                             % (r3.action, len(posts) - n_posts, r3.errors))
        metrics = srv.metrics()
        shapes1 = kernel_shapes(srv)
        launches1 = kernel_launches(metrics)
    finally:
        srv.__exit__(None, None, None)
    check_serve_metrics("controller (phase 16)", metrics)
    launches = {k: launches1.get(k, 0) - launches0.get(k, 0)
                for k in ("pair_scan", "step_scan")}
    if launches["pair_scan"] <= 0:
        raise SystemExit("controller: the pair kernel never launched: %s"
                         % launches)
    res.update(
        sync2={"action": r2.action, "retagged_ingresses": retagged,
               "rendered_unchanged": True},
        wave2={**wave2, "identical_verdicts": len(reqs),
               "changed_against_wave1": sum(a != b for a, b in
                                            zip(want1, want2))},
        sync3={"action": r3.action, "posts": 0},
        posts=len(posts), launches=launches,
        seconds=time.perf_counter() - t_phase)
    log("controller: sync 2 %s (%d Ingresses retagged, nginx.conf "
        "unchanged), wave 2 identical to the cpu pipeline under the new "
        "state (%d verdicts changed from wave 1), %.1f req/s; sync 3 %s with "
        "no POST; %d POSTs in all; launches %s; phase 16 %.1f s"
        % (r2.action, retagged, res["wave2"]["changed_against_wave1"],
           wave2["wire_req_per_s"], r3.action, len(posts), launches,
           res["seconds"]))
    return res, shape_delta(shapes0, shapes1)


# --------------------------------------------------------------- phase 17

#: leg B: config #1's corpus (``utils/export_corpus.py export``), its
#: frames in monitoring mode (wire mode 1: config #1 is
#: wallarm-mode=monitoring, and a frame's mode can only weaken a
#: server's), and loadgen's runs over it, in turns
FRONT_CORPUS = 10_000
FRONT_MODE = 1
FRONT_RUNS = ("sidecar", "direct", "direct", "sidecar")
FRONT_LOADGEN = (4, 8)
#: legs A and B: a deadline (sidecar) and a hard deadline (server) no
#: run reaches, and an upstream buffer above all the leg's bytes (9 MB
#: of streams and requests), so no fail-open can be timing's
FRONT_DEADLINE_MS = "60000"
FRONT_UPSTREAM_BUF = str(64 << 20)
#: leg A: chunked streams of phase 8's bodies (each of the six once,
#: the first two again), beside the response-leak frame
FRONT_STREAMS = 8
#: leg C: the rendered front door at its own deadline, leg B's first
#: frames at each (connections, in flight); the drain's limit
FRONT_LOADS = ((4, 8), (8, 32))
FRONT_C_REQUESTS = 4096
FRONT_DRAIN_S = 180.0
#: leg D: ``tests/test_shim.py``'s three rules and ACLs
SHIM_RULES = r"""
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
SecRule RESPONSE_BODY "@rx (?i)root:[^\s]{0,24}:0:0:" \
    "id:950100,phase:4,block,severity:CRITICAL,tag:'attack-disclosure'"
"""
SHIM_ACL = {"acls": {"edge": {"greylist": ["203.0.113.0/24"],
                              "deny": ["10.66.66.0/24"]}},
            "default": "edge"}
#: the selftest's cases and the verdict ``tests/test_shim.py`` wants of
#: each: (attack, blocked, fail_open), None where it does not say
SELFTEST_WANT = {"attack": (True, True, False), "benign": (False, False, None),
                 "stream": (True, True, None),
                 "ws_attack": (True, True, False), "ws_sticky": (True, None, None),
                 "dead_socket": (None, False, True)}
#: the sidecar's fail-open counters (its status page)
SIDECAR_FAIL_OPEN = ("fail_open_deadline", "fail_open_upstream",
                     "fail_open_overload")
TAIL_LINES = 40


class NativeChild:
    """A front-door binary (``build_native``'s sidecar) as a child
    process logging to a file; ready once its socket accepts a
    connection; stopped (terminate, then kill) on exit."""

    def __init__(self, name: str, argv: list, sock: str, status_port: int):
        self.name, self.argv, self.sock = name, list(argv), sock
        self.status_port = status_port

    def __enter__(self):
        self.tmp = tempfile.mkdtemp(prefix="ipt")
        self.log_path = os.path.join(self.tmp, "out.log")
        with open(self.log_path, "w") as logf:
            self.child = subprocess.Popen(self.argv, stdout=logf,
                                          stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                if self.child.poll() is not None:
                    raise SystemExit("%s exited with %d:\n%s"
                                     % (self.name, self.child.returncode,
                                        self.log()[-4000:]))
                try:
                    with socket.socket(socket.AF_UNIX) as s:
                        s.connect(self.sock)
                    break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 60:
                    raise SystemExit("%s: no socket at %s after 60 s"
                                     % (self.name, self.sock))
                time.sleep(0.05)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def log(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def status(self) -> dict:
        """The sidecar's counters (its ``--status-port`` page)."""
        code, body = http_get(self.status_port, "/")
        if code != 200:
            raise SystemExit("%s: status page answered %d" % (self.name, code))
        return json.loads(body)

    def __exit__(self, *exc):
        if self.child.poll() is None:
            self.child.terminate()
            try:
                self.child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.child.kill()
                self.child.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def sidecar_argv(binary, listen: str, upstream: str,
                 status_port: int) -> list:
    """Legs A, B, D's sidecar: ewma balancing, a deadline and an upstream
    buffer no run reaches."""
    return [str(binary), "--listen", listen, "--upstream", upstream,
            "--balance", "ewma", "--deadline-ms", FRONT_DEADLINE_MS,
            "--max-upstream-buf", FRONT_UPSTREAM_BUF,
            "--status-port", str(status_port)]


def status_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after
            if isinstance(after[k], int) and not isinstance(after[k], bool)}


def run_loadgen(binary, sock: str, corpus: str, n: int, connections: int,
                inflight: int, tails: dict) -> dict:
    """One loadgen run; its output is kept in ``tails`` for the failure
    report; a non-zero exit fails the run."""
    cmd = [str(binary), "--socket", sock, "--corpus", corpus,
           "--connections", str(connections), "--inflight", str(inflight),
           "--requests", str(n)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    tails["loadgen"] = lambda: "%s\n%s%s" % (" ".join(cmd), out.stdout,
                                             out.stderr)
    if out.returncode != 0:
        raise SystemExit("loadgen exited with %d: %s"
                         % (out.returncode, out.stderr[-2000:]))
    r = json.loads(out.stdout)
    r.update(connections=connections, inflight=inflight,
             p50_ms=r["p50_us"] / 1e3, p99_ms=r["p99_us"] / 1e3)
    return r


def front_invariants(run: dict, side: dict, reference: int,
                     degraded: int) -> list:
    """What holds of leg C's run at any host speed, however many
    requests the rendered 50 ms deadline fails open: ``run`` is loadgen's
    result, ``side`` the sidecar's counters moved over the run (drained:
    every late verdict arrived), ``reference`` the card library
    pipeline's attack count on the same frames, ``degraded`` the
    servers' degraded verdicts over the run.  A prefilter-only verdict
    (the brownout ladder's rung 1) can flag a request the confirm stage
    clears, never the reverse, so ``degraded`` bounds the attacks above
    the reference; a fail-open verdict can hide an attack.  Returns the
    broken invariants, each with its numbers (empty: all hold)."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    sent = side["requests_in"]
    need(run["requests"] == sent,
         "loadgen's answers %d != the sidecar's requests %d"
         % (run["requests"], sent))
    need(side["bad_frames"] == 0, "bad_frames %d" % side["bad_frames"])
    need(side["fail_open_upstream"] == 0,
         "fail_open_upstream %d" % side["fail_open_upstream"])
    failed = sum(side[k] for k in SIDECAR_FAIL_OPEN)
    need(side["responses"] + failed == sent,
         "responses %d + fail-open %d != requests_in %d"
         % (side["responses"], failed, sent))
    need(side["late_responses"] == side["fail_open_deadline"],
         "late_responses %d != fail_open_deadline %d (not drained)"
         % (side["late_responses"], side["fail_open_deadline"]))
    need(run["fail_open"] >= failed,
         "loadgen's fail-open %d < the sidecar's %d" % (run["fail_open"],
                                                         failed))
    need(run["attacks"] <= reference + degraded,
         "attacks %d > reference %d + degraded %d"
         % (run["attacks"], reference, degraded))
    need(run["attacks"] + run["fail_open"] >= reference,
         "attacks %d + fail_open %d < reference %d"
         % (run["attacks"], run["fail_open"], reference))
    need(run["blocked"] == 0, "blocked %d" % run["blocked"])
    return bad


@contextmanager
def front_leg(leg: str, tails: dict):
    """Leg ``leg`` of phase 17: a failure logs ``FAILED phase 17 leg X``
    with its check and the last lines of every child's log, then goes
    on up."""
    try:
        yield
    except BaseException as e:
        log("FAILED phase 17 leg %s: %s" % (leg, e))
        for name, text in tails.items():
            try:
                lines = text().splitlines()[-TAIL_LINES:]
            except OSError as err:
                lines = ["(log unreadable: %s)" % err]
            log("phase 17 leg %s: last %d lines of %s:\n%s"
                % (leg, len(lines), name, "\n".join(lines)))
        raise


def stream_wave(what: str, sock: str, cases, stream_keys, chunk: int,
                streams: int) -> dict:
    """Phase 8's bodies over the wire: each response-leak case as one
    response-scan frame, then ``streams`` chunked streams of the other
    cases, taken in turn (a streaming request frame and its chunks of
    ``chunk`` bytes), all at once; every verdict must equal its case's
    CPU key in ``stream_keys`` and none may fail open."""
    import dataclasses

    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.normalize import Response
    from ingress_plus_tpu_torch.serve.protocol import (
        MODE_STREAM,
        encode_chunk,
        encode_request,
        encode_response_scan,
    )

    leak = [c for c in cases if isinstance(c.meta, Response)]
    chunked = [c for c in cases if not isinstance(c.meta, Response)]
    units = []
    for c in leak:
        rid = 100000 + len(units)
        units.append((rid, [encode_response_scan(
            dataclasses.replace(c.meta, body=c.body), rid)], c))
    for k in range(streams):
        c = chunked[k % len(chunked)]
        rid = 100000 + len(units)
        frames = [encode_request(c.meta, rid, mode=2 | MODE_STREAM)]
        for off in range(0, len(c.body), chunk):
            frames.append(encode_chunk(rid, c.body[off:off + chunk],
                                       last=off + chunk >= len(c.body)))
        units.append((rid, frames, c))
    t = time.perf_counter()
    got = drive(sock, [u[:2] for u in units[:len(leak)]], 1, 1, timeout=300)
    got.update(drive(sock, [u[:2] for u in units[len(leak):]], streams, 1,
                     timeout=300))
    wall = time.perf_counter() - t
    ref = dict(zip((c.name for c in cases), stream_keys))
    for rid, _, c in units:
        resp = got[rid][0]
        if resp["fail_open"] or \
                wire_key(c.meta.request_id, resp) != ref[c.name]:
            raise SystemExit("%s: stream %s (req %d) differs from the cpu "
                             "reference: %s vs %s"
                             % (what, c.name, rid, resp, ref[c.name]))
    return {"streams": streams, "response_scans": len(leak), "wall_s": wall}


def corpus_requests(path: str) -> list:
    """The requests of an exported corpus file, decoded as a server
    decodes them."""
    from ingress_plus_tpu_torch.serve.protocol import (
        REQ_MAGIC,
        FrameReader,
        decode_request,
    )

    with open(path, "rb") as f:
        frames = FrameReader(REQ_MAGIC).feed(f.read())
    return [decode_request(p)[2] for p in frames]


def counter(srv, name: str) -> float:
    return sum(v for _, v in metric_values(srv.metrics(), name))


def harness_checks() -> list:
    """Every scenario ``native/shim/shim_harness.c`` checks, by name."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                       "shim", "shim_harness.c")
    with open(src) as f:
        return re.findall(r'CHECK\("([^"]+)"', f.read())


def phase_front_door(requests, want, cases, stream_keys, chunk: int,
                     smi: str, dev: torch.device, server_args=(),
                     corpus_n: int = FRONT_CORPUS,
                     c_requests: int = FRONT_C_REQUESTS) -> tuple:
    """Phase 17: the port's servers behind the repository's own front
    door (see the module docstring).  ``requests`` and ``want`` are
    phase 3's, ``cases`` and ``stream_keys`` phase 8's bodies and their
    CPU verdicts (streamed in ``chunk``-byte frames); ``server_args`` are
    added to every server's command (none on the card); ``dev`` runs
    leg B's reference pipeline.  Returns the result, the launches of
    the servers on the bundled pack by kernel and shape, and leg D's
    server's (its compiled three rules, its launches by shape)."""
    root = tempfile.mkdtemp(prefix="ipt17")
    try:
        return _phase_front_door(root, requests, want, cases, stream_keys,
                                 chunk, smi, dev, tuple(server_args),
                                 corpus_n, c_requests)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_front_door(root, requests, want, cases, stream_keys, chunk, smi,
                      dev, server_args, corpus_n, c_requests):
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir
    from ingress_plus_tpu_torch.control.deploy import write_static
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.cuda_build import build_native
    from ingress_plus_tpu_torch.utils.export_corpus import export
    from ingress_plus_tpu_torch.weights import load_pack

    t_phase = time.perf_counter()
    res = {"card": smi}
    t = time.perf_counter()
    bins = build_native()
    res["build_s"] = time.perf_counter() - t
    log("front door: built %s from native/ in %.1f s"
        % (", ".join(sorted(bins)), res["build_s"]))
    # the rendered pod: two serve containers and the sidecar
    write_static(os.path.join(root, "static"))
    with open(os.path.join(root, "static", "deployment.yaml")) as f:
        text = f.read()
    rendered = {n: rendered_container(text, n)
                for n in ("serve-0", "serve-1", "detect-sidecar")}
    pin = PINNED_IMPL if dev.type == "cuda" else ("--scan-impl", "pair")
    held = ("--hard-deadline-ms", FRONT_DEADLINE_MS) + pin
    rules = os.path.join(root, "shim-rules")
    os.makedirs(rules)
    with open(os.path.join(rules, "tiny.conf"), "w") as f:
        f.write(SHIM_RULES)
    shim_cr = compile_ruleset(load_seclang_dir(rules))
    servers = {"A": ServeChild(*server_args, *held),
               "B": ServeChild(*server_args, "--mode", "monitoring", *held),
               "D": ServeChild(*server_args, "--rules-dir", rules, *held)}
    c_changes = {}
    for k, name in enumerate(("serve-0", "serve-1")):
        port = free_port()
        argv, sock, changes = served_command(
            rendered[name]["command"], root, port, name)
        argv += list(server_args + pin)
        c_changes[name] = changes + ["%s added" % a
                                     for a in server_args + pin]
        servers["C%d" % k] = ServeChild(
            argv=argv, env=dict(os.environ, **rendered[name]["env"]),
            sock=sock, port=port)
    # a server started without warmup (a CPU rehearsal) loads each shape
    # at its first batch
    zero = tuple(n for n in SERVE_ZERO if "--no-warmup" not in server_args
                 or n != "ipt_engine_recompiles_total")

    def healthy(k):
        """Server ``k``'s health counters at 0 after its leg (not C's
        servers: their rendered deadline fails requests open)."""
        check_serve_metrics("front door (phase 17) server %s" % k,
                            servers[k].metrics(), zero)

    tails = {}
    for k, srv in servers.items():
        srv.start()
        tails["server " + k] = srv.log
    try:
        # host work while the servers start: the corpus, its decoded
        # requests, the wire references
        corpus = os.path.join(root, "config1.bin")
        export(corpus, n=corpus_n, seed=SEED, mode=FRONT_MODE)
        decoded = corpus_requests(corpus)
        wants, rerouted = wire_wants(requests, want)
        for srv in servers.values():
            srv.ready()
        res["startup_s"] = {k: srv.startup_s for k, srv in servers.items()}
        shapes0 = {k: kernel_shapes(srv) for k, srv in servers.items()}
        with front_leg("A", tails):
            res["A"] = front_leg_a(servers["A"], bins, root, requests, wants,
                                   rerouted, cases, stream_keys, chunk,
                                   tails)
            healthy("A")
        with front_leg("B", tails):
            t = time.perf_counter()
            ref_pl = DetectionPipeline(load_pack(), mode="monitoring",
                                       device=dev)
            ref = run_pipeline(ref_pl, decoded)
            if any(v.fail_open for v in ref):
                raise SystemExit("the reference pipeline failed open")
            flags = np.cumsum([bool(v.attack) for v in ref])
            res["reference_s"] = time.perf_counter() - t
            res["B"] = front_leg_b(servers["B"], bins, root, corpus,
                                   int(flags[-1]), corpus_n, tails)
            healthy("B")
        with front_leg("C", tails):
            res["C"] = front_leg_c(servers["C0"], servers["C1"], bins, root,
                                   rendered["detect-sidecar"]["command"],
                                   c_changes, corpus,
                                   min(c_requests, corpus_n),
                                   int(flags[min(c_requests, corpus_n) - 1]),
                                   tails)
        with front_leg("D", tails):
            res["D"] = front_leg_d(servers["D"], bins, root, tails)
            healthy("D")
        shapes1 = {k: kernel_shapes(srv) for k, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.__exit__(None, None, None)
    deltas = {k: shape_delta(shapes0[k], shapes1[k]) for k in shapes0}
    launches = {k: {n: sum(s["launches"] for s in d[n]) for n in d}
                for k, d in deltas.items()}
    res["launches"] = launches
    # a CPU rehearsal launches no kernel; on the card every server's
    # batches and leg A's streams must have gone through them
    idle = [k for k in launches if launches[k]["pair_scan"] <= 0]
    if launches["A"]["step_scan"] <= 0:
        idle.append("A step_scan")
    if dev.type == "cuda" and idle:
        raise SystemExit("front door: kernels of the path never launched on "
                         "%s: %s" % (idle, launches))
    res["seconds"] = time.perf_counter() - t_phase
    log("front door: phase 17 %.1f s; launches by server %s"
        % (res["seconds"], launches))
    return (res, merge_shapes(*(deltas[k] for k in ("A", "B", "C0", "C1"))),
            (shim_cr, deltas["D"]))


def front_leg_a(srv, bins, root, requests, wants, rerouted, cases,
                stream_keys, chunk, tails) -> dict:
    """Leg A: verdict identity through the sidecar."""
    from ingress_plus_tpu_torch.utils.uds import socket_path

    listen = socket_path(root, "a-side.sock")
    port = free_port()
    argv = sidecar_argv(bins["sidecar"], listen, srv.sock, port)
    with NativeChild("sidecar A", argv, listen, port) as side:
        tails["sidecar A"] = side.log
        st0 = side.status()
        wave = request_wave(listen, requests, [wants])
        streamed = stream_wave("front door A", listen, cases, stream_keys,
                               chunk, FRONT_STREAMS)
        st = status_delta(st0, side.status())
        status = side.status()
    bad = [k for k in SIDECAR_FAIL_OPEN + ("bad_frames", "late_responses")
           if st[k]]
    want_in = len(requests) + FRONT_STREAMS + streamed["response_scans"]
    if bad or st["responses"] != st["requests_in"] or \
            st["requests_in"] != want_in:
        raise SystemExit("sidecar A counters: %s moved; responses %d, "
                         "requests_in %d, want %d"
                         % (bad, st["responses"], st["requests_in"], want_in))
    log("front door A: %d requests through the sidecar (ewma, %s ms "
        "deadline) identical to the cpu reference (%d rerouted), %.1f req/s, "
        "p50 %.2f ms p99 %.2f ms; %d chunked streams and %d response-scan "
        "frame(s) identical in %.1f s; sidecar counters %s"
        % (len(requests), FRONT_DEADLINE_MS, len(rerouted),
           wave["wire_req_per_s"], wave["p50_ms"], wave["p99_ms"],
           FRONT_STREAMS, streamed["response_scans"], streamed["wall_s"], st))
    return {"argv": argv, "wave": wave, "identical_verdicts": len(requests),
            "streams": FRONT_STREAMS,
            "response_scans": streamed["response_scans"],
            "stream_s": streamed["wall_s"], "sidecar": st,
            "upstreams": status["upstreams"]}


def front_leg_b(srv, bins, root, corpus, reference, n, tails) -> dict:
    """Leg B: config #1, loadgen through the sidecar and straight at the
    server, in turns."""
    from ingress_plus_tpu_torch.utils.uds import socket_path

    listen = socket_path(root, "b-side.sock")
    port = free_port()
    argv = sidecar_argv(bins["sidecar"], listen, srv.sock, port)
    runs = []
    with NativeChild("sidecar B", argv, listen, port) as side:
        tails["sidecar B"] = side.log
        st0 = side.status()
        for via in FRONT_RUNS:
            r = run_loadgen(bins["loadgen"],
                            listen if via == "sidecar" else srv.sock, corpus,
                            n, *FRONT_LOADGEN, tails)
            r["via"] = via
            runs.append(r)
            if (r["requests"], r["fail_open"], r["blocked"],
                    r["attacks"]) != (n, 0, 0, reference):
                raise SystemExit(
                    "config #1 %s run %d: requests %d fail_open %d blocked %d "
                    "attacks %d, want %d, 0, 0, %d (the card library "
                    "pipeline's)" % (via, len(runs), r["requests"],
                                     r["fail_open"], r["blocked"],
                                     r["attacks"], n, reference))
        st = status_delta(st0, side.status())
    if any(st[k] for k in SIDECAR_FAIL_OPEN + ("bad_frames",)) or \
            st["responses"] != st["requests_in"]:
        raise SystemExit("sidecar B counters: %s" % st)

    def mean(via):
        return statistics.mean(r["rps"] for r in runs if r["via"] == via)

    ratio = mean("sidecar") / mean("direct")
    for r in runs:
        log("front door B: config #1 %s, %d x %d: %d requests, %.1f req/s, "
            "p50 %.2f p90 %.2f p99 %.2f p999 %.2f ms; attacks %d = the "
            "library pipeline's, blocked 0, fail-open 0"
            % (r["via"], r["connections"], r["inflight"], r["requests"],
               r["rps"], r["p50_us"] / 1e3, r["p90_us"] / 1e3,
               r["p99_us"] / 1e3, r["p999_us"] / 1e3, r["attacks"]))
    log("front door B: the sidecar hop's req/s over direct: %.3f" % ratio)
    return {"argv": argv, "requests": n, "reference_attacks": reference,
            "runs": runs, "hop_req_per_s_ratio": ratio, "sidecar": st}


def front_leg_c(s0, s1, bins, root, rendered, changes, corpus, n,
                reference, tails) -> dict:
    """Leg C: the rendered front door at its own deadline; measured,
    gated only on ``front_invariants``."""
    from ingress_plus_tpu_torch.utils.uds import socket_path

    argv = list(rendered)
    side_changes = ["%s -> %s" % (argv[0], bins["sidecar"])]
    argv[0] = str(bins["sidecar"])
    listen = socket_path(root, "detect.sock")
    port = free_port()
    for flag, value in (("--listen", listen),
                        ("--upstream", "%s,%s" % (s0.sock, s1.sock)),
                        ("--status-port", str(port))):
        k = argv.index(flag)
        side_changes.append("%s %s -> %s" % (flag, argv[k + 1], value))
        argv[k + 1] = value
    deadline = argv[argv.index("--deadline-ms") + 1]
    log("front door C: rendered detect-sidecar %s; run with these changes: "
        "%s; serve-0 and serve-1 with theirs: %s"
        % (" ".join(rendered), "; ".join(side_changes), changes))
    loads = []
    with NativeChild("sidecar C", argv, listen, port) as side:
        tails["sidecar C"] = side.log
        for conns, inflight in FRONT_LOADS:
            st0 = side.status()
            srv0 = [(counter(s, "ipt_fail_open_total"),
                     counter(s, "ipt_degraded_verdicts_total"))
                    for s in (s0, s1)]
            r = run_loadgen(bins["loadgen"], listen, corpus, n, conns,
                            inflight, tails)
            t = time.perf_counter()
            while True:     # drained: every late verdict has come back
                st = status_delta(st0, side.status())
                if st["late_responses"] >= st["fail_open_deadline"] or \
                        time.perf_counter() - t > FRONT_DRAIN_S:
                    break
                time.sleep(0.1)
            drain_s = time.perf_counter() - t
            srv1 = [(counter(s, "ipt_fail_open_total"),
                     counter(s, "ipt_degraded_verdicts_total"))
                    for s in (s0, s1)]
            server_fail_open = sum(b[0] - a[0] for a, b in zip(srv0, srv1))
            degraded = sum(b[1] - a[1] for a, b in zip(srv0, srv1))
            row = {**r, "reference_attacks": reference,
                   "fail_open_share": r["fail_open"] / r["requests"],
                   "sidecar": st, "server_fail_open": server_fail_open,
                   "server_degraded": degraded, "drain_s": drain_s,
                   "forwarded": [u["forwarded"]
                                 for u in side.status()["upstreams"]]}
            loads.append(row)
            log("front door C: %d x %d at the rendered %s ms deadline: %d "
                "requests, %.1f req/s, p50 %.2f ms p99 %.2f ms, fail-open "
                "%d (%.1f%%), attacks %d of the reference %d, blocked %d; "
                "sidecar %s; the servers' fail-open %d, degraded %d; drained "
                "in %.2f s" % (conns, inflight, deadline, r["requests"],
                               r["rps"], r["p50_ms"], r["p99_ms"],
                               r["fail_open"], 100 * row["fail_open_share"],
                               r["attacks"], reference, r["blocked"], st,
                               server_fail_open, degraded, drain_s))
            bad = front_invariants(r, st, reference, int(degraded))
            if bad:
                raise SystemExit("%d x %d: %s" % (conns, inflight,
                                                  "; ".join(bad)))
    return {"rendered": rendered, "changes": side_changes,
            "serve_changes": changes, "deadline_ms": float(deadline),
            "requests": n, "loads": loads}


def front_leg_d(srv, bins, root, tails) -> dict:
    """Leg D: the nginx module's harness straight at a server on three
    rules, and the module's client through a sidecar."""
    from ingress_plus_tpu_torch.utils.uds import socket_path

    status, acl = http_json(srv.port, "POST", "/configuration/acl", SHIM_ACL)
    if status != 200 or acl.get("acls") != ["edge"]:
        raise SystemExit("shim: ACL push answered %d %s" % (status, acl))
    out = subprocess.run([str(bins["shim_harness"]), srv.sock],
                         capture_output=True, text=True, timeout=300)
    tails["shim_harness"] = lambda: out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln]
    ok = [ln[3:] for ln in lines if ln.startswith("ok ")]
    checks = harness_checks()
    failed = [ln for ln in lines if ln.startswith("FAIL")]
    if out.returncode != 0 or lines[-1:] != ["HARNESS-OK"] or failed or \
            sorted(ok) != sorted(checks):
        raise SystemExit("shim_harness: rc %d, last %s, failed %s, ok %d of "
                         "%d checks (missing %s)"
                         % (out.returncode, lines[-1:], failed, len(ok),
                            len(checks), sorted(set(checks) - set(ok))))
    ws = [c for c in ok if c.startswith("ws_")]
    listen = socket_path(root, "d-side.sock")
    port = free_port()
    argv = sidecar_argv(bins["sidecar"], listen, srv.sock, port)
    with NativeChild("sidecar D", argv, listen, port) as side:
        tails["sidecar D"] = side.log
        dead = socket_path(root, "dead.sock")
        sel = subprocess.run([str(bins["shim_selftest"]), listen, dead],
                             capture_output=True, text=True, timeout=300)
        tails["shim_selftest"] = lambda: sel.stdout + sel.stderr
        st = side.status()
    cases = {json.loads(ln)["case"]: json.loads(ln)
             for ln in sel.stdout.splitlines() if ln}
    wrong = {}
    for case, wants in SELFTEST_WANT.items():
        got = cases.get(case, {})
        for key, w in zip(("attack", "blocked", "fail_open"), wants):
            if w is not None and got.get(key) != w:
                wrong[case] = got
    if sel.returncode != 0 or wrong or sorted(cases) != sorted(SELFTEST_WANT) \
            or cases["attack"]["n_rules"] < 1:
        raise SystemExit("shim_selftest: rc %d, cases %s, wrong %s"
                         % (sel.returncode, sorted(cases), wrong))
    if st["bad_frames"] or any(st[k] for k in SIDECAR_FAIL_OPEN):
        raise SystemExit("sidecar D counters: %s" % st)
    log("front door D: shim_harness %d of %d checks ok (%d websocket), "
        "HARNESS-OK; shim_selftest %s as tests/test_shim.py wants"
        % (len(ok), len(checks), len(ws), sorted(cases)))
    return {"harness_ok": len(ok), "harness_checks": len(checks),
            "ws_scenarios": ws, "selftest": cases, "sidecar": st}


#: phase 18's child: its rootdir conftest.  It leaves out the
#: ``CARD_EXCLUDE`` cases, and writes per file the cases collected (the
#: CPU leg's), left out, passed and failed, the pair and step kernel
#: launches of its cases and fixtures, and their seconds
_CARD_FILES_PLUGIN = """
import json
import time

import pytest

from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN

EXCLUDE = %(exclude)r
files = {}


def _name(nodeid):
    return nodeid.split("::")[0][len("card_"):-len(".py")]


def _file(nodeid):
    return files.setdefault(_name(nodeid), {
        "collected": 0, "excluded": 0, "passed": 0, "failed": 0,
        "pair": 0, "step": 0, "seconds": 0.0})


def pytest_collection_modifyitems(config, items):
    drop = []
    for item in items:
        f = _file(item.nodeid)
        f["collected"] += 1
        if item.originalname in EXCLUDE.get(_name(item.nodeid), ()):
            f["excluded"] += 1
            drop.append(item)
    config.hook.pytest_deselected(items=drop)
    items[:] = [i for i in items if i not in drop]


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    f = _file(item.nodeid)
    pair, step, t = PAIR_SCAN.launches, STEP_SCAN.launches, time.perf_counter()
    yield
    f["pair"] += PAIR_SCAN.launches - pair
    f["step"] += STEP_SCAN.launches - step
    f["seconds"] += time.perf_counter() - t


def pytest_runtest_logreport(report):
    f = _file(report.nodeid)
    if report.failed:
        f["failed"] += 1
    elif report.when == "call" and report.passed:
        f["passed"] += 1


def pytest_sessionfinish(session, exitstatus):
    with open(%(out)r, "w") as fh:
        json.dump(files, fh)
"""


def phase_card_files(smi: str, device: str = "cuda",
                     files=CARD_FILES) -> dict:
    """Phase 18 (the module docstring): ``files``, the JAX package's own
    test files, through ``ported(..., device=device)`` in one pytest
    child.  Raises SystemExit unless every file passed all its cases but
    the card's exclusions and, on ``cuda``, launched a scan kernel."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ipt-card-files-") as d:
        out = os.path.join(d, "files.json")
        for name in files:
            with open(os.path.join(d, "card_%s.py" % name), "w") as fh:
                fh.write("from torch_ported_tests import ported\n\n"
                         "globals().update(ported(%r, exclude={}, "
                         "device=%r))\n" % (name, device))
        with open(os.path.join(d, "conftest.py"), "w") as fh:
            fh.write(_CARD_FILES_PLUGIN % {
                "exclude": {n: sorted(CARD_EXCLUDE.get(n, ()))
                            for n in files}, "out": out})
        with open(os.path.join(d, "pytest.ini"), "w") as fh:
            fh.write("[pytest]\n")
        path = [os.path.join(here, "tests"), here]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            path + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        try:
            child = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p",
                 "no:cacheprovider", "-p", "no:randomly", "-c",
                 os.path.join(d, "pytest.ini"), "--rootdir", d]
                + [os.path.join(d, "card_%s.py" % n) for n in files],
                cwd=d, env=env, capture_output=True, text=True,
                timeout=CARD_FILES_LIMIT_S)
        except subprocess.TimeoutExpired as e:
            raise SystemExit("phase 18: the pytest child ran past %d s:\n%s"
                             % (CARD_FILES_LIMIT_S, (e.stdout or "")[-4000:]))
        tail = "\n".join((child.stdout + child.stderr).splitlines()[-60:])
        if child.returncode != 0 or not os.path.exists(out):
            raise SystemExit("phase 18: the pytest child exited %d:\n%s"
                             % (child.returncode, tail))
        with open(out) as fh:
            got = json.load(fh)
    bad = []
    for name in files:
        f = got.get(name)
        if f is None:
            bad.append("%s: no case ran" % name)
            continue
        if f["failed"] or f["passed"] != f["collected"] - f["excluded"]:
            bad.append("%s: %d passed, %d failed of %d cases less %d left "
                       "out" % (name, f["passed"], f["failed"],
                                f["collected"], f["excluded"]))
        if device == "cuda" and not (f["pair"] or f["step"]):
            bad.append("%s: no pair or step kernel launch" % name)
    if bad:
        raise SystemExit("phase 18: %s\n%s" % ("; ".join(bad), tail))
    res = {"card": smi, "device": device,
           "seconds": time.perf_counter() - t0,
           "passed": sum(got[n]["passed"] for n in files),
           "files": {n: got[n] for n in files}}
    log("phase 18: %d cases of %d JAX test files passed on %s in %.1f s"
        % (res["passed"], len(files), device, res["seconds"]))
    return res


# ------------------------------------------------ phase 19: the sanitizers

#: phase 19: the case plan's (B, L): the main path's (phases 2 and 4), a
#: partial last block unsplit (phase 2's edge shape: 1001 rows of an odd
#: L) and split (3 rows of 15 segments: 45 units); each on both packs
SANITIZE_SHAPES = ((SCAN_B, 64), (SCAN_B, 2048), (SCAN_B, 16384),
                   (SPLIT_B, 2048), (SPLIT_B, 16384), (1001, 333), (3, 1900))
#: the shapes also run without a carried state and match, as the batch
#: path launches
SANITIZE_UNCARRIED = ((SCAN_B, 2048), (1001, 333))
SANITIZE_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
#: compute-sanitizer checks only these kernels (substrings of their
#: mangled names); torch's own run unchecked
SANITIZE_KERNELS = ("pair_scan_kernel", "step_scan_kernel")
#: the tools under which each tensor is an allocation of its own, so a
#: read past one is a read past an allocation
SANITIZE_OWN_ALLOCATIONS = ("memcheck", "initcheck")
SANITIZE_EXIT = 86
SANITIZE_LIMIT_S = 600
#: what compute-sanitizer prints when it cannot instrument the card (a
#: card host whose kernel does not pass the debugger interface through)
SANITIZE_REFUSED = "Error: Device not supported"
_SUMMARY = re.compile(r"^=+ (?:ERROR SUMMARY: (\d+) errors?|RACECHECK "
                      r"SUMMARY: (\d+) hazards? displayed)", re.M)
_CHILD_LINE = re.compile(r"^sanitize-child (\{.*\})\s*$", re.M)
#: the sidecar leg: ``tests/test_sanitizers.py``'s three rules and flow
#: (100 frames, seed 11, 30% attacks; 200 requests over 4 connections x 8
#: in flight; a 60 s deadline)
SANITIZE_RULES = r"""
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY|REQUEST_HEADERS "@rx /etc/passwd" \
    "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
"""
SANITIZE_REQUESTS = 200
#: the text of a report of ASan, UBSan or TSan
SANITIZER_REPORTS = ("ERROR: AddressSanitizer", "runtime error:",
                     "WARNING: ThreadSanitizer")


def sanitize_plan(W: int) -> list:
    """Phase 19's cases over a pack of ``W`` words, each a dict: ``B``,
    ``L``, ``carried`` (a state and a sticky match given), ``G`` and
    ``segments`` (``plan_segments``), ``segments_run`` (the launches' forced
    segment lengths: None for the plan's, and ``L`` too where the plan
    splits), ``units`` (B x segments), ``partial_block`` (the last block of
    8 units has units past the rows) and ``lanes_past_w`` (the last word
    tile's lanes past W).  Every case runs the raw-byte and class-id pair
    launches and the step launch."""
    from ingress_plus_tpu_torch.ops.segments import (
        UNITS_PER_BLOCK,
        WORD_TILE,
        plan_segments,
    )

    cases = []
    for B, L in SANITIZE_SHAPES:
        plan = plan_segments(B, L, W)
        split = plan.segments > 1
        for carried in (True, False) if (B, L) in SANITIZE_UNCARRIED \
                else (True,):
            cases.append({
                "B": B, "L": L, "carried": carried, "G": plan.G,
                "segments": plan.segments,
                "segments_run": [None, L] if split else [None],
                "units": B * plan.segments,
                "partial_block": B * plan.segments % UNITS_PER_BLOCK != 0,
                "lanes_past_w": W % WORD_TILE != 0})
    return cases


def sanitize_lengths(B: int, L: int, G: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Seeded lengths in [0, L], a third of them odd, led by the edges:
    for an unsplit launch 0, 1, 3, L-1, L and L+1 (one above L, which the
    kernels clamp); for a split one L+1, G-1, 2G+33, 0, 1, G+1, L-1, L
    (segment boundaries first), as many as there are rows."""
    n = rng.integers(0, L + 1, B).astype(np.int32)
    n[::3] = np.minimum(n[::3] | 1, L)
    edges = ([0, 1, 3, L - 1, L, L + 1] if G >= L else
             [L + 1, G - 1, 2 * G + 33, 0, 1, G + 1, L - 1, L])
    k = min(B, len(edges))
    n[:k] = edges[:k]
    return n


def sanitize_inputs(case: dict, W: int, rng: np.random.Generator) -> tuple:
    """A case's (tokens, lengths, match, state) as numpy arrays: seeded
    bytes of every value with attack substrings spliced in, the lengths of
    :func:`sanitize_lengths`, and a sparse sticky match and a carried state
    (None, None when the case carries none)."""
    B, L = case["B"], case["L"]
    toks = rng.integers(0, 256, (B, L), dtype=np.uint8)
    for i in range(B):
        a = ATTACKS[i % len(ATTACKS)]
        if len(a) < L:
            at = int(rng.integers(0, L - len(a)))
            toks[i, at:at + len(a)] = np.frombuffer(a, np.uint8)
    lens = sanitize_lengths(B, L, case["G"], rng)
    match, state = carried(B, W, rng) if case["carried"] else (None, None)
    return toks, lens, match, state


def sanitize_child(checked: bool) -> int:
    """``chip_smoke.py --sanitize-child [--checked]``: every case of
    :func:`sanitize_plan` on the bundled pack and on the 2x pack, each
    launched through ``ByteScanner``'s, ``PairScanner``'s and
    ``StepScanner``'s tables on the card (the shipping kernels, or with
    ``checked`` the ``-DSCAN_CHECK`` builds); after each case's launches,
    every launch held bit-identical to its plain version.  Prints one
    ``sanitize-child {...}`` line; exits 0 when every launch agreed (and,
    checked, no check failed)."""
    from ingress_plus_tpu_torch.compiler import compile_ruleset
    from ingress_plus_tpu_torch.compiler.packgen import scale_rules
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.ops.cuda_build import CHECK_FLAGS, ScanKernel
    from ingress_plus_tpu_torch.ops.pair_scan import (
        PAIR_SCAN,
        ByteScanner,
        PairScanner,
    )
    from ingress_plus_tpu_torch.ops.pair_scan import _plain as pair_plain
    from ingress_plus_tpu_torch.ops.scan import (
        ScanTables,
        classes_for,
        from_numpy_u32,
        scan_bytes,
    )
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner
    from ingress_plus_tpu_torch.weights import load_pack

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    if checked:
        pair_k = ScanKernel("pair_scan", True, CHECK_FLAGS)
        step_k = ScanKernel("step_scan", False, CHECK_FLAGS)
    else:
        pair_k, step_k = PAIR_SCAN, STEP_SCAN
    packs = {"bundled": load_pack(),
             "2x": compile_ruleset(scale_rules(load_bundled_rules(),
                                               SCALE_FACTOR))}
    rng = np.random.default_rng(SEED + 19)
    res = {"checked": checked, "packs": {}, "cases": 0, "launches": 0,
           "disagree": []}
    for pack, cr in packs.items():
        tables = ScanTables.from_bitap(cr.tables, dev)
        W = tables.n_words
        byte = forced(pair_k, ByteScanner(tables))
        step = forced(step_k, StepScanner(tables))
        cid = PairScanner(tables)
        plan = sanitize_plan(W)
        res["packs"][pack] = {"W": W, "K1": tables.class_table.shape[0],
                              "cases": len(plan)}
        for case in plan:
            toks_np, len_np, match_np, state_np = sanitize_inputs(case, W,
                                                                  rng)
            toks = torch.from_numpy(toks_np).to(dev)
            lens = torch.from_numpy(len_np).to(dev)
            match = state = None
            if case["carried"]:
                match = from_numpy_u32(match_np, dev)
                state = from_numpy_u32(state_np, dev)
            cls = classes_for(tables.byte_class, toks, lens).to(
                torch.int32).contiguous()
            got = []
            for seg in case["segments_run"]:
                got += [
                    ("raw_byte", seg, byte(toks, lens, state, match, seg)),
                    ("class_id", seg, pair_k(
                        cls, lens, cid.class_tiles, tables.init_mask,
                        tables.final_mask, state=state, match=match,
                        segment=seg)),
                    ("step", seg, step(toks, lens, state, match, seg))]
            torch.cuda.synchronize()
            pair_ref = pair_plain(tables, toks, lens, state, match)
            step_ref = scan_bytes(tables, toks, lens, state, match)
            for cfg, seg, (m, s) in got:
                m_ref, s_ref = step_ref if cfg == "step" else pair_ref
                if not (torch.equal(m, m_ref) and torch.equal(s, s_ref)):
                    res["disagree"].append(
                        "%s %s B=%d L=%d carried=%s segment=%s: match diff "
                        "words=%d state diff words=%d"
                        % (pack, cfg, case["B"], case["L"], case["carried"],
                           seg, int((m != m_ref).sum()),
                           int((s != s_ref).sum())))
            res["cases"] += 1
            res["launches"] += len(got)
    res["kernel_launches"] = {"pair_scan": pair_k.launches,
                              "step_scan": step_k.launches}
    if checked:
        res["check_failures"] = {k.name: k.check_errors()
                                 for k in (pair_k, step_k)}
    res["identical"] = not res["disagree"]
    ok = res["identical"] and not any(
        f["total"] for f in res.get("check_failures", {}).values())
    res["seconds"] = time.perf_counter() - t0
    print("sanitize-child " + json.dumps(res), flush=True)
    return 0 if ok else 1


def sanitizer_argv(tool_path: str, tool: str) -> list:
    """compute-sanitizer running ``tool`` over the sanitize child: an
    exit code of its own on any report, only the scan kernels checked."""
    argv = [tool_path, "--tool", tool, "--error-exitcode",
            str(SANITIZE_EXIT), "--print-limit", "100"]
    for name in SANITIZE_KERNELS:
        argv += ["--kernel-name", "kns=" + name]
    here = os.path.dirname(os.path.abspath(__file__))
    return argv + [sys.executable, os.path.join(here, "chip_smoke.py"),
                   "--sanitize-child"]


def sanitizer_outcome(rc: int, text: str) -> dict:
    """One compute-sanitizer child's verdict from its exit code and
    output: ``clean`` when it exited 0, printed its summary line with 0
    errors (racecheck: 0 hazards) and its child's bit-identity held;
    ``refused`` when the tool said it cannot instrument the card
    (:data:`SANITIZE_REFUSED`: nothing was checked); ``failed``
    otherwise, a missing summary line included."""
    child = _CHILD_LINE.findall(text)
    child = json.loads(child[-1]) if child else None
    sums = _SUMMARY.findall(text)
    reports = int(next(n for n in sums[-1] if n)) if sums else None
    out = {"rc": rc, "reports": reports, "child": child}
    if SANITIZE_REFUSED in text:
        return dict(out, status="refused", why=SANITIZE_REFUSED)
    why = ("no summary line" if reports is None
           else "%d reports" % reports if reports
           else "exit code %d" % rc if rc != 0
           else "no sanitize-child line" if child is None
           else "launches disagree with their plain versions"
           if not child["identical"] else None)
    return dict(out, status="failed" if why else "clean", why=why)


_SASS_CODE = re.compile(r"^(?:Function : |/\*[0-9a-f]{4,}\*/)")


def sass_code(text: str) -> list:
    """The function names and instruction lines of a ``cuobjdump -sass``
    dump (its header names the source file only under ``-lineinfo``)."""
    return [ln.strip() for ln in text.splitlines()
            if _SASS_CODE.match(ln.strip())]


def sass_lineinfo_equal(pairs: dict) -> dict:
    """For each kernel, ``cuobjdump -sass`` of its library built with
    ``-lineinfo`` (the shipping flags) and without: the same functions
    and instructions (:func:`sass_code`) or not, and how many
    instructions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, (with_li, without_li) in pairs.items():
        lines = [sass_code(subprocess.run(
            [tool, "-sass", str(p)], capture_output=True, text=True,
            check=True, timeout=120).stdout) for p in (with_li, without_li)]
        diff = next((i for i, (a, b) in enumerate(zip(*lines)) if a != b),
                    None)
        if diff is None and len(lines[0]) != len(lines[1]):
            diff = min(len(lines[0]), len(lines[1]))
        out[name] = {"equal": diff is None,
                     "instructions": sum(ln.startswith("/*") for ln in
                                         lines[0]),
                     "first_difference": None if diff is None else
                     [ln[diff] if diff < len(ln) else None for ln in lines]}
    return out


def sanitized_front_door(binaries: dict, server_args=()) -> dict:
    """The ASan+UBSan sidecar (with the ASan loadgen), then the TSan
    sidecar (with the plain loadgen), each in front of one server on
    :data:`SANITIZE_RULES`, given :data:`SANITIZE_REQUESTS` requests of
    ``tests/test_sanitizers.py``'s corpus: every request answered, attacks
    among them, the sidecar stopped by SIGTERM with exit 0 or -15, and no
    sanitizer report from the sidecar or loadgen."""
    from ingress_plus_tpu_torch.utils.export_corpus import export
    from ingress_plus_tpu_torch.utils.uds import socket_path

    res = {}
    with tempfile.TemporaryDirectory(prefix="ipt-san-") as d:
        rules = os.path.join(d, "rules")
        os.mkdir(rules)
        with open(os.path.join(rules, "tiny.conf"), "w") as f:
            f.write(SANITIZE_RULES)
        corpus = os.path.join(d, "c.bin")
        export(corpus, n=100, seed=11, attack_fraction=0.3)
        with ServeChild("--rules-dir", rules, "--no-warmup",
                        *server_args) as srv:
            for leg, side_bin, gen_bin in (
                    ("asan", "sidecar_asan", "loadgen_asan"),
                    ("tsan", "sidecar_tsan", "loadgen")):
                sock = socket_path(d, "side_%s.sock" % leg)
                tails = {}
                side = NativeChild(side_bin, [
                    str(binaries[side_bin]), "--listen", sock, "--upstream",
                    srv.sock, "--deadline-ms", FRONT_DEADLINE_MS], sock, 0)
                with side:
                    run = run_loadgen(binaries[gen_bin], sock, corpus,
                                      SANITIZE_REQUESTS, 4, 8, tails)
                    side.child.terminate()
                    rc = side.child.wait(timeout=30)
                    side_log = side.log()
                found = [r for r in SANITIZER_REPORTS
                         if r in side_log or r in tails["loadgen"]()]
                bad = ([] if run["requests"] == SANITIZE_REQUESTS
                       else ["%d of %d requests answered"
                             % (run["requests"], SANITIZE_REQUESTS)])
                bad += [] if run["attacks"] > 0 else ["no attack found"]
                bad += [] if rc in (0, -15) else ["sidecar exit code %d" % rc]
                bad += ["report: %s" % r for r in found]
                if bad:
                    raise SystemExit(
                        "phase 19 %s sidecar: %s\n--- sidecar\n%s\n--- "
                        "loadgen\n%s" % (leg, "; ".join(bad),
                                         side_log[-4000:],
                                         tails["loadgen"]()[-4000:]))
                res[leg] = {"sidecar": side_bin, "loadgen": gen_bin,
                            "requests": run["requests"],
                            "attacks": run["attacks"],
                            "fail_open": run["fail_open"], "sidecar_rc": rc,
                            "reports": 0}
                log("phase 19 %s: %s + %s in front of %s: %d requests, %d "
                    "attacks, sidecar exit %d, no sanitizer report"
                    % (leg, side_bin, gen_bin, " ".join(server_args)
                       or "a card server", run["requests"], run["attacks"],
                       rc))
    return res


def logged_run(argv: list, env: dict, path: str, limit: float) -> tuple:
    """Run ``argv`` from the repository root with its output in ``path``:
    (exit code, or None when it ran past ``limit`` seconds and was
    killed; its seconds)."""
    t = time.perf_counter()
    with open(path, "w") as f:
        try:
            rc = subprocess.run(argv, stdout=f, stderr=subprocess.STDOUT,
                                env=env, timeout=limit,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__))).returncode
        except subprocess.TimeoutExpired:
            rc = None
    return rc, time.perf_counter() - t


def phase_sanitizers(binaries: dict, sass_pairs: dict, smi: str,
                     server_args=()) -> dict:
    """Phase 19 (the module docstring): compute-sanitizer's four tools
    over the sanitize child and the checked build's child, all at once,
    and the sanitized sidecars in front of a card server meanwhile; then
    the ``-lineinfo`` SASS comparison.  Raises SystemExit on any
    failure."""
    from ingress_plus_tpu_torch.ops.cuda_build import find_compute_sanitizer

    t0 = time.perf_counter()
    try:
        tool_path = find_compute_sanitizer()
    except RuntimeError as e:
        raise SystemExit("phase 19: %s" % e)
    me = os.path.abspath(__file__)
    res = {"card": smi, "compute_sanitizer": tool_path, "tools": {}}
    with tempfile.TemporaryDirectory(prefix="ipt-sanitize-") as d, \
            ThreadPoolExecutor(len(SANITIZE_TOOLS) + 1) as pool:
        runs = {}
        for name in SANITIZE_TOOLS + ("checked",):
            env = dict(os.environ)
            if name in SANITIZE_OWN_ALLOCATIONS:
                env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
            argv = (sanitizer_argv(tool_path, name) if name != "checked"
                    else [sys.executable, me, "--sanitize-child",
                          "--checked"])
            path = os.path.join(d, name + ".log")
            runs[name] = (pool.submit(logged_run, argv, env, path,
                                      SANITIZE_LIMIT_S), path)
        res["front_door"] = sanitized_front_door(binaries, server_args)
        for name, (run, path) in runs.items():
            rc, secs = run.result()
            with open(path, errors="replace") as f:
                text = f.read()
            if rc is None:
                raise SystemExit("phase 19 %s: still running after %d s:\n%s"
                                 % (name, SANITIZE_LIMIT_S, text[-4000:]))
            if name == "checked":
                child = _CHILD_LINE.findall(text)
                if rc != 0 or not child:
                    raise SystemExit("phase 19 checked build: exit %d:\n%s"
                                     % (rc, text[-6000:]))
                child = json.loads(child[-1])
                res["checked"] = dict(child, rc=rc, seconds=secs)
                log("phase 19 checked build: %d cases, %d launches (pair %d, "
                    "step %d), bit-identical, check failures %s, %.1f s"
                    % (child["cases"], child["launches"],
                       child["kernel_launches"]["pair_scan"],
                       child["kernel_launches"]["step_scan"],
                       json.dumps(child["check_failures"]), secs))
                continue
            out = sanitizer_outcome(rc, text)
            summary = [ln for ln in text.splitlines()
                       if "SUMMARY" in ln or SANITIZE_REFUSED in ln][-2:]
            res["tools"][name] = dict(out, seconds=secs, summary=summary)
            if out["status"] == "failed":
                raise SystemExit("phase 19 %s: %s\n%s"
                                 % (name, out["why"], text[-6000:]))
            log("phase 19 compute-sanitizer --tool %s: %s (%s), %.1f s"
                % (name, out["status"], " / ".join(summary), secs))
    res["sass_lineinfo"] = sass_lineinfo_equal(sass_pairs)
    for name, r in res["sass_lineinfo"].items():
        if not r["equal"]:
            raise SystemExit("phase 19: %s's SASS differs with -lineinfo: %s"
                             % (name, r["first_difference"]))
    log("phase 19 -lineinfo: SASS equal with and without it (%s)"
        % ", ".join("%s %d instructions" % (k, v["instructions"])
                    for k, v in res["sass_lineinfo"].items()))
    res["seconds"] = time.perf_counter() - t0
    log("phase 19: %.1f s; compute-sanitizer %s; checked build and "
        "sanitized sidecars clean" % (res["seconds"], json.dumps(
            {k: v["status"] for k, v in res["tools"].items()})))
    return res


def main() -> int:
    if sys.argv[1:] == ["--stream-cpu-reference"]:
        return stream_cpu_reference()
    if sys.argv[1:2] == ["--post-cpu-reference"]:
        return post_cpu_reference(sys.argv[2], int(sys.argv[3]))
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    sanitize = sys.argv[1:] in (["--sanitize-child"],
                                ["--sanitize-child", "--checked"])
    if sys.argv[1:] and not (kernels_only or sanitize):
        print("usage: chip_smoke.py [--kernels-only | --sanitize-child "
              "[--checked]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if sanitize:
        return sanitize_child("--checked" in sys.argv)
    child = None if kernels_only else stream_cpu_child()
    try:
        return run_phases(kernels_only, child)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()


def run_phases(kernels_only: bool, stream_child) -> int:
    """Every phase (the module docstring); ``stream_child`` is phase 6's
    CPU reference, already running."""
    from ingress_plus_tpu_torch.models import libdetect
    from ingress_plus_tpu_torch.ops.cuda_build import (
        CHECK_FLAGS,
        NATIVE_BINARIES,
        NVCC_FLAGS,
        SANITIZER_BINARIES,
        KernelLibrary,
        build_native,
    )
    from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN, ByteScanner
    from ingress_plus_tpu_torch.ops.scan import ScanTables, scan_pairs
    from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN
    from ingress_plus_tpu_torch.weights import load_pack

    t0 = time.perf_counter()
    log("torch %s cuda %s on %s (%d cards)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    sources = (PAIR_SCAN.lib, STEP_SCAN.lib, libdetect._TWIN)
    # phase 19: the kernels' checked builds, and their shipping builds
    # without -lineinfo (the SASS comparison)
    no_lineinfo = tuple(f for f in NVCC_FLAGS if f != "-lineinfo")
    extra = tuple(KernelLibrary(k.lib.source, {}, None, flags=flags)
                  for flags in (CHECK_FLAGS, no_lineinfo)
                  for k in (PAIR_SCAN, STEP_SCAN))

    def build(lib):
        t = time.perf_counter()
        return lib.build(verbose=lib in sources), time.perf_counter() - t

    def build_front():
        t = time.perf_counter()
        return (build_native(NATIVE_BINARIES + SANITIZER_BINARIES),
                time.perf_counter() - t)

    # one compiler per source (nvcc for the kernels, g++ for the twin),
    # beside the front door's binaries (phase 17) and their sanitizer
    # builds (phase 19)
    with ThreadPoolExecutor(len(sources) + len(extra) + 1) as pool:
        front_built = pool.submit(build_front)
        built = list(pool.map(build, sources + extra))
        native, native_s = front_built.result()
    built, extra_built = built[:len(sources)], built[len(sources):]
    for lib, (path, secs) in zip(extra, extra_built):
        log("built %s (%s) in %.1fs" % (path.name, " ".join(
            f for f in lib.flags if f not in NVCC_FLAGS) or "no -lineinfo",
            secs))
    dev = torch.device("cuda")
    for src, (lib, secs) in zip(sources, built):
        src.load(dev)
        log("built %s with %s in %.1fs" % (lib.name, src.compiler, secs))
    log("built the front door's %s from native/ in %.1fs"
        % (", ".join(sorted(native)), native_s))
    libs = [path for path, _ in built]
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
    tooling = phase_native_kernels(dev, requests)
    stream, stream_waves = phase_stream(cr, dev, stream_child)
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
    post, post_shapes = phase_post_scoring(requests, smi, dev)
    log("post " + json.dumps(post, default=str))
    post_k = phase_serve_kernels(kern["tables"], post_shapes, pool, dev,
                                 "post")
    late = phase_tooling_ab(dev, requests, want)
    tooling.update(late, seconds=tooling["seconds"] + late["seconds"],
                   twin_build_s=built[2][1])
    log("native confirm and tooling " + json.dumps(
        {k: v for k, v in tooling.items() if k != "scan_modes"}))
    from ingress_plus_tpu_torch.utils.stream_corpus import stream_cases

    mesh = phase_mesh(cr, dev, requests, want,
                      stream_cases(STREAM_BODY, STREAM_CHUNK, SEED), pool)
    log("mesh " + json.dumps({k: v for k, v in mesh.items()
                              if not k.startswith("retimed")}))
    fleet = phase_fleet(requests, want, smi)
    log("fleet " + json.dumps(fleet))
    quality, quality_shapes, quality_pool = phase_quality(dev)
    quality_k = retime_shapes(
        "quality pair", ByteScanner(kern["tables"]), PAIR_SCAN,
        lambda t, n, *c: scan_pairs(kern["tables"], t, n, *c),
        kern["tables"], quality_shapes, quality_pool, dev, "pair")
    log("quality " + json.dumps(quality))
    controller, controller_shapes = phase_controller(requests, smi)
    log("controller " + json.dumps(controller))
    controller_k = phase_serve_kernels(kern["tables"], controller_shapes,
                                       pool, dev, "controller")
    front, front_shapes, (shim_cr, shim_shapes) = phase_front_door(
        requests, want, stream_cases(STREAM_BODY, STREAM_CHUNK, SEED),
        stream["cpu_keys"], STREAM_CHUNK, smi, dev)
    log("front door " + json.dumps(front))
    front_k = phase_serve_kernels(kern["tables"], front_shapes, pool, dev,
                                  "front door")
    shim_k = phase_serve_kernels(
        ScanTables.from_bitap(shim_cr.tables, dev),
        shim_shapes, pool, dev, "shim")
    card_files = phase_card_files(smi)
    sanitizers = phase_sanitizers(native, {
        "pair_scan": (libs[0], extra_built[2][0]),
        "step_scan": (libs[1], extra_built[3][0])}, smi)
    sass = {"pair_scan": sass_loop_mix(libs[0], "pair", 2),
            "step_scan": sass_loop_mix(libs[1], "byte", 1)}
    log("sass loops: %s" % json.dumps(sass))
    detail = {
        "card": smi, "pipeline": pipe, "main_path": main_path,
        "scan_shapes": kern["shapes"], "edges": kern["edges"],
        "sweep": sweep, "step_scan": step, "pallas_pipeline": pallas,
        "stream": stream, "serve": serve, "serve_kernels": serve_k,
        "rollout": rollout, "rollout_kernels": rollout_k,
        "fault_matrix": fault_matrix, "post": post, "post_kernels": post_k,
        "native_tooling": tooling, "mesh": mesh, "fleet": fleet,
        "quality": quality, "quality_kernels": quality_k,
        "controller": controller, "controller_kernels": controller_k,
        "front_door": front, "front_door_kernels": front_k,
        "shim_kernels": shim_k, "card_files": card_files,
        "sanitizers": sanitizers, "sass": sass,
        "seconds": time.perf_counter() - t0}
    log("detail " + json.dumps(detail))
    tot = main_path["total"]
    scaled = tooling["scaled"]
    step_paths = {"stream": stream["retimed"]["total"],
                  "pallas_batch": pallas["retimed"]["total"],
                  "take_batch": pallas["take"]["retimed"]["total"]}
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
        + segment_rows("take batch path",
                       pallas["take"]["retimed"]["shapes"].values())
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
    post_entries = [entry(
        name, "post plane and scoring head (phase 11): %s" % what,
        post_k[name]["total"], post_k[name]["total"]["max_abs_err"],
        parity="bit-identical match and state at each of the phase 11 "
               "server's %d (B, L, carried) shapes on the bundled tables"
               % len(post_k[name]["shapes"]),
        shape="the phase 11 server's %d launches (serving cycles under "
              "both heads: %d; the watcher's and head 2's admission and "
              "shadow work: %d), each shape's device time once per launch "
              "of it, on the bundled pack's tables"
              % (post_k[name]["total"]["launches"],
                 post["launches"]["serve_scope"][name],
                 post["launches"]["rollout_scope"][name]),
        segments=segment_rows("post path", post_k[name]["shapes"].values()))
        for name, what in (("pair_scan", "batches on pallas3 under a "
                                         "learned head, admissions and "
                                         "shadow scans"),
                           ("step_scan", "carried scans of the admissions"))
        if post_k[name]["total"]["launches"]]
    mesh_t = mesh["retimed"]["total"]
    mesh_entries = [entry(
        "pair_scan", "mesh (phase 13 (d)): a --mesh 1x1 server's batches, "
        "pallas2 on the shard's class-id tables", mesh_t,
        mesh_t["max_abs_err"], configuration="class_id (pallas2)",
        parity="bit-identical match and state at each of the --mesh 1x1 "
               "server's %d (B, L, carried) shapes on the 1x1 shard's "
               "tables (W=%d); every shard of the 2x4 mesh on one card "
               "at %d (shard, data row, shape) launches; the 1x1 and 2x4 "
               "steps equal the plain cpu step on every bucket"
               % (len(mesh["retimed"]["shapes"]),
                  mesh["serve"]["mesh"]["w_shard"],
                  mesh["mesh_2x4"]["shard_checks"]),
        shape="the server's %d pallas2 launches, each shape's device time "
              "once per launch of it (class ids mapped beforehand); bound "
              "from the work the server counted, 4 bytes a token"
              % mesh_t["launches"],
        segments=segment_rows("mesh path", mesh["retimed"]["shapes"].values()))]
    mesh24 = mesh["retimed_2x4"]["total"]
    mesh_entries.append(entry(
        "pair_scan", "mesh (phase 13 (b)): the 2x4 mesh's steps on one "
        "card, pallas2 on each shard's class-id tables", mesh24,
        mesh24["max_abs_err"], configuration="class_id (pallas2)",
        parity="bit-identical match and state at every one of the %d "
               "launches, each on its own rows and shard's tables (w_shard "
               "%d); the steps equal the 1x1's on every bucket"
               % (mesh24["launches"], mesh["mesh_2x4"]["w_shard"]),
        shape="the 2x4 steps' %d launches (%d shards x %d data rows x %d "
              "buckets), each timed on its own inputs, summed"
              % (mesh24["launches"], MESH_SHAPE[1], MESH_SHAPE[0],
                 mesh["buckets"]),
        segments=[{"path": "2x4 mesh, shard %d" % a["shard"],
                   **{k: a[k] for k in ("launches", "B", "L", "G",
                                        "segments", "ms",
                                        "one_segment_ms")}}
                  for a in mesh["retimed_2x4"]["shapes"]]))
    qt = quality_k["total"]
    quality_entries = [entry(
        "pair_scan", "quality gates (phase 15): build_report and run_gate "
        "batches on pallas3 (raw_byte)", qt, qt["max_abs_err"],
        parity="bit-identical match and state at each of the phase's %d "
               "(B, L) shapes; the gate's masked prefilter equals the cpu "
               "pipeline's on all %d chunks"
               % (len(quality_k["shapes"]),
                  quality["gate"]["reference_chunks"]),
        shape="the phase's %d launches (report %d, gate %d), each shape's "
              "device time once per launch of it (rows cut from the "
              "phase's traffic to the shape's latest lengths); bound from "
              "the work the launches counted"
              % (quality["launches"], quality["report"]["launches"],
                 quality["gate"]["launches"]),
        segments=segment_rows("quality gates",
                              quality_k["shapes"].values()))]
    controller_entries = [entry(
        name, "%s: controller sync, config #4 (phase 16)" % name,
        controller_k[name]["total"], controller_k[name]["total"]["max_abs_err"],
        parity="bit-identical match and state at each of the phase 16 "
               "server's %d (B, L, carried) shapes on the bundled tables"
               % len(controller_k[name]["shapes"]),
        shape="the phase 16 server's %d launches (two waves of %d "
              "requests over 257 tenants' masks and the pushed ACLs), each "
              "shape's device time once per launch of it (rows cut from the "
              "wire traffic to the shape's latest lengths); bound from the "
              "work the server counted"
              % (controller_k[name]["total"]["launches"],
                 controller["wave1"]["requests"]),
        x_bound=(controller_k[name]["total"]["ms"]
                 / controller_k[name]["total"]["bound_ms"]),
        segments=segment_rows("controller path",
                              controller_k[name]["shapes"].values()))
        for name in ("pair_scan", "step_scan")
        if controller_k[name]["total"]["launches"]]
    front_entries = [entry(
        name, "%s: %s (phase 17)" % (name, what), front_k[name]["total"],
        max(front_k[name]["total"]["max_abs_err"],
            shim_k[name]["total"]["max_abs_err"]),
        parity="bit-identical match and state at each of the phase 17 "
               "servers' %d (B, L, carried) shapes on the bundled tables, "
               "and at the nginx harness server's %d shapes on its three "
               "rules' tables (%d launches)"
               % (len(front_k[name]["shapes"]), len(shim_k[name]["shapes"]),
                  shim_k[name]["total"]["launches"]),
        shape="the %d launches of the servers behind the sidecar and "
              "loadgen (legs A, B, C: phase 3's requests and 8 chunked "
              "streams, config #1's %d frames four times, the rendered "
              "front door at two loads), each shape's device time once per "
              "launch of it; bound from the work the servers counted"
              % (front_k[name]["total"]["launches"], front["B"]["requests"]),
        x_bound=(front_k[name]["total"]["ms"]
                 / front_k[name]["total"]["bound_ms"]),
        segments=segment_rows("front door path",
                              front_k[name]["shapes"].values()))
        for name, what in (("pair_scan", "front door, config #1"),
                           ("step_scan", "front door"))]
    print("phase 18 " + json.dumps({
        k: card_files[k] for k in ("card", "seconds", "passed", "files")}),
        flush=True)
    print("phase 19 " + json.dumps({
        "card": smi, "seconds": sanitizers["seconds"],
        "compute_sanitizer": {k: {f: v[f] for f in ("status", "summary",
                                                     "seconds")}
                              for k, v in sanitizers["tools"].items()},
        "checked": {k: sanitizers["checked"][k] for k in (
            "cases", "launches", "kernel_launches", "check_failures",
            "identical", "seconds")},
        "front_door": sanitizers["front_door"],
        "sass_lineinfo": sanitizers["sass_lineinfo"]}), flush=True)
    print(json.dumps({"kernels": serve_entries + mesh_entries
                      + rollout_entries + post_entries + quality_entries
                      + controller_entries + front_entries
                      + [entry(
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
        "step_scan", "library: stream lane, pallas and take batch paths "
                     "(phases 5, 6)", step_tot,
        max(s["max_abs_err"] for s in step["shapes"]),
        launches_by_path={"stream": stream["launches"],
                          "pallas_batch": pallas["launches"],
                          "take_batch": pallas["take"]["launches"]},
        parity="bit-identical match and state: B=%d x L in %s, B=%d x L in "
               "%s split and unsplit; edges %s; chained carry %s; every "
               "pallas and take bucket and every stream wave"
               % (SCAN_B, list(SCAN_LS), SPLIT_B, list(SPLIT_LS),
                  step["edges"], step["chain"]),
        shape="the stream lane's %d waves, the pallas batch path's %d "
              "launches and the take batch path's %d, summed"
              % (stream["launches"], pallas["launches"],
                 pallas["take"]["launches"]),
        plain_over="one call per pallas and take bucket; one call over "
                   "the %d rows of all %d stream waves stacked"
                   % (stream["retimed"]["total"]["plain_rows"],
                      stream["launches"]),
        segments=step_segments), entry(
        "pair_scan", "library: pallas3 batch path on the %gx pack "
                     "(phase 12)" % SCALE_FACTOR, scaled["retimed"]["total"],
        max(r["max_abs_err"] for r in scaled["shapes"]),
        parity="bit-identical match and state on the %gx pack's tables "
                  "(W=%d, K+1=%d): both kernels at %s carried, and every "
                  "launch of the path"
                  % (SCALE_FACTOR, scaled["W"], scaled["K1"],
                     ["%dx%d" % sh for sh in SCALE_SHAPES]),
        shape="the %d launches of phase 3's first %d requests on the %gx "
              "pack, summed" % (scaled["launches"], scaled["requests"],
                                SCALE_FACTOR),
        segments=segment_rows("2x pack path",
                              scaled["retimed"]["shapes"].values()))]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
