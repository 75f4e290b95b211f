"""UDS serve loop + observability endpoints.

The port of ``ingress_plus_tpu/serve/server.py``: the same UDS wire
protocol (the same frames, the same answers), the same HTTP surface for
what this package has, and the serve plane on a CUDA card.  The
dispatcher process of SURVEY.md §7 accepts framed requests from the
native sidecar over a unix socket, batches them (batcher.py), and fans
verdicts back (out-of-order, correlated by req_id).  A small HTTP
listener exposes ``/metrics`` (Prometheus text format), ``/healthz``
(LIVENESS: 200 while the process serves at all, carrying the fail-safe
plane's state and ``robustness.device_path``), ``/readyz`` (READINESS:
503 while the dispatch breaker is open or the brownout ladder sits above
full detection — docs/ROBUSTNESS.md), ``/faults`` (the
deterministic fault-injection plan, utils/faults.py), and
``/debug/kernels`` (each scan kernel's launches by shape).

Rules: ``--rules-dir R`` compiles the SecLang tree ``R`` with the port's
own compiler (``compiler/``) at startup, and a tree that does not
compile exits non-zero; without it the server loads the committed
bundled pack.  A pack that reached live under a staged rollout is the
last-known-good (``--lkg-dir``), which a restart prefers over both.
``POST /configuration/ruleset`` takes a compiled pack through the
guarded rollout (control/rollout.py: admission gate, shadow, canary
ramp, promote or rollback; ``?mode=force`` is the break-glass one-shot
swap), ``/rollout`` reads or aborts it, and ``/rules/stats?format=
profile`` exports the ``MeasuredProfile``.

The post plane (``--spool-dir`` / ``--export-url`` / ``--artifact-dir``):
each verdict is recorded to ``post.PostChannel`` after it is final, the
exporter delivers attacks and brute/dirbust events off the hot path,
``/wallarm-status`` serves its counters, and a ``RulesetWatcher`` stages
new compiled packs from ``--artifact-dir`` through
``/configuration/ruleset``.  The learned scoring head (``--scoring-head``,
else the scorer LKG in ``--lkg-dir``) decides the attack flag;
``/scoring`` reads it and ``POST /configuration/scoring`` stages a new one
through the same rollout.

``--mesh 2x4`` (or ``data=2,model=4``) serves the scan over a (data ×
model) device mesh (parallel/serve_mesh.py ``MeshEngine``): the same
batcher, buckets and confirm, with each bucket scanned by every (data
row, model shard) entry on its own device and CUDA stream — on ``cuda``
the pair kernel on each shard's class-id tables (``pallas2``) or the
step kernel (``take``), on ``cpu`` the plain ``pair`` or ``take`` scan.
``--mesh`` takes one lane (``--lanes 1``); ``/rules/stats``
``.device.mesh`` and ``/debug/kernels`` ``mesh`` carry each entry's
launches.

``--scan-impl auto`` (the default) runs a startup bake-off on the live
device, single engine or mesh: each impl the device can run is timed at
one shape, the fastest is installed, and stderr gets ``scan impl
auto-select: <impl>  (<impl>=<ms>ms, ...)``.  ``--scan-impl <impl>``
installs that impl and measures nothing.

``--front`` runs the shared admission front instead of a detection node
(serve/front.py): it fans the same wire protocol across the
``--backend NAME=SOCKET[@HOST:PORT]`` replicas, builds no batcher and
imports no kernel (``serve/__main__.py`` routes it before this module
loads).

Run:  python -m ingress_plus_tpu_torch.serve --socket /tmp/ipt.sock \
          [--http-port 9901] [--mode block] [--platform cuda|cpu] \
          [--rules-dir R] [--lkg-dir D] [--mesh 2x4]

``--platform`` defaults to ``cuda``: without a card the process exits
non-zero at startup, it never serves on the CPU unless asked to.  On
``cuda`` both scan kernels are built and loaded before the socket opens
(and before the bake-off, whose launches ``/debug/kernels?scope=autoselect``
counts).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from ingress_plus_tpu_torch.models.engine import DetectionEngine
from ingress_plus_tpu_torch.models.pipeline import Verdict
from ingress_plus_tpu_torch.ops.cuda_build import SERVE_SCOPE
from ingress_plus_tpu_torch.ops.pair_scan import PAIR_SCAN
from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN
from ingress_plus_tpu_torch.serve.batcher import Batcher
from ingress_plus_tpu_torch.serve.stream import StreamState
from ingress_plus_tpu_torch.serve.protocol import (
    CHUNK_MAGIC,
    MODE_STREAM,
    PARSER_OFF_BITS,
    REQ_MAGIC,
    RSCAN_MAGIC,
    WS_DIR_S2C,
    WS_END,
    WS_MAGIC,
    MultiFrameReader,
    ProtocolError,
    decode_chunk,
    decode_request,
    decode_response_scan,
    decode_ws,
    encode_response,
)
from ingress_plus_tpu_torch.serve.websocket import DIR_C2S, DIR_S2C, WSStream
from ingress_plus_tpu_torch.utils.trace import thread_uncaught_counts


MAX_STREAMS_PER_CONN = 256  # bounded per-connection stream state
MAX_WS_PER_CONN = 128       # bounded per-connection upgraded-conn state
_OVERFLOW = object()        # sentinel: stream rejected by the cap

#: HELP text per exported metric (Prometheus exposition hygiene: the
#: promlint CI gate requires a HELP line for every TYPE).  Metrics not listed get a generated pointer to the docs —
#: `_with_help` guarantees the pair structurally, this dict makes the
#: important ones say something.
METRIC_HELP = {
    "ipt_requests_total": "requests served to a verdict",
    "ipt_batches_total": "dispatch cycles executed",
    "ipt_queue_delay_us_sum": "cumulative admission-queue wait (us)",
    "ipt_batch_us_sum": "cumulative dispatch-cycle wall time (us)",
    "ipt_max_batch": "largest batch seen since startup",
    "ipt_fail_open_total": "verdicts delivered fail-open (pass+flag)",
    "ipt_deadline_overruns_total":
        "requests whose cycle exceeded the hard deadline",
    "ipt_shed_total": "requests shed fail-open at admission, by reason",
    "ipt_queue_depth": "items waiting in the admission queue",
    "ipt_degraded_mode": "brownout ladder rung (0=full detection)",
    "ipt_degraded_verdicts_total": "verdicts served degraded",
    "ipt_breaker_state": "device breaker (0=closed 1=half_open 2=open)",
    "ipt_breaker_trips_total": "device breaker trips",
    "ipt_watchdog_hangs_total": "device dispatches past the hang budget",
    "ipt_cpu_fallback_batches_total":
        "batches served on the CPU confirm-only fallback",
    "ipt_breaker_fail_open_batches_total":
        "breaker-open batches of a card pipeline, failed open",
    "ipt_stage_us": "per-stage latency histogram (log2 us buckets)",
    "ipt_batch_size": "batch-size distribution (pow2 buckets)",
    "ipt_rule_family_hits_total": "confirmed hits per CRS family",
    "ipt_rule_family_candidates_total":
        "prefilter candidates per CRS family",
    "ipt_confirm_errors_total":
        "candidates whose confirm regex could never evaluate",
    "ipt_rules_runtime_dead": "rules observed dead at runtime",
    "ipt_pad_waste_ratio": "1 - live bytes / padded rectangle bytes",
    "ipt_dispatch_fill": "live rows / padded rows per dispatch",
    "ipt_engine_recompiles_total":
        "serve-time first loads (a kernel or a table replica on a device)",
    "ipt_confirm_workers": "confirm pool size (1 = inline serial walk)",
    "ipt_kernel_launches_total":
        "scan kernel launches of the serving cycles, by kernel",
    "ipt_confirm_quick_reject_total":
        "confirm evaluations resolved by the literal quick-reject",
    "ipt_confirm_regex_evals_total": "confirm re.search evaluations",
    "ipt_confirm_memo_hits_total": "per-cycle flood-memo hits",
    "ipt_confirm_memo_misses_total": "per-cycle flood-memo misses",
    "ipt_tenant_queue_depth": "per-tenant fair-queue depth",
    "ipt_tenant_admitted_total": "requests admitted per tenant",
    "ipt_tenant_shed_total": "requests shed per tenant",
    "ipt_tenant_degraded_total": "degraded verdicts per tenant",
    "ipt_thread_uncaught_total":
        "uncaught worker-thread exceptions by thread family",
    "ipt_lane_count": "serve lanes (one per device)",
    "ipt_lane_requests_total": "requests dispatched per lane",
    "ipt_lane_rows_total": "scan rows dispatched per lane",
    "ipt_lane_errors_total": "dispatch errors per lane",
    "ipt_lane_busy_us_sum": "device-busy wall time per lane (us)",
    "ipt_ruleset_info": "live ruleset version/size (info joint)",
    "ipt_scorer_active": "1 while a learned scoring head is installed",
    "ipt_scorer_diff_total":
        "verdicts where the learned head disagreed with fixed weights",
}


def _with_help(lines):
    """Insert a ``# HELP`` line before every ``# TYPE`` line (once per
    metric name) — the exposition-hygiene invariant the promlint gate
    scrapes for.  Names without curated text get a docs pointer."""
    out = []
    seen = set()
    for line in lines:
        if line.startswith("# TYPE "):
            name = line.split()[2]
            if name not in seen:
                seen.add(name)
                out.append("# HELP %s %s" % (name, METRIC_HELP.get(
                    name, "%s (docs/OBSERVABILITY.md)" % name)))
        out.append(line)
    return out


class ServeLoop:
    def __init__(self, batcher: Batcher, socket_path: str,
                 http_port: int = 0, post=None,
                 sidecar_status: Optional[str] = None):
        self.batcher = batcher
        self.post = post  # PostChannel | None — postanalytics write side
        self.socket_path = socket_path
        self.http_port = http_port
        # "host:port" of the native sidecar's --status-port listener:
        # when set, /traces/request includes the sidecar hop's per-
        # upstream EWMA latency (the sidecar stamps every frame's
        # send→verdict time; its status JSON is where that surfaces)
        self.sidecar_status = sidecar_status
        self.started = time.time()
        self.connections = 0
        self._servers = []
        # live UDS connection writers: the in-process node-kill drill
        # (control/fleetctl.py NodeHarness) aborts these so the front
        # sees a real EOF, exactly like a killed process
        self._conn_writers = set()

    # ------------------------------------------------------- UDS plane

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        self._conn_writers.add(writer)
        frames = MultiFrameReader({REQ_MAGIC: "req", CHUNK_MAGIC: "chunk",
                                   RSCAN_MAGIC: "rscan", WS_MAGIC: "ws"})
        loop = asyncio.get_running_loop()
        streams = {}  # req_id → StreamState | None (None = mode-off stream)
        ws_streams = {}  # stream_id → WSStream (live captures only)
        ws_shed = set()  # over-cap stream ids already counted in stats
        write_lock = asyncio.Lock()
        classes_index = {c: i for i, c in enumerate(
            self.batcher.pipeline.ruleset.classes)}

        async def respond(req_id: int, verdict, request=None) -> None:
            # postanalytics write (log-phase analog): after the verdict is
            # final, before the frame hits the wire — O(1), lossy, off-path
            if self.post is not None and request is not None:
                try:
                    self.post.record(request, verdict)
                except Exception:
                    pass  # postanalytics must never break delivery
            data = encode_response(
                req_id, verdict.attack, verdict.blocked, verdict.fail_open,
                verdict.score,
                [classes_index[c] for c in verdict.classes],
                verdict.rule_ids)
            try:
                async with write_lock:
                    writer.write(data)
                    await writer.drain()
            except (ConnectionError, RuntimeError):
                pass  # client went away mid-verdict; nothing to deliver to

        pending = set()

        def send_pass(req_id: int, fail_open: bool = False) -> None:
            # clean pass verdict (mode off / overflow shed), unscanned
            t = asyncio.ensure_future(respond(req_id, Verdict(
                request_id=str(req_id), blocked=False, attack=False,
                classes=[], rule_ids=[], score=0, fail_open=fail_open)))
            pending.add(t)
            t.add_done_callback(pending.discard)

        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                try:
                    payloads = frames.feed(data)
                except ProtocolError:
                    break  # corrupt stream: drop the connection
                for kind, payload in payloads:
                    if kind == "chunk":
                        try:
                            req_id, last, chunk = decode_chunk(payload)
                        except ProtocolError:
                            continue
                        if req_id not in streams:
                            continue  # unknown/expired stream: ignore
                        handle = streams[req_id]
                        if isinstance(handle, StreamState) and chunk:
                            self.batcher.feed_chunk(handle, chunk)
                        if last:
                            streams.pop(req_id)
                            if not isinstance(handle, StreamState):
                                send_pass(req_id,
                                          fail_open=handle is _OVERFLOW)
                                continue
                            fut = self.batcher.finish_stream(handle)
                            afut = asyncio.wrap_future(fut, loop=loop)
                            task = asyncio.ensure_future(afut)
                            pending.add(task)

                            def _sdone(t, req_id=req_id,
                                       request=handle.request):
                                pending.discard(t)
                                if (not t.cancelled()
                                        and t.exception() is None
                                        and not writer.is_closing()):
                                    rt = asyncio.ensure_future(respond(
                                        req_id, t.result(), request))
                                    pending.add(rt)
                                    rt.add_done_callback(pending.discard)
                            task.add_done_callback(_sdone)
                        continue
                    if kind == "ws":
                        # wallarm_parse_websocket analog: raw upgraded-
                        # connection bytes; parse RFC 6455, scan messages
                        # (serve/websocket.py), answer one RTPI per frame
                        try:
                            (req_id, stream_id, tenant, mode, wflags,
                             wdata) = decode_ws(payload)
                        except ProtocolError:
                            continue
                        ws = ws_streams.get(stream_id)
                        if ws is None:
                            eff_mode = mode & 0x03
                            if eff_mode == 0:
                                # mode off: answered per frame, NO dict
                                # entry — sentinel entries only freed on
                                # WS_END accumulated unboundedly on the
                                # long-lived mux conn
                                send_pass(req_id)
                                continue
                            if len(ws_streams) >= MAX_WS_PER_CONN:
                                # over cap: per-frame fail-open verdicts,
                                # state-free.  If capacity frees later
                                # the mid-stream bytes poison the fresh
                                # parser → still fail-open, deterministic.
                                # The stats counter ticks once per SHED
                                # STREAM, not per frame (bounded set; at
                                # the cap it resets — slight over-count
                                # beats unbounded growth)
                                if stream_id not in ws_shed:
                                    if len(ws_shed) >= 4096:
                                        ws_shed.clear()
                                    ws_shed.add(stream_id)
                                    self.batcher.pipeline.stats \
                                        .count_fail_open()
                                send_pass(req_id, fail_open=True)
                                continue
                            off = frozenset(
                                n for n, bit in PARSER_OFF_BITS.items()
                                if mode & bit)
                            ws = WSStream(self.batcher, tenant, eff_mode,
                                          stream_id, parsers_off=off)
                            ws_streams[stream_id] = ws
                        direction = (DIR_S2C if wflags & WS_DIR_S2C
                                     else DIR_C2S)
                        pairs = ws.feed(direction, wdata)
                        if wflags & WS_END:
                            pairs += ws.close()
                            ws_streams.pop(stream_id, None)

                        prev_reply = getattr(ws, "_prev_reply", None)

                        async def _ws_reply(req_id=req_id, ws=ws,
                                            pairs=pairs, prev=prev_reply):
                            # replies are serialized PER STREAM (frames
                            # of one upgraded connection answer in
                            # order, so the sticky verdict is monotonic
                            # on the wire); streams stay concurrent
                            if prev is not None:
                                try:
                                    await prev
                                except Exception:
                                    pass
                            # fold completed-message verdicts into the
                            # stream's sticky state, then answer with it;
                            # each message is recorded to postanalytics
                            # individually (the frame verdict is not)
                            for msg, fut in pairs:
                                try:
                                    v = await asyncio.wrap_future(
                                        fut, loop=loop)
                                except Exception:
                                    ws.sticky_fail_open = True
                                    continue
                                ws.merge(v)
                                if self.post is not None:
                                    try:
                                        self.post.record(msg, v)
                                    except Exception:
                                        pass
                            await respond(req_id, ws.verdict(req_id))

                        t = asyncio.ensure_future(_ws_reply())
                        ws._prev_reply = t
                        pending.add(t)
                        t.add_done_callback(pending.discard)
                        continue
                    try:
                        if kind == "rscan":
                            # response-side analysis (wallarm_parse_response
                            # analog): a Response flows through the SAME
                            # batcher/pipeline — its rows carry resp_*
                            # stream ids, so only 95x-family rules apply
                            req_id, mode, request = \
                                decode_response_scan(payload)
                            mode &= ~MODE_STREAM   # undefined for rscan
                        else:
                            req_id, mode, request = decode_request(payload)
                    except ProtocolError:
                        continue
                    if mode & MODE_STREAM:
                        # streaming body: inline body = first chunk
                        eff_mode = mode & ~MODE_STREAM
                        if eff_mode == 0:
                            streams[req_id] = None
                            continue
                        if (sum(1 for h in streams.values()
                                if isinstance(h, StreamState))
                                >= MAX_STREAMS_PER_CONN):
                            # per-connection memory bound (the MAX_FRAME
                            # bound of the non-stream path): excess
                            # streams pass fail-open, never accumulate
                            streams[req_id] = _OVERFLOW
                            self.batcher.pipeline.stats.count_fail_open()
                            continue
                        request.mode = eff_mode
                        first_chunk = request.body
                        request.body = b""
                        handle = self.batcher.begin_stream(request)
                        streams[req_id] = handle
                        if first_chunk:
                            self.batcher.feed_chunk(handle, first_chunk)
                        continue
                    if mode == 0:
                        # wallarm_mode off: no processing at all (reference
                        # semantics) — immediate pass, skip the engine
                        send_pass(req_id)
                        continue
                    request.mode = mode
                    fut = self.batcher.submit(request)
                    afut = asyncio.wrap_future(fut, loop=loop)
                    task = asyncio.ensure_future(afut)
                    pending.add(task)

                    def _done(t, req_id=req_id, request=request):
                        pending.discard(t)
                        if (not t.cancelled() and t.exception() is None
                                and not writer.is_closing()):
                            rt = asyncio.ensure_future(
                                respond(req_id, t.result(), request))
                            pending.add(rt)
                            rt.add_done_callback(pending.discard)
                    task.add_done_callback(_done)
        finally:
            for handle in streams.values():
                if isinstance(handle, StreamState):
                    self.batcher.abort_stream(handle)
            for w in ws_streams.values():
                if isinstance(w, WSStream):
                    w.abort()
            for t in pending:
                t.cancel()
            try:
                writer.close()
            except RuntimeError:
                # interpreter-shutdown race: asyncio.run() can close the
                # loop while a connection's finally block still runs —
                # the transport dies with the loop either way, and the
                # traceback would only be noise on stderr
                pass
            self._conn_writers.discard(writer)
            self.connections -= 1

    # ------------------------------------------------------ HTTP plane

    def _pipeline_overlap_brief(self):
        """The /healthz face of the flight recorder's overlap report
        (utils/overlap.py): a bounded snapshot over the last 64 cycles,
        None when the recorder is off or has seen no cycle yet (the
        shared collector never raises — liveness is sacred)."""
        from ingress_plus_tpu_torch.utils.overlap import brief, collect

        return brief(collect(self.batcher, cycles=64))

    def _metrics_text(self) -> str:
        s = self.batcher.stats
        pipeline = self.batcher.pipeline
        p = pipeline.stats
        # the live ruleset version, attached ONLY to per-generation
        # series (RuleStats-backed values that reset at each hot swap,
        # so a version change is an honest Prometheus counter reset).
        # The cumulative counters spanning swaps stay UNLABELED — a
        # mutable label on a counter that keeps its value would strand
        # the old series and pre-load the new one; cross-reload
        # attribution for those is the ipt_ruleset_info join.
        ver = 'version="%s"' % pipeline.ruleset.version
        lines = [
            "# TYPE ipt_requests_total counter",
            "ipt_requests_total %d" % s.completed,
            "# TYPE ipt_batches_total counter",
            "ipt_batches_total %d" % s.batches,
            "# TYPE ipt_queue_delay_us_sum counter",
            "ipt_queue_delay_us_sum %d" % s.queue_delay_us_sum,
            "# TYPE ipt_batch_us_sum counter",
            "ipt_batch_us_sum %d" % s.batch_us_sum,
            "# TYPE ipt_max_batch gauge",
            "ipt_max_batch %d" % s.max_batch_seen,
            "# TYPE ipt_fail_open_total counter",
            "ipt_fail_open_total %d" % p.fail_open,
            "# TYPE ipt_deadline_overruns_total counter",
            "ipt_deadline_overruns_total %d" % s.deadline_overruns,
            "# TYPE ipt_streams_total counter",
            "ipt_streams_total %d" % s.streams,
            "# TYPE ipt_stream_chunks_total counter",
            "ipt_stream_chunks_total %d" % s.stream_chunks,
            "# TYPE ipt_stream_bytes_total counter",
            "ipt_stream_bytes_total %d" % s.stream_bytes,
            "# TYPE ipt_scan_rows_total counter",
            "ipt_scan_rows_total %d" % p.rows,
            "# TYPE ipt_scan_bytes_total counter",
            "ipt_scan_bytes_total %d" % p.row_bytes,
            "# TYPE ipt_prefilter_hits_total counter",
            "ipt_prefilter_hits_total %d" % p.prefilter_rule_hits,
            "# TYPE ipt_confirmed_hits_total counter",
            "ipt_confirmed_hits_total %d" % p.confirmed_rule_hits,
            "# TYPE ipt_ruleset_info gauge",
            'ipt_ruleset_info{version="%s",rules="%d"} 1'
            % (pipeline.ruleset.version, pipeline.ruleset.n_rules),
        ]
        # --- learned scoring lane (docs/LEARNED_SCORING.md): whether a
        # head is installed, which one, and the live fixed-vs-learned
        # verdict divergence (the signal a bad model shows FIRST)
        sc = pipeline.scorer
        lines += [
            "# TYPE ipt_scorer_active gauge",
            "ipt_scorer_active %d" % (1 if sc is not None else 0),
        ]
        if sc is not None:
            lines += [
                "# TYPE ipt_scorer_info gauge",
                'ipt_scorer_info{version="%s",coverage="%.4f"} 1'
                % (sc.version, sc.coverage),
                "# TYPE ipt_scorer_threshold gauge",
                "ipt_scorer_threshold %s" % round(sc.threshold, 6),
            ]
        # --- detection-plane telemetry: family-level hit
        # series (bounded cardinality — full per-rule detail is
        # JSON-only at /rules/stats) + device-efficiency gauges
        rs = pipeline.rule_stats
        from ingress_plus_tpu_torch.models.rule_stats import device_efficiency
        from ingress_plus_tpu_torch.utils.trace import bounded_counter_series
        lines.append("# TYPE ipt_scorer_diff_total counter")
        lines += bounded_counter_series(
            "ipt_scorer_diff_total", "kind", dict(p.scorer_diff))
        fams = rs.family_totals()
        lines.append("# TYPE ipt_rule_family_hits_total counter")
        lines += bounded_counter_series(
            "ipt_rule_family_hits_total", "family",
            {f: t["confirmed"] for f, t in fams.items()},
            extra={"version": rs.version})
        lines.append("# TYPE ipt_rule_family_candidates_total counter")
        lines += bounded_counter_series(
            "ipt_rule_family_candidates_total", "family",
            {f: t["candidates"] for f, t in fams.items()},
            extra={"version": rs.version})
        health_dead = int(((rs.candidates > 0) & rs.broken).sum())
        eff = device_efficiency(p)
        lines += [
            "# TYPE ipt_confirm_errors_total counter",
            "ipt_confirm_errors_total{%s} %d"
            % (ver, int(rs.confirm_errors.sum())),
            "# TYPE ipt_rules_runtime_dead gauge",
            "ipt_rules_runtime_dead{%s} %d" % (ver, health_dead),
            "# TYPE ipt_padded_rows_total counter",
            "ipt_padded_rows_total %d" % p.padded_rows,
            "# TYPE ipt_padded_bytes_total counter",
            "ipt_padded_bytes_total %d" % p.padded_bytes,
            # NaN when no dispatch happened yet (post-warmup reset): a
            # literal 0 would read as worst-case fill / perfect waste
            # and fire threshold alerts on every restart
            "# TYPE ipt_pad_waste_ratio gauge",
            "ipt_pad_waste_ratio %s"
            % (eff["padding_waste_ratio"]
               if eff["padding_waste_ratio"] is not None else "NaN"),
            "# TYPE ipt_dispatch_fill gauge",
            "ipt_dispatch_fill %s"
            % (eff["dispatch_fill"]
               if eff["dispatch_fill"] is not None else "NaN"),
            "# TYPE ipt_engine_recompiles_total counter",
            "ipt_engine_recompiles_total %d" % p.engine_compiles,
            # each scan kernel's launches of the serving cycles in this
            # process, not the rollout's admission and shadow work
            # (ops/cuda_build.launch_scope; /debug/kernels?scope=rollout
            # has those); 0 on cpu, where none launches
            "# TYPE ipt_kernel_launches_total counter",
            'ipt_kernel_launches_total{kernel="pair_scan"} %d'
            % PAIR_SCAN.scope_launches(SERVE_SCOPE),
            'ipt_kernel_launches_total{kernel="step_scan"} %d'
            % STEP_SCAN.scope_launches(SERVE_SCOPE),
        ]
        # --- fail-safe serve plane (docs/ROBUSTNESS.md): bounded
        # admission, brownout ladder, dispatch breaker/watchdog
        brk = self.batcher.breaker
        lc = pipeline.load_controller
        brk_state = {"closed": 0, "half_open": 1, "open": 2}.get(
            brk.state, 2)
        lines += [
            "# TYPE ipt_queue_depth gauge",
            "ipt_queue_depth %d" % self.batcher.queue_depth(),
            "# TYPE ipt_degraded_mode gauge",
            "ipt_degraded_mode %d" % lc.level,
            "# TYPE ipt_degraded_verdicts_total counter",
            "ipt_degraded_verdicts_total %d" % p.degraded,
            "# TYPE ipt_breaker_state gauge",
            "ipt_breaker_state %d" % brk_state,
            "# TYPE ipt_breaker_trips_total counter",
            "ipt_breaker_trips_total %d" % brk.trips,
            "# TYPE ipt_watchdog_hangs_total counter",
            "ipt_watchdog_hangs_total %d" % s.hangs,
            "# TYPE ipt_cpu_fallback_batches_total counter",
            "ipt_cpu_fallback_batches_total %d" % s.cpu_fallback_batches,
            "# TYPE ipt_breaker_fail_open_batches_total counter",
            "ipt_breaker_fail_open_batches_total %d"
            % s.breaker_fail_open_batches,
        ]
        # silent-thread-death repair: uncaught worker-thread
        # exceptions by normalized thread name — the runtime counterpart
        # of concheck's lifecycle lint.  Bounded label set: thread-name
        # prefixes are a small closed family (ipt-*).
        from ingress_plus_tpu_torch.utils.trace import (
            debug_locks_enabled,
            lock_registry,
        )
        lines.append("# TYPE ipt_thread_uncaught_total counter")
        lines += bounded_counter_series(
            "ipt_thread_uncaught_total", "thread",
            thread_uncaught_counts())
        if debug_locks_enabled():
            locks = lock_registry.snapshot()
            lines += [
                "# TYPE ipt_lock_order_violations gauge",
                "ipt_lock_order_violations %d"
                % locks["violation_count"],
                "# TYPE ipt_lock_contended_total counter",
                "ipt_lock_contended_total %d" % locks["contended"],
            ]
        # --- per-device lane plane (docs/MESH_SERVING.md): one series
        # per lane, labeled device= — a single-lane server emits
        # device="0" so dashboards are mesh-shape-agnostic.  The
        # unlabeled aggregates above keep their single-lane meaning.
        lane_snaps = self.batcher.lanes.snapshot()
        brk_num = {"closed": 0, "half_open": 1, "open": 2}
        lines.append("# TYPE ipt_lane_count gauge")
        lines.append("ipt_lane_count %d" % len(lane_snaps))
        # labeled twins of metrics whose TYPE lines (and unlabeled
        # aggregates) were emitted above — no duplicate TYPE lines
        for metric, getter in (
                ("ipt_dispatch_fill",
                 lambda ln: (ln["dispatch_fill"]
                             if ln["dispatch_fill"] is not None
                             else "NaN")),
                ("ipt_breaker_state",
                 lambda ln: brk_num.get(ln["breaker"]["state"], 2)),
                ("ipt_breaker_trips_total",
                 lambda ln: ln["breaker"]["trips"]),
                ("ipt_watchdog_hangs_total",
                 lambda ln: ln["hangs"]),
        ):
            for ln in lane_snaps:
                lines.append('%s{device="%s"} %s'
                             % (metric, ln["lane"], getter(ln)))
        for metric, key, mtype in (
                ("ipt_lane_requests_total", "requests", "counter"),
                ("ipt_lane_rows_total", "rows", "counter"),
                ("ipt_lane_errors_total", "errors", "counter"),
                ("ipt_lane_busy_us_sum", "busy_us", "counter"),
        ):
            lines.append("# TYPE %s %s" % (metric, mtype))
            for ln in lane_snaps:
                lines.append('%s{device="%s"} %s'
                             % (metric, ln["lane"], ln[key]))
        lines.append("# TYPE ipt_shed_total counter")
        lines += bounded_counter_series(
            "ipt_shed_total", "reason", dict(p.shed))
        # --- tenant isolation (docs/ROBUSTNESS.md "Tenant isolation"):
        # per-tenant admission counters + guard state, bounded series
        # with the standard "other" fold (tenant="-1" is the guard's
        # tracking-overflow bucket); full per-tenant detail is
        # JSON-only at /tenants, same cardinality policy as /rules/*
        tg = self.batcher.tenant_guard
        # fair-queue depths are guard-INDEPENDENT (--tenant-guard off
        # disables quarantining, not fairness) — the gauge must not
        # vanish on a guard-off deployment
        lines.append("# TYPE ipt_tenant_queue_depth gauge")
        lines += bounded_counter_series(
            "ipt_tenant_queue_depth", "tenant",
            {str(t): d for t, d in self.batcher._q.depths().items()})
        if tg is not None:
            tc = tg.counters()
            lines.append("# TYPE ipt_tenant_admitted_total counter")
            lines += bounded_counter_series(
                "ipt_tenant_admitted_total", "tenant", tc["admitted"])
            lines.append("# TYPE ipt_tenant_shed_total counter")
            lines += bounded_counter_series(
                "ipt_tenant_shed_total", "tenant", tc["shed"])
            lines.append("# TYPE ipt_tenant_degraded_total counter")
            lines += bounded_counter_series(
                "ipt_tenant_degraded_total", "tenant", tc["degraded"])
            brief = tg.brief()
            lines += [
                "# TYPE ipt_tenant_tracked gauge",
                "ipt_tenant_tracked %d" % brief["tracked"],
                "# TYPE ipt_tenant_quarantined gauge",
                "ipt_tenant_quarantined %d" % len(brief["quarantined"]),
                "# TYPE ipt_tenant_quarantines_total counter",
                "ipt_tenant_quarantines_total %d" % brief["quarantines"],
            ]
        lines.append("# TYPE ipt_bucket_rows_total counter")
        # dict() first: atomic copy vs the dispatch thread inserting a
        # new L tier mid-scrape (see rule_stats.device_efficiency)
        lines += bounded_counter_series(
            "ipt_bucket_rows_total", "bucket",
            {str(k): v for k, v in dict(p.bucket_rows).items()})
        # --- guarded rollout (control/rollout.py, docs/ROBUSTNESS.md):
        # state machine gauge + per-phase counters.  Absent entirely
        # when no controller is attached (library batchers).
        ro = self.batcher.rollout
        if ro is not None:
            from ingress_plus_tpu_torch.control.rollout import STATES
            st = ro.status()
            lines += [
                "# TYPE ipt_rollout_state gauge",
                "ipt_rollout_state %d" % STATES.index(st["state"]),
                "# TYPE ipt_rollout_step gauge",
                "ipt_rollout_step %d" % st["step"],
                "# TYPE ipt_rollout_fraction gauge",
                "ipt_rollout_fraction %s" % st["fraction"],
                "# TYPE ipt_rollout_candidate_requests_total counter",
                "ipt_rollout_candidate_requests_total %d"
                % st["candidate_requests"],
                "# TYPE ipt_rollout_shadow_mirrored_total counter",
                "ipt_rollout_shadow_mirrored_total %d"
                % st["shadow"]["mirrored"],
                "# TYPE ipt_rollout_shadow_dropped_total counter",
                "ipt_rollout_shadow_dropped_total %d"
                % st["shadow"]["dropped"],
                "# TYPE ipt_rollout_rollbacks_total counter",
                "ipt_rollout_rollbacks_total %d" % st["rollbacks"],
                "# TYPE ipt_rollout_promotions_total counter",
                "ipt_rollout_promotions_total %d" % st["promotions"],
            ]
            lines.append("# TYPE ipt_rollout_diff_total counter")
            lines += bounded_counter_series(
                "ipt_rollout_diff_total", "kind", st["diff"])
            lines.append("# TYPE ipt_swap_rejected_total counter")
            lines += bounded_counter_series(
                "ipt_swap_rejected_total", "reason", st["swap_rejected"])
        # stage-level latency attribution: one Prometheus
        # histogram per pipeline stage, so p50/p99 per stage are
        # scrapeable without external tooling (the reference gets this
        # from the controller's prometheus histograms + nginx spans)
        lines.append("# TYPE ipt_stage_us histogram")
        for stage, hist in self.batcher.hist.items():
            lines += hist.prometheus("ipt_stage_us", {"stage": stage})
        lines.append("# TYPE ipt_batch_size histogram")
        lines += self.batcher.batch_size_hist.prometheus("ipt_batch_size")
        lines += [
            "# TYPE ipt_prep_us_sum counter",
            "ipt_prep_us_sum %d" % p.prep_us,
            "# TYPE ipt_engine_us_sum counter",
            "ipt_engine_us_sum %d" % p.engine_us,
            "# TYPE ipt_confirm_us_sum counter",
            "ipt_confirm_us_sum %d" % p.confirm_us,
        ]
        # confirm plane (docs/CONFIRM_PLANE.md): pool geometry, wedged-
        # worker shares, flood-memo outcome counters, and the
        # generation-scoped quick-reject totals (they reset at swap
        # like confirm_errors — the version label makes that an honest
        # counter reset)
        pool = pipeline.confirm_pool
        qr = pipeline.rule_stats.quick_reject_summary()
        lines += [
            "# TYPE ipt_confirm_workers gauge",
            "ipt_confirm_workers %d" % pool.n_workers,
            "# TYPE ipt_confirm_workers_replaced_total counter",
            "ipt_confirm_workers_replaced_total %d" % pool.workers_replaced,
            "# TYPE ipt_confirm_hangs_total counter",
            "ipt_confirm_hangs_total %d" % p.confirm_hangs,
            "# TYPE ipt_confirm_memo_hits_total counter",
            "ipt_confirm_memo_hits_total %d" % p.confirm_memo_hits,
            "# TYPE ipt_confirm_memo_misses_total counter",
            "ipt_confirm_memo_misses_total %d" % p.confirm_memo_misses,
            "# TYPE ipt_confirm_quick_reject_total counter",
            'ipt_confirm_quick_reject_total{version="%s"} %d'
            % (pipeline.rule_stats.version, qr["skips"]),
            "# TYPE ipt_confirm_regex_evals_total counter",
            'ipt_confirm_regex_evals_total{version="%s"} %d'
            % (pipeline.rule_stats.version, qr["regex_evals"]),
        ]
        if self.post is not None:
            lines += [
                "# TYPE ipt_post_queue_depth gauge",
                "ipt_post_queue_depth %d" % len(self.post.queue),
                "# TYPE ipt_post_dropped_total counter",
                "ipt_post_dropped_total %d" % self.post.queue.dropped,
                "# TYPE ipt_post_attacks_exported_total counter",
                "ipt_post_attacks_exported_total %d"
                % self.post.exporter.exported_attacks,
                "# TYPE ipt_post_export_errors_total counter",
                "ipt_post_export_errors_total %d"
                % self.post.exporter.export_errors,
                "# TYPE ipt_post_backoff_s gauge",
                "ipt_post_backoff_s %s"
                % round(self.post.exporter.backoff_s, 3),
                "# TYPE ipt_post_spool_dropped_files_total counter",
                "ipt_post_spool_dropped_files_total %d"
                % self.post.exporter.spool_dropped_files,
                "# TYPE ipt_post_spool_dropped_bytes_total counter",
                "ipt_post_spool_dropped_bytes_total %d"
                % self.post.exporter.spool_dropped_bytes,
            ]
        return "\n".join(_with_help(lines)) + "\n"

    def http_get(self, path: str) -> Tuple[str, str, bytes]:
        """Synchronous in-process GET against the observability plane:
        (status, content-type, body) exactly as :meth:`_route_http`
        would serve it over TCP.  The fleet aggregator's in-process
        transport (fleetgate, tests) scrapes through this instead of
        binding N real HTTP ports; runs the route on a private event
        loop, so call it from any thread EXCEPT the serve loop's own."""
        return asyncio.run(self._route_http("GET", path, b""))

    def _scrape_sidecar(self) -> Optional[dict]:
        """One-shot scrape of the sidecar's --status-port JSON (runs in
        an executor thread — never on the event loop).  The per-upstream
        ``ewma_ms`` is the sidecar's own send→verdict stamp (peak-EWMA),
        i.e. the hop this serve loop cannot measure from inside."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                    "http://%s/" % self.sidecar_status, timeout=2) as r:
                st = json.loads(r.read())
        except Exception as e:
            return {"error": "sidecar status unreachable: %s" % e}
        return {
            "note": "per-upstream EWMA of the sidecar hop "
                    "(frame send -> verdict), stamped by the sidecar",
            "upstreams": st.get("upstreams"),
            "pending": st.get("pending"),
            "late_responses": st.get("late_responses"),
        }

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5)
            parts = line.split()
            method = parts[0].decode() if parts else "GET"
            path = parts[1].decode() if len(parts) > 1 else "/"
            clen = 0
            while True:
                h = (await reader.readline()).strip()
                if not h:
                    break
                if h.lower().startswith(b"content-length:"):
                    clen = int(h.split(b":", 1)[1])
            payload = (await reader.readexactly(clen)) if clen else b""
            status, ctype, body = await self._route_http(method, path,
                                                         payload)
            writer.write(
                b"HTTP/1.1 " + status.encode()
                + b"\r\nContent-Type: " + ctype.encode()
                + b"\r\nContent-Length: " + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n" + body)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                IndexError, ValueError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _route_http(self, method: str, path: str, payload: bytes):
        """Observability + dynamic-config plane (the configuration.lua†
        unix-socket endpoint analog — SURVEY.md §3.2 no-reload path).

        Mutating routes run in a worker thread: they contend on the
        batcher's swap lock (held across each in-flight detect) and do
        disk/compile work — blocking the event loop here would freeze
        verdict delivery for every connection."""
        pipeline = self.batcher.pipeline
        loop = asyncio.get_running_loop()
        if path.startswith("/healthz"):
            # LIVENESS only: 200 while the process can answer at all —
            # a browned-out pod must be left alive to recover, not
            # restarted into a cold-compile storm.  Readiness (pull
            # from rotation) is /readyz below.
            s = self.batcher.stats
            return "200 OK", "application/json", json.dumps({
                "status": "ok",
                "uptime_s": round(time.time() - self.started, 1),
                "ruleset": pipeline.ruleset.version,
                "robustness": {
                    "breaker": self.batcher.breaker.snapshot(),
                    "ladder": pipeline.load_controller.snapshot(),
                    "queue_depth": self.batcher.queue_depth(),
                    "queue_cap": self.batcher.queue_cap,
                    "shed": dict(pipeline.stats.shed),
                    "degraded_verdicts": pipeline.stats.degraded,
                    "hangs": s.hangs,
                    "cpu_fallback_batches": s.cpu_fallback_batches,
                    "breaker_fail_open_batches":
                        s.breaker_fail_open_batches,
                    "watchdog_released": s.watchdog_released,
                    # per-device lane plane (docs/MESH_SERVING.md);
                    # `dbg breaker` renders the lane table from here
                    "lanes": self.batcher.lanes.snapshot(),
                    # parallel confirm plane (docs/CONFIRM_PLANE.md):
                    # pool geometry + wedged-worker accounting
                    "confirm_plane": {
                        **pipeline.confirm_pool.snapshot(),
                        "hangs": pipeline.stats.confirm_hangs,
                        "memo_entries": pipeline.confirm_memo_entries,
                        # cross-cycle verdict cache (docs/RETUNE.md)
                        "verdict_cache": (
                            pipeline.confirm_cache.snapshot()
                            if getattr(pipeline, "confirm_cache", None)
                            is not None else None),
                    },
                    # tenant isolation (docs/ROBUSTNESS.md): guard
                    # policy + who is quarantined right now; the full
                    # per-tenant table is /tenants
                    "tenant_guard": (
                        self.batcher.tenant_guard.brief()
                        if self.batcher.tenant_guard is not None
                        else None),
                    # uncaught worker exceptions by thread family —
                    # nonzero here means a thread died that nothing
                    # else surfaced
                    "thread_uncaught": thread_uncaught_counts(),
                    # raw-byte device path: impl + host contract +
                    # backend (cuda/cpu, card name) + lane placement
                    "device_path": self.batcher.device_path_snapshot(),
                },
                # cycle flight recorder: the measured pipeline-overlap
                # brief — scan↔confirm overlap, drain occupancy,
                # critical-path ranking, bounding thread.  null =
                # recorder off or no cycles in the ring yet.
                "pipeline_overlap": self._pipeline_overlap_brief(),
            }).encode()
        if path.startswith("/readyz"):
            # READINESS (docs/ROBUSTNESS.md): unready while the breaker
            # is open/probing or the brownout ladder is above full
            # detection — the k8s service stops routing NEW traffic
            # here while in-flight verdicts still drain (fail-open)
            brk = self.batcher.breaker.snapshot()
            lc = pipeline.load_controller
            reasons = []
            # an OPEN breaker whose cooldown has elapsed (probe_due) or
            # a HALF_OPEN one counts as ready: the canary that would
            # close it can only arrive if traffic routes here again —
            # staying unready would deadlock an out-of-rotation pod.
            # Mesh pools stay ready while ANY lane can serve — one dead
            # card is a capacity event, not a readiness event.
            if not self.batcher.device_available():
                reasons.append("breaker_open")
            if lc.level > 0:
                reasons.append("degraded_%s" % lc.snapshot()["mode"])
            body = json.dumps({
                "ready": not reasons,
                "reasons": reasons,
                "breaker": brk["state"],
                "degraded_mode": lc.level,
            }).encode()
            return (("200 OK" if not reasons
                     else "503 Service Unavailable"),
                    "application/json", body)
        if path.startswith("/faults"):
            # deterministic fault-injection plane (utils/faults.py):
            # GET = the active plan + firing counters; POST {"spec":
            # "...", "seed": N} installs a plan, POST {} clears it
            from ingress_plus_tpu_torch.utils import faults as faults_mod
            if method == "POST":
                try:
                    spec = json.loads(payload or b"{}")
                    if not isinstance(spec, dict):
                        raise ValueError("payload must be a JSON object")
                    if spec.get("spec"):
                        faults_mod.install(faults_mod.FaultPlan.from_spec(
                            str(spec["spec"]),
                            seed=int(spec.get("seed", 0))))
                    else:
                        faults_mod.clear()
                except (ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return ("400 Bad Request", "application/json",
                            json.dumps({"error": str(e)}).encode())
            plan = faults_mod.active()
            return ("200 OK", "application/json", json.dumps({
                "active": plan is not None,
                "plan": plan.snapshot() if plan is not None else None,
            }).encode())
        if path.startswith("/metrics"):
            return ("200 OK", "text/plain; version=0.0.4",
                    self._metrics_text().encode())
        if path.startswith("/traces/request"):
            # post-hoc slow-verdict attribution by wire req_id: the
            # batch's per-stage spans, the slow-ring exemplar when the
            # request was retained there, and (when --sidecar-status is
            # configured) the sidecar hop's per-upstream EWMA timing
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            rid = (q.get("id") or [""])[0]
            if not rid:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": "missing ?id="}).encode())
            batch = self.batcher.traces.find_request(rid)
            exemplar = self.batcher.slow.find_request(rid)
            out = {
                "request_id": rid,
                "found": batch is not None or exemplar is not None,
                "batch": batch,
                "stages": batch["stages"] if batch else None,
                "exemplar": exemplar,
            }
            if self.sidecar_status:
                out["sidecar"] = await loop.run_in_executor(
                    None, self._scrape_sidecar)
            # always 200: it's a query ("was this id seen recently"),
            # and found=false is a meaningful answer (aged out of ring)
            return ("200 OK", "application/json",
                    json.dumps(out).encode())
        if path.startswith("/traces"):
            # recent per-batch span records; ?slowest[=N] sorts by batch_us
            # (request-id attribution for slow verdicts — SURVEY.md §5)
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            if "slowest" in q:
                try:
                    n = int(q["slowest"][0] or 20)
                except ValueError:
                    n = 20
                body = self.batcher.traces.slowest(n)
            else:
                body = self.batcher.traces.snapshot(50)
            return ("200 OK", "application/json",
                    json.dumps({"traces": body}).encode())
        if path.startswith("/debug/trace"):
            # cycle flight recorder (docs/OBSERVABILITY.md "Cycle
            # flight recorder"): Chrome trace-event / Perfetto-loadable
            # JSON of the last N cycles' cross-thread timeline —
            # tid = registered thread root, request flows stitched
            # submit→verdict.  Save the body and load it straight into
            # https://ui.perfetto.dev.  ?cycles=N (default 64).
            from urllib.parse import parse_qs, urlsplit
            from ingress_plus_tpu_torch.utils.trace import flight
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            try:
                n = int((q.get("cycles") or ["64"])[0])
            except ValueError:
                n = 64
            if n <= 0:
                n = 64
            if not flight.enabled:
                return ("200 OK", "application/json", json.dumps(
                    {"enabled": False, "traceEvents": []}).encode())
            body = await loop.run_in_executor(
                None, lambda: json.dumps(flight.chrome_trace(cycles=n)))
            return "200 OK", "application/json", body.encode()
        if path.startswith("/debug/kernels"):
            # each scan kernel's launches in this process by (B, L,
            # carried) with the work their lengths asked for: what a
            # card run re-times at the serve path's own shapes.  The
            # serving cycles' launches (both generations during a
            # canary); ?scope=rollout: the rollout's admission and
            # shadow launches instead; ?scope=autoselect: the startup
            # bake-off's
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            scope = (q.get("scope") or [SERVE_SCOPE])[0]
            body = {k.name: {"launches": k.scope_launches(scope),
                             "shapes": k.shape_snapshot(scope)}
                    for k in (PAIR_SCAN, STEP_SCAN)}
            mesh_info = getattr(self.batcher.pipeline.engine, "mesh_info",
                                None)
            if mesh_info is not None:
                # --mesh: each (data row, model shard) entry's launches
                body["mesh"] = mesh_info()
            return ("200 OK", "application/json", json.dumps(body).encode())
        if path.startswith("/debug/slow"):
            # the K slowest requests since startup: full span breakdown,
            # truncated input sizes, rules hit (exemplar capture)
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            try:
                n = int((q.get("n") or ["32"])[0])
            except ValueError:
                n = 32
            if n <= 0:     # negative would slice from the wrong end
                n = 32
            return ("200 OK", "application/json", json.dumps(
                {"slowest": self.batcher.slow.snapshot(n)}).encode())
        if path.startswith("/wallarm-status"):
            # node counters JSON — the reference module's `/wallarm-status`
            # endpoint that collectd scrapes (SURVEY.md §3.5)
            status = (self.post.status() if self.post is not None
                      else {"postanalytics": "disabled"})
            return ("200 OK", "application/json",
                    json.dumps(status).encode())
        if path.startswith("/tenants"):
            # tenant-isolation view (docs/ROBUSTNESS.md "Tenant
            # isolation"): per-tenant admitted/shed/degraded/queue-
            # depth, guard/quarantine state, and the top offenders via
            # the bounded SpaceSaving sketch.  ?n= caps the per-tenant
            # rows (busiest first); full cardinality never leaves the
            # process — the same policy as /rules/stats.
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            try:
                n = int((q.get("n") or ["64"])[0])
            except ValueError:
                n = 64
            tg = self.batcher.tenant_guard
            depths = self.batcher._q.depths()
            body = {
                "enabled": tg is not None,
                "queue": {
                    "depth": self.batcher.queue_depth(),
                    "cap": self.batcher.queue_cap,
                    "tenant_cap": self.batcher._q.tenant_cap,
                    "active_tenants": len(depths),
                    "depths": {str(t): d
                               for t, d in sorted(depths.items())},
                    "weights": {str(t): w for t, w in
                                sorted(self.batcher._q.weights.items())},
                },
                "guard": tg.snapshot(top=max(n, 1)) if tg is not None
                else None,
                "top_offenders": (tg.top_offenders.items(10)
                                  if tg is not None else []),
                "sketch": (tg.top_offenders.summary()
                           if tg is not None else None),
            }
            return ("200 OK", "application/json",
                    json.dumps(body).encode())
        if path.startswith("/rules/stats"):
            # per-rule runtime accounting — full detail is
            # JSON-only here by the cardinality policy (Prometheus gets
            # the bounded family series).  ?n= caps the rule list
            # (candidates-descending); default is the whole pack.
            from urllib.parse import parse_qs, urlsplit
            from ingress_plus_tpu_torch.models.rule_stats import (
                device_efficiency)
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            try:
                n = int((q.get("n") or ["0"])[0])
            except ValueError:
                n = 0
            rs = pipeline.rule_stats
            if (q.get("format") or [""])[0] == "profile":
                # MeasuredProfile export (docs/RETUNE.md): the content-
                # hashed telemetry artifact a retune feeds back into the
                # compiler — canonical bytes, so the hash an operator
                # records here matches the pack provenance
                from ingress_plus_tpu_torch.compiler.profile import (
                    MeasuredProfile)
                prof = MeasuredProfile.from_rule_stats(rs)
                return ("200 OK", "application/json",
                        prof.to_json().encode())
            cache = getattr(pipeline, "confirm_cache", None)
            body = {
                "version": rs.version,
                "requests": rs.requests,
                "device": pipeline.engine.device_info(),
                "efficiency": device_efficiency(pipeline.stats),
                "verdict_cache": (cache.snapshot()
                                  if cache is not None else None),
                "rules": rs.rules_json(limit=max(n, 0)),
            }
            return ("200 OK", "application/json",
                    json.dumps(body).encode())
        if path.startswith("/rules/health"):
            # runtime dead-rule + false-candidate view: the runtime
            # twin of the static rulecheck audit (docs/ANALYSIS.md) —
            # a rule whose confirm regex fails at runtime surfaces here
            # after its FIRST candidate, not at the next audit
            return ("200 OK", "application/json",
                    json.dumps(pipeline.rule_stats.health()).encode())
        if path.startswith("/scoring") and method == "GET":
            # learned scoring lane (docs/LEARNED_SCORING.md): the
            # installed head (version/threshold/coverage/top weights)
            # and the live fixed-vs-learned divergence counters — the
            # observable that says what the model is actually changing
            sc = pipeline.scorer
            return ("200 OK", "application/json", json.dumps({
                "active": sc is not None,
                "generation": pipeline.generation_tag,
                "anomaly_threshold": pipeline.anomaly_threshold,
                "head": sc.snapshot() if sc is not None else None,
                "diff": dict(pipeline.stats.scorer_diff),
            }).encode())
        if path.startswith("/configuration/scoring") and method == "POST":
            # scoring-head delivery: STAGED by default when a rollout
            # controller is attached (the head rides the same admission
            # → shadow → canary → LIVE gates as a ruleset swap);
            # ?mode=force one-shot installs/clears break-glass style.
            # Payload: {"path": "<artifact>"} or {"clear": true} (force
            # only — "roll out removing the model" has no gate story).
            from urllib.parse import parse_qs, urlsplit
            from ingress_plus_tpu_torch.control.rollout import (
                RolloutRejected,
            )
            from ingress_plus_tpu_torch.learn.head import ScoringHead

            ro = self.batcher.rollout
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            swap_mode = (q.get("mode")
                         or ["staged" if ro is not None else "force"])[0]
            if swap_mode not in ("staged", "force"):
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": "mode must be staged|force"}
                                   ).encode())
            try:
                spec = json.loads(payload or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("payload must be a JSON object")
                clear = bool(spec.get("clear"))
                art = None if clear else str(spec["path"])
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": str(e)}).encode())
            if swap_mode == "staged":
                if ro is None:
                    return ("409 Conflict", "application/json",
                            json.dumps({"error": "staged rollout "
                                        "unavailable: no rollout "
                                        "controller attached "
                                        "(use ?mode=force)"}).encode())
                if clear:
                    return ("400 Bad Request", "application/json",
                            json.dumps({"error": "clear requires "
                                        "?mode=force"}).encode())
                overrides = {k: spec[k]
                             for k in ("steps", "step_min_requests",
                                       "shadow_min_requests",
                                       "shadow_sample") if k in spec}
                try:
                    report = await loop.run_in_executor(
                        None, lambda: ro.admit_scoring(
                            artifact_path=art, overrides=overrides))
                except RolloutRejected as e:
                    return ("422 Unprocessable Entity", "application/json",
                            json.dumps({"rejected": True,
                                        **e.report}).encode())
                except (OSError, ValueError, TypeError) as e:
                    return ("400 Bad Request", "application/json",
                            json.dumps({"error": str(e)}).encode())
                return "200 OK", "application/json", json.dumps(
                    {"staged": True, **report}).encode()

            def _force_install():
                head = None
                if not clear:
                    head = ScoringHead.load(art)
                self.batcher.set_scoring_head(head)
                return head

            try:
                head = await loop.run_in_executor(None, _force_install)
            except Exception as e:
                if ro is not None:
                    ro.count_rejected("scorer_load")
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": "%s: %s"
                                    % (type(e).__name__, e),
                                    "stage": "load"}).encode())
            return "200 OK", "application/json", json.dumps({
                "scoring": (head.version if head is not None else None),
                "mode": "force",
                "generation": self.batcher.pipeline.generation_tag,
            }).encode()
        if path.startswith("/rules/drift"):
            # hit-rate deltas across the most recent hot reload: the
            # outgoing version's counters freeze at swap; rules that
            # went quiet after the reload are flagged once ?min= (or
            # the default floor) of new traffic has accumulated
            from urllib.parse import parse_qs, urlsplit
            from ingress_plus_tpu_torch.models.rule_stats import drift_report
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            try:
                mn = int((q.get("min") or ["100"])[0])
            except ValueError:
                mn = 100
            return ("200 OK", "application/json", json.dumps(
                drift_report(pipeline.frozen_rule_stats,
                             pipeline.rule_stats,
                             min_new_requests=max(mn, 1))).encode())
        if path == "/configuration/tenants" and method == "POST":
            # EP tenant table push: {"<tenant>": ["tag", ...], ...}.
            # Validation is the shared control/sync.py validator — a
            # payload that would silently truncate the mask table
            # (> MAX_TENANTS entries) or silently collapse rows
            # (non-canonical ids like "01") is a structured 4xx, never
            # a partial install.
            from ingress_plus_tpu_torch.control.sync import validate_tenant_tags
            try:
                raw = json.loads(payload or b"{}")
                tags = validate_tenant_tags(raw)
            except (ValueError, TypeError, AttributeError,
                    json.JSONDecodeError) as e:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": str(e)}).encode())
            await loop.run_in_executor(
                None, self.batcher.set_tenant_tags, tags)
            tm = self.batcher.pipeline.tenant_rule_mask
            return "200 OK", "application/json", json.dumps(
                {"tenants": 1 if tm is None else int(tm.shape[0])}).encode()
        if path.startswith("/configuration/ruleset") and method == "POST":
            # ruleset delivery (sync-node† analog).  With a rollout
            # controller attached (the served default) the pack goes
            # through the GUARDED staged rollout — admission gate →
            # shadow → canary ramp → LIVE (docs/ROBUSTNESS.md);
            # ?mode=force keeps the one-shot swap for break-glass (and
            # is the only semantics when no controller is attached).
            from urllib.parse import parse_qs, urlsplit
            from ingress_plus_tpu_torch.compiler.ruleset import (
                CompiledRuleset,
            )
            from ingress_plus_tpu_torch.control.rollout import (
                RolloutRejected,
            )

            ro = self.batcher.rollout
            q = parse_qs(urlsplit(path).query, keep_blank_values=True)
            swap_mode = (q.get("mode")
                         or ["staged" if ro is not None else "force"])[0]
            if swap_mode not in ("staged", "force"):
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": "mode must be staged|force"}
                                   ).encode())
            try:
                spec = json.loads(payload or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("payload must be a JSON object")
                art = str(spec["path"])
                pl = spec.get("paranoia_level")
                pl = int(pl) if pl is not None else None
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": str(e)}).encode())
            if swap_mode == "staged" and ro is None:
                # an EXPLICIT staged request must never silently get the
                # ungated one-shot swap it asked to avoid
                return ("409 Conflict", "application/json",
                        json.dumps({"error": "staged rollout unavailable:"
                                    " no rollout controller attached "
                                    "(use ?mode=force)"}).encode())
            if swap_mode == "staged":
                # per-rollout knob overrides ride the push payload;
                # validated inside admit() AFTER the in-progress check —
                # a rejected concurrent push must not touch the active
                # rollout's config
                overrides = {k: spec[k]
                             for k in ("steps", "step_min_requests",
                                       "shadow_min_requests",
                                       "shadow_sample") if k in spec}

                def _admit():
                    return ro.admit(artifact_path=art, paranoia_level=pl,
                                    overrides=overrides)

                try:
                    report = await loop.run_in_executor(None, _admit)
                except RolloutRejected as e:
                    # a rejected pack changed NOTHING: structured 4xx
                    # (stage, reason, artifact) + ipt_swap_rejected_total
                    return ("422 Unprocessable Entity", "application/json",
                            json.dumps({"rejected": True,
                                        **e.report}).encode())
                except (OSError, ValueError, TypeError) as e:
                    return ("400 Bad Request", "application/json",
                            json.dumps({"error": str(e)}).encode())
                return "200 OK", "application/json", json.dumps(
                    {"staged": True, **report}).encode()

            # force / break-glass: the one-shot swap.  A corrupt or
            # unloadable checkpoint is a structured 4xx rejection (stage
            # "load"), not a generic executor 500, and counts in
            # ipt_swap_rejected_total{reason="load"}
            def _load_and_swap():
                try:
                    cr = CompiledRuleset.load(art)
                except Exception as e:
                    raise RolloutRejected(
                        "load", "load", art,
                        {"error": "%s: %s" % (type(e).__name__, e)})
                self.batcher.swap_ruleset(cr, paranoia_level=pl)
                return cr

            try:
                cr = await loop.run_in_executor(None, _load_and_swap)
            except RolloutRejected as e:
                if ro is not None:
                    ro.count_rejected("load")
                return ("400 Bad Request", "application/json",
                        json.dumps({"rejected": True,
                                    **e.report}).encode())
            except (OSError, ValueError, TypeError) as e:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": str(e),
                                    "stage": "swap"}).encode())
            return "200 OK", "application/json", json.dumps(
                {"ruleset": cr.version, "rules": cr.n_rules,
                 "mode": "force"}).encode()
        if path.startswith("/rollout"):
            # guarded-rollout status / control (docs/ROBUSTNESS.md):
            # GET = full state-machine status; POST {"action":"abort"}
            # rolls an in-flight rollout back to the incumbent
            ro = self.batcher.rollout
            if ro is None:
                return ("200 OK", "application/json",
                        json.dumps({"enabled": False}).encode())
            if method == "POST":
                try:
                    spec = json.loads(payload or b"{}")
                    action = spec.get("action")
                    if action != "abort":
                        raise ValueError("action must be 'abort'")
                except (ValueError, TypeError, AttributeError,
                        json.JSONDecodeError) as e:
                    return ("400 Bad Request", "application/json",
                            json.dumps({"error": str(e)}).encode())
                aborted = await loop.run_in_executor(
                    None, lambda: ro.abort("manual"))
                return ("200 OK", "application/json", json.dumps(
                    {"aborted": aborted, **ro.status()}).encode())
            return ("200 OK", "application/json", json.dumps(
                {"enabled": True, **ro.status()}).encode())
        if path == "/configuration/acl" and method == "POST":
            # wallarm-acl push (no-reload lane): {"acls": {name: {allow:
            # [cidr], deny: [...], greylist: [...]}}, "tenant_acl":
            # {"<tenant>": name}, "default": name}.  Validated fully
            # before the atomic swap — a bad spec changes nothing.
            from ingress_plus_tpu_torch.models.acl import AclError

            def _swap_acls():
                spec = json.loads(payload or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("payload must be a JSON object")
                acl_specs = spec.get("acls", {})
                names = set(acl_specs)
                binding = {int(k): str(v)
                           for k, v in spec.get("tenant_acl", {}).items()}
                default = str(spec.get("default", ""))
                missing = sorted((set(binding.values()) - names)
                                 | ({default} - names if default else set()))
                if missing:   # validate BEFORE any mutation: atomic swap
                    raise ValueError("unknown acl(s) bound: %s" % missing)
                # under the batcher's swap lock: finalize reads the
                # (acl_store, tenant_acl, default_acl) TRIPLE per batch
                # — an executor-thread swap between those reads handed
                # one request a new store with the old bindings
                with self.batcher._swap_lock:
                    loaded = pipeline.acl_store.swap(acl_specs)
                    pipeline.tenant_acl = binding
                    pipeline.default_acl = default
                return loaded

            try:
                names = await loop.run_in_executor(None, _swap_acls)
            except (AclError, ValueError, TypeError, KeyError,
                    json.JSONDecodeError) as e:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": str(e)}).encode())
            return "200 OK", "application/json", json.dumps(
                {"acls": names,
                 "tenant_bindings": len(pipeline.tenant_acl)}).encode()
        if path.startswith("/configuration"):
            # dbg CLI inspection (cmd/dbg† analog)
            tm = pipeline.tenant_rule_mask
            return "200 OK", "application/json", json.dumps({
                "ruleset": pipeline.ruleset.version,
                "rules": pipeline.ruleset.n_rules,
                "mode": pipeline.mode,
                "scan_impl": pipeline.engine.scan_impl,
                "anomaly_threshold": pipeline.anomaly_threshold,
                "tenants": 1 if tm is None else int(tm.shape[0]),
                "acls": pipeline.acl_store.names(),
                "batch": {"max": self.batcher.max_batch,
                          "window_us": int(self.batcher.max_delay_s * 1e6)},
            }).encode()
        return "404 Not Found", "text/plain", b""

    # ------------------------------------------------------- lifecycle

    async def start(self) -> None:
        Path(self.socket_path).unlink(missing_ok=True)
        self._servers.append(await asyncio.start_unix_server(
            self._handle_conn, path=self.socket_path))
        if self.http_port:
            self._servers.append(await asyncio.start_server(
                self._handle_http, host="127.0.0.1", port=self.http_port))

    async def run_forever(self) -> None:
        await self.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        print("serving on %s (http %s), ruleset %s"
              % (self.socket_path, self.http_port or "off",
                 self.batcher.pipeline.ruleset.version), file=sys.stderr)
        await stop.wait()
        for s in self._servers:
            s.close()
        self.batcher.close()
        if self.post is not None:
            self.post.close()


def build_default_batcher(mode: str = "block",
                          rules_dir: Optional[str] = None,
                          max_batch: int = 256,
                          max_delay_s: float = 0.0005,
                          warmup: bool = True,
                          scan_impl: str = "auto",
                          mesh_spec: Optional[str] = None,
                          queue_cap: int = 8192,
                          hard_deadline_s: float = 0.25,
                          hang_budget_s: float = 30.0,
                          breaker_failures: int = 3,
                          breaker_cooldown_s: float = 5.0,
                          lkg_dir: Optional[str] = None,
                          rollout_steps=None,
                          rollout_fail_on: str = "error",
                          n_lanes: int = 1,
                          confirm_workers: int = 1,
                          confirm_cache_entries: int = 0,
                          tenant_queue_cap: int = 0,
                          tenant_weights: Optional[str] = None,
                          tenant_guard: str = "prefilter_only",
                          platform: str = "cuda",
                          scoring_head_path: Optional[str] = None
                          ) -> Batcher:
    """The serving batcher, with its guarded-rollout controller.

    The pack: the last-known-good from ``lkg_dir`` when there is one
    (the last pack that survived traffic — crash-during-rollout
    recovery); else ``rules_dir`` compiled by the port's compiler (a
    tree that does not compile raises); else the committed bundled pack.
    ``platform`` picks the torch device (``cuda``: the card, where the
    engine builds and loads both scan kernels before anything else;
    ``cpu``: the plain scan).  The learned scoring head: the artifact at
    ``scoring_head_path`` when given, else the scorer LKG from
    ``lkg_dir``; one that does not load serves fixed CRS weights, with a
    loud warning.  ``scan_impl`` "auto" runs the startup bake-off
    (``autoselect_scan_impl``) on the live device once the pipeline is
    built, before warmup: every impl the device can run is timed at one
    shape and the fastest is installed (on ``cuda`` ``take``,
    ``pallas``, ``pallas2``, ``pallas3``; on ``cpu`` ``pair``,
    ``take``), and the timings go to stderr as ``scan impl
    auto-select: <impl>  (<impl>=<ms>ms, ...)``; any other value is
    installed as given, unmeasured.  Warmup dispatches run on each
    lane's own worker thread, with its card and stream current.
    ``mesh_spec`` serves the scan over a device mesh
    (parallel/serve_mesh.py): one lane only, ``pallas``/``pallas3``
    mapped to ``pallas2`` (the kernel with a sharded variant), ``auto``
    measuring the sharded impls (``take`` and ``pallas2`` on ``cuda``,
    ``take`` and ``pair`` on ``cpu``)."""
    import os

    from ingress_plus_tpu_torch.control.rollout import (
        RolloutConfig,
        RolloutController,
        load_lkg,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.models.tenant_guard import (
        parse_tenant_weights,
    )
    from ingress_plus_tpu_torch.utils.device import resolve_device
    from ingress_plus_tpu_torch.weights import load_pack

    device = resolve_device(platform)
    # crash recovery (docs/ROBUSTNESS.md "Guarded rollout"): prefer the
    # last-known-good artifact over a possibly mid-rollout rules source.
    # A missing or corrupt LKG falls back to the configured source.
    cr = load_lkg(lkg_dir) if lkg_dir else None
    if cr is not None:
        print("startup: serving last-known-good pack %s from %s"
              % (cr.version, lkg_dir), file=sys.stderr)
    elif rules_dir:
        from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
        from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir

        if not Path(rules_dir).exists():
            raise ValueError("--rules-dir %s does not exist" % rules_dir)
        t0 = time.time()
        try:
            cr = compile_ruleset(load_seclang_dir(rules_dir))
        except Exception as e:
            raise ValueError("--rules-dir %s does not compile: %s: %s"
                             % (rules_dir, type(e).__name__, e)) from e
        print("rules: compiled %s in %.1fs (%d rules, W=%d, version %s)"
              % (rules_dir, time.time() - t0, cr.n_rules,
                 cr.tables.n_words, cr.version), file=sys.stderr)
    else:
        cr = load_pack()
    # n_lanes == 0 is the --lanes auto sentinel: it resolves to a
    # multi-lane pool on a multi-card host, so it counts as multi-lane
    if mesh_spec and n_lanes != 1:
        raise ValueError(
            "--mesh (ruleset sharding, one step over the mesh) and "
            "--lanes (per-device lanes) are different parallelizations "
            "of the same cards — pick one")
    if n_lanes == 0:   # --lanes auto: one lane per local device
        n_lanes = (max(1, torch.cuda.device_count())
                   if device.type == "cuda" else 1)
        print("lane serving: auto -> %d per-device lanes" % n_lanes,
              file=sys.stderr)
    if device.type == "cuda" and n_lanes > torch.cuda.device_count():
        # lanes that share a card only contend for it (two lanes on one
        # H100 served fewer requests than one): one lane per card at most
        raise ValueError("--lanes %d: this host has %d CUDA card(s), and "
                         "lanes do not share a card"
                         % (n_lanes, torch.cuda.device_count()))
    if confirm_workers == 0:   # --confirm-workers auto: one per host core
        confirm_workers = max(1, min(8, os.cpu_count() or 1))
        print("confirm plane: auto -> %d confirm workers"
              % confirm_workers, file=sys.stderr)
    engine = None
    t0 = time.time()
    if mesh_spec:
        from ingress_plus_tpu_torch.parallel.serve_mesh import (
            MeshEngine,
            parse_mesh_spec,
        )
        from ingress_plus_tpu_torch.parallel.shard import check_impl

        if scan_impl in ("pallas", "pallas3"):
            # neither the byte kernel nor the raw-byte configuration has
            # a sharded variant; the class-id pair kernel is their mesh
            # counterpart
            print("mesh serving: --scan-impl %s -> pallas2 (sharded "
                  "variant)" % scan_impl, file=sys.stderr)
            scan_impl = "pallas2"
        if scan_impl != "auto":
            check_impl(scan_impl, device.type)
        engine = MeshEngine(cr, parse_mesh_spec(mesh_spec,
                                                platform=device.type),
                            scan_impl=None if scan_impl == "auto"
                            else scan_impl)
        print("mesh serving: %s over %d devices"
              % (mesh_spec, engine.mesh.size), file=sys.stderr)
    elif scan_impl != "auto":
        # validated against the device before any build (pair = cpu)
        DetectionEngine.check_impl(scan_impl, device)
    pipeline = DetectionPipeline(
        cr, mode=mode, device=device, engine=engine,
        scan_impl=None if scan_impl == "auto" else scan_impl,
        confirm_workers=confirm_workers,
        confirm_cache_entries=confirm_cache_entries)
    if device.type == "cuda":
        print("kernels: built and loaded on %s (%s) in %.1fs"
              % (device, torch.cuda.get_device_name(device),
                 time.time() - t0), file=sys.stderr)
    if scan_impl == "auto":
        # the startup bake-off on the live device picks the serving scan
        # impl; a candidate that fails stops the start
        t0 = time.time()
        timings = pipeline.engine.autoselect_scan_impl()
        print("scan impl auto-select: %s  (%s)  bake-off %.1fs" % (
            pipeline.engine.scan_impl,
            ", ".join("%s=%.5fms" % (k, v * 1e3)
                      for k, v in sorted(timings.items())),
            time.time() - t0), file=sys.stderr)
    else:
        print("scan impl: %s" % pipeline.engine.scan_impl, file=sys.stderr)
    batcher = Batcher(pipeline, max_batch=max_batch, max_delay_s=max_delay_s,
                      hard_deadline_s=hard_deadline_s, queue_cap=queue_cap,
                      hang_budget_s=hang_budget_s,
                      breaker_failures=breaker_failures,
                      breaker_cooldown_s=breaker_cooldown_s,
                      n_lanes=n_lanes,
                      tenant_queue_cap=tenant_queue_cap,
                      tenant_weights=parse_tenant_weights(tenant_weights),
                      tenant_guard=tenant_guard)
    if warmup:
        t0 = time.time()
        if n_lanes <= 1:
            warmup_pipeline(pipeline, max_batch, lane=batcher.lanes.primary,
                            stream_engine=batcher.stream_engine)
            # the warmup corpus is synthetic (20% attacks): drop it from
            # the detection-plane telemetry so /rules/* and the
            # efficiency gauges describe real traffic from request one
            pipeline.reset_detection_observations()
        else:
            # every lane warms on its own worker, concurrently; resets
            # the detection telemetry itself
            batcher.warm_lanes()
        print("warmup: %d lane(s) warmed in %.1fs"
              % (n_lanes, time.time() - t0), file=sys.stderr)
    # learned scoring head (docs/LEARNED_SCORING.md), installed after
    # the warmup so its synthetic traffic counts no scorer divergence:
    # an explicit --scoring-head artifact wins; otherwise the scorer LKG
    # (the last head that survived a staged rollout) restores like the
    # pack LKG.  Either failing to load serves fixed weights — never an
    # outage.
    head = None
    if scoring_head_path:
        from ingress_plus_tpu_torch.learn.head import ScoringHead

        try:
            head = ScoringHead.load(scoring_head_path)
        except Exception as e:
            # the contract holds for the explicit flag too: serving
            # starts on fixed weights, the broken artifact is LOUD
            print("WARNING: --scoring-head %s unloadable (%s: %s) — "
                  "serving FIXED CRS weights"
                  % (scoring_head_path, type(e).__name__, e),
                  file=sys.stderr)
    elif lkg_dir:
        from ingress_plus_tpu_torch.learn.head import load_lkg_scorer

        head = load_lkg_scorer(lkg_dir)
        if head is not None:
            print("startup: restoring last-known-good scoring head %s"
                  % head.version, file=sys.stderr)
    if head is not None:
        pipeline.set_scoring_head(head)
        print("learned scoring: head %s (threshold %.4f, coverage %.3f)"
              % (head.version, pipeline.scorer.threshold,
                 pipeline.scorer.coverage), file=sys.stderr)
    # guarded-rollout controller: idle until an admit; makes STAGED the
    # default semantics of /configuration/ruleset on this server
    cfg = RolloutConfig(fail_on=rollout_fail_on, lkg_dir=lkg_dir)
    if rollout_steps:
        cfg.steps = tuple(rollout_steps)
    batcher.rollout = RolloutController(batcher, cfg)
    return batcher


def warmup_pipeline(pipeline, max_batch: int, lane=None,
                    stream_engine=None) -> None:
    """Dispatch the (B, L, Q) shapes live traffic will hit once before
    serving, so the first real requests pay no first loads (the analog
    of nginx testing its config before swapping workers in).  With
    ``lane``, every dispatch runs on that lane's worker thread (its card
    and stream current, as live dispatches are); with ``stream_engine``,
    one short chunked stream also runs through it there."""
    import dataclasses

    from ingress_plus_tpu_torch.models.pipeline import warm_sizes
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    reqs = [lr.request for lr in generate_corpus(n=max_batch, seed=1)]
    # one size per Q-pad tier — the ONE shared ladder
    # (models/pipeline.warm_sizes)
    sizes = warm_sizes(max_batch)

    def _warm():
        for size in sizes:
            pipeline.detect(reqs[:size])
        # head-sliced twin shapes (docs/SCAN_KERNEL.md): the synthetic
        # corpus carries bodies, so every batch above used the
        # FULL-width tables — bodyless cycles dispatch against the
        # sliced head words.  Only word-tiered packs have the twin.
        if pipeline.engine.head_slicing_active():
            bodyless = [dataclasses.replace(r, body=b"") for r in reqs]
            for size in sizes:
                pipeline.detect(bodyless[:size])
        if stream_engine is not None:
            meta = dataclasses.replace(reqs[0], body=b"",
                                       request_id="warmup-stream")
            st = stream_engine.begin(meta)
            st.base_hits = pipeline.prefilter([meta])[0]
            stream_engine.scan(st.feed(b"a=" + b"x" * 5000))
            stream_engine.scan(st.flush())
            stream_engine.finish(st)

    if lane is not None:
        lane.call(_warm, None)
    else:
        _warm()


def _parse_auto_count(value: str, flag: str) -> int:
    """Shared N|'auto' flag parser (--lanes, --confirm-workers):
    'auto' → the internal 0 sentinel (resolved per flag: one lane per
    local device / one confirm worker per host core); integers must be
    >= 1 — an explicit 0 must not silently collide with the sentinel
    and fan out."""
    if value == "auto":
        return 0
    n = int(value)
    if n < 1:
        raise SystemExit("%s must be >= 1 or 'auto', got %r"
                         % (flag, value))
    return n


def _parse_confirm_workers(value: str) -> int:
    return _parse_auto_count(value, "--confirm-workers")


def _parse_lanes(value: str) -> int:
    return _parse_auto_count(value, "--lanes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="ingress_plus_tpu_torch.serve",
        epilog="--front runs the admission front instead of a node; its "
               "flags: python -m ingress_plus_tpu_torch.serve --front "
               "--help (serve/front.py)")
    ap.add_argument("--socket", default="/tmp/ingress_plus_tpu.sock")
    ap.add_argument("--http-port", type=int, default=9901)
    ap.add_argument("--mode", default="block",
                    choices=["off", "monitoring", "safe_blocking", "block"])
    ap.add_argument("--rules-dir", default=None,
                    help="SecLang rules tree to compile and serve (the "
                         "port's compiler); a tree that does not compile "
                         "fails startup.  Default: the committed bundled "
                         "pack")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-delay-us", type=int, default=500)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="torch device to serve on: cuda (the default; "
                         "startup fails without a card) or cpu (the "
                         "plain scan, for tests and development)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm dispatches (the kernels are still "
                         "built and loaded at startup on cuda)")
    ap.add_argument("--mesh", default=None,
                    help="serve the scan over a device mesh, e.g. "
                         "'data=2,model=4' or '2x4' (DP x TP sharding "
                         "across the cards; parallel/serve_mesh.py); on "
                         "cpu up to 8 entries of the CPU.  Needs "
                         "--lanes 1")
    ap.add_argument("--lanes", default="1",
                    help="data-parallel per-device serve lanes behind "
                         "one admission queue (docs/MESH_SERVING.md): "
                         "an integer lane count, or 'auto' = one lane "
                         "per CUDA card (on cuda at most one lane per "
                         "card).  Each lane gets its own watchdog, "
                         "circuit breaker and CUDA stream; a sick card "
                         "degrades capacity, not the service")
    ap.add_argument("--confirm-workers", default="1",
                    help="parallel confirm plane (docs/CONFIRM_PLANE.md)"
                         ": worker threads the CPU confirm stage shards "
                         "each cycle's requests across — an integer, or "
                         "'auto' = one per host core (capped at 8).  1 "
                         "(default) runs the classic serial confirm "
                         "inline.  A wedged worker fails only its "
                         "request share open; with the mesh loop, "
                         "confirm overlaps the next cycle's scan")
    ap.add_argument("--confirm-cache", type=int, default=0,
                    help="cross-cycle verdict cache entries "
                         "(docs/RETUNE.md): bounded confirm-outcome "
                         "cache keyed (generation, rule, stream "
                         "digest) that survives across batches.  0 "
                         "(default) keeps the per-cycle flood memo only")
    ap.add_argument("--scan-impl", default="auto",
                    choices=["auto", "pair", "take", "pallas", "pallas2",
                             "pallas3"],
                    help="scan implementation: auto = a startup "
                         "bake-off that times every impl the device runs "
                         "and serves the fastest (printed as 'scan impl "
                         "auto-select: ...'); pallas3 = the pair kernel "
                         "on raw bytes, pallas = the per-byte step kernel, "
                         "pallas2 = the pair kernel on class ids; take = "
                         "the per-byte scan on either device (the step "
                         "kernel on cuda, the plain scan on cpu); pair = "
                         "the plain pair scan (cpu)")
    ap.add_argument("--spool-dir", default=None,
                    help="postanalytics spool dir (attacks.jsonl); "
                         "enables the exporter loop")
    ap.add_argument("--export-url", default=None,
                    help="optional HTTP collector for attack export")
    ap.add_argument("--export-interval-s", type=float, default=5.0)
    ap.add_argument("--brute-threshold", type=int, default=25,
                    help="brute: requests per window per "
                         "(tenant, client, auth path); 0 disables the "
                         "rate detectors entirely")
    ap.add_argument("--brute-window-s", type=float, default=60.0)
    ap.add_argument("--dirbust-threshold", type=int, default=50,
                    help="dirbust: distinct paths per window per "
                         "(tenant, client); 0 disables dirbust only")
    ap.add_argument("--dirbust-window-s", type=float, default=60.0)
    ap.add_argument("--artifact-dir", default=None,
                    help="watch this dir for compiled-ruleset artifacts "
                         "and stage them through /configuration/ruleset "
                         "(sync-node analog; needs --http-port)")
    ap.add_argument("--trace-dir", default=None,
                    help="collect a torch.profiler trace (host + CUDA) "
                         "of the serve loop and write it as a Chrome "
                         "trace into this dir at shutdown")
    ap.add_argument("--sidecar-status", default=None,
                    help="host:port of the native sidecar's --status-port"
                         " listener; /traces/request then includes the "
                         "sidecar hop's per-upstream EWMA timing")
    ap.add_argument("--trace-ring-kb", type=int, default=256,
                    help="cycle flight recorder: per-thread event-ring "
                         "byte cap (docs/OBSERVABILITY.md 'Cycle flight "
                         "recorder'); the recorder is always-on and "
                         "allocation-light — this bounds its memory")
    ap.add_argument("--no-flight-recorder", action="store_true",
                    help="disable the cycle flight recorder entirely: "
                         "/debug/trace empties, /healthz "
                         "pipeline_overlap goes null, record() becomes "
                         "one attribute read")
    ap.add_argument("--debug-locks", action="store_true",
                    help="instrument every serve-plane lock "
                         "(docs/ANALYSIS.md 'Concurrency analysis'): "
                         "acquisition-order assertions + contention "
                         "counters at /metrics; debugging aid, not for "
                         "production hot paths")
    # fail-safe serve plane (docs/ROBUSTNESS.md)
    ap.add_argument("--queue-cap", type=int, default=8192,
                    help="bounded admission: max queued items; beyond "
                         "it requests shed fail-open at enqueue")
    ap.add_argument("--hard-deadline-ms", type=int, default=250,
                    help="serve deadline: requests whose queue math "
                         "predicts a miss are shed fail-open at "
                         "enqueue; also derives the brownout ladder "
                         "thresholds")
    ap.add_argument("--hang-budget-ms", type=int, default=30000,
                    help="dispatch watchdog: a device dispatch "
                         "exceeding this fails its batch open and "
                         "trips the circuit breaker")
    ap.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive dispatch errors that open the "
                         "breaker (hangs open it immediately)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="seconds the breaker stays open before a "
                         "half-open canary batch probes the device")
    # tenant isolation (docs/ROBUSTNESS.md "Tenant isolation")
    ap.add_argument("--tenant-queue-cap", type=int, default=0,
                    help="per-tenant admission sub-queue cap (deficit-"
                         "round-robin fair queue); 0 = the global "
                         "--queue-cap (single-tenant behavior "
                         "unchanged).  Beyond it that tenant sheds "
                         "fail-open (reason=tenant_queue_full) while "
                         "other tenants keep admitting")
    ap.add_argument("--tenant-weights", default=None,
                    help="DRR weights per tenant, e.g. '1:4,7:0.5' — a "
                         "weight-2 tenant drains twice the bytes per "
                         "fair-queue round; unlisted tenants weigh 1")
    ap.add_argument("--tenant-guard", default="prefilter_only",
                    choices=["prefilter_only", "fail_open", "off"],
                    help="per-tenant flood guard policy: a tenant "
                         "breaching its admission budget is served "
                         "prefilter-only (degraded, never blocks) or "
                         "shed fail-open; 'off' disables quarantining "
                         "(fair admission still applies)")
    # guarded ruleset rollout (docs/ROBUSTNESS.md "Guarded rollout")
    ap.add_argument("--lkg-dir", default=None,
                    help="last-known-good pack directory: packs that "
                         "reach LIVE are persisted here atomically, and "
                         "startup prefers this artifact over "
                         "--rules-dir (crash-during-rollout recovery)")
    ap.add_argument("--rollout-steps", default="0.01,0.1,0.5,1.0",
                    help="canary ramp fractions for staged ruleset "
                         "rollouts (comma-separated, ending at 1.0)")
    ap.add_argument("--rollout-fail-on", default="error",
                    choices=["error", "warning", "notice", "info"],
                    help="admission static-gate severity: a candidate "
                         "pack with unsuppressed findings at or above "
                         "this level is rejected before touching "
                         "traffic")
    ap.add_argument("--scoring-head", default=None,
                    help="learned scoring-head artifact to serve with "
                         "(learn/; docs/LEARNED_SCORING.md) — overrides "
                         "the scorer LKG; omitted = scorer LKG from "
                         "--lkg-dir, else fixed CRS weights")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault plan, e.g. "
                         "'dispatch_hang:after=100,times=1,delay_s=5'; "
                         "also honored from $IPT_FAULTS "
                         "(utils/faults.py, docs/ROBUSTNESS.md)")
    ap.add_argument("--faults-seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ingress_plus_tpu_torch.utils import faults as faults_mod
    if args.faults:
        faults_mod.install(
            faults_mod.FaultPlan.from_spec(args.faults,
                                           seed=args.faults_seed))
    else:
        faults_mod.install_from_env()

    if args.debug_locks:
        # BEFORE the batcher builds: named_lock() returns instrumented
        # locks only for objects constructed after this point
        from ingress_plus_tpu_torch.utils.trace import enable_debug_locks

        enable_debug_locks(True)

    # cycle flight recorder knobs (docs/OBSERVABILITY.md): configure
    # BEFORE the batcher's threads start so every ring carries the
    # chosen cap and the escape hatch truly zeroes the surface
    from ingress_plus_tpu_torch.utils.trace import flight

    flight.configure(ring_kb=args.trace_ring_kb,
                     enabled=not args.no_flight_recorder)

    try:
        batcher = build_default_batcher(
            mode=args.mode, rules_dir=args.rules_dir,
            max_batch=args.max_batch,
            max_delay_s=args.max_delay_us / 1e6, warmup=not args.no_warmup,
            scan_impl=args.scan_impl, mesh_spec=args.mesh,
            queue_cap=args.queue_cap,
            hard_deadline_s=args.hard_deadline_ms / 1e3,
            hang_budget_s=args.hang_budget_ms / 1e3,
            breaker_failures=args.breaker_failures,
            breaker_cooldown_s=args.breaker_cooldown_s,
            lkg_dir=args.lkg_dir,
            rollout_steps=[float(s) for s in
                           args.rollout_steps.split(",") if s.strip()],
            rollout_fail_on=args.rollout_fail_on,
            n_lanes=_parse_lanes(args.lanes),
            confirm_workers=_parse_confirm_workers(args.confirm_workers),
            confirm_cache_entries=max(0, args.confirm_cache),
            tenant_queue_cap=args.tenant_queue_cap,
            tenant_weights=args.tenant_weights,
            tenant_guard=args.tenant_guard,
            platform=args.platform,
            scoring_head_path=args.scoring_head)
    except (RuntimeError, ValueError) as e:
        # no card, an impl the device cannot run, a kernel that does
        # not build or load, a rules tree that does not compile:
        # refuse to start, never fall back
        raise SystemExit("ingress_plus_tpu_torch.serve: startup failed: %s"
                         % e)

    post = None
    if args.spool_dir or args.export_url:
        from ingress_plus_tpu_torch.post import PostChannel
        from ingress_plus_tpu_torch.post.brute import BruteConfig

        post = PostChannel(
            spool_dir=args.spool_dir,
            http_url=args.export_url,
            interval_s=args.export_interval_s,
            brute=args.brute_threshold > 0,
            brute_config=BruteConfig(
                window_s=args.brute_window_s,
                threshold=args.brute_threshold,
                dirbust_threshold=args.dirbust_threshold,
                dirbust_window_s=args.dirbust_window_s))
        post.start()

    watcher = None
    if args.artifact_dir and args.http_port:
        from ingress_plus_tpu_torch.post import RulesetWatcher

        watcher = RulesetWatcher(args.artifact_dir,
                                 "127.0.0.1:%d" % args.http_port)
        watcher.current_version = batcher.pipeline.ruleset.version
        watcher.start()

    loop = ServeLoop(batcher, args.socket, args.http_port, post=post,
                     sidecar_status=args.sidecar_status)
    from ingress_plus_tpu_torch.utils.trace import profiled
    try:
        with profiled(args.trace_dir):
            asyncio.run(loop.run_forever())
    finally:
        if watcher is not None:
            watcher.close()


if __name__ == "__main__":
    main()
