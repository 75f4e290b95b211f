"""Shared admission front: one listener, N detection replicas.

arXiv:1312.4188's parallel-firewall decomposition applied to the serve
plane (docs/SERVING.md "Fleet serving"): the front owns
the sidecar-facing UDS listener and fans request frames across N backend
serve processes over the SAME wire protocol (serve/protocol.py) — the
sidecar cannot tell a front from a node.  Routing is least-loaded among
ready nodes with a per-node in-flight cap; a connect failure retries the
request on a sibling (retry happens ONLY before the frame is written, so
exactly-one-verdict survives); streams and websockets pin their node —
parser state lives there — and fail open if it dies mid-stream.

Degradation is capacity, not service: a dead node is ejected and probed
with exponential backoff, re-admitted only after a half-open canary
request round-trips a real verdict; while nodes are down their share of
traffic rides the survivors, and when EVERY node is down the front
itself synthesizes the fail-open verdict (PAPER.md's Wallarm-node
contract held fleet-wide — the sidecar always gets its RTPI).

The front owns no detection state: it builds no batcher, imports no
kernel and never imports torch, so it creates no CUDA context — its
backends own the cards.

Run:  python -m ingress_plus_tpu_torch.serve --front \
          --backend n0=/tmp/n0.sock@127.0.0.1:9901 \
          --backend n1=/tmp/n1.sock [--socket /tmp/front.sock]
"""

from __future__ import annotations

import asyncio
import json
import signal
import socket as socket_mod
import struct
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.serve.protocol import (
    CHUNK_LAST,
    CHUNK_MAGIC,
    REQ_MAGIC,
    RESP_MAGIC,
    RSCAN_MAGIC,
    WS_END,
    WS_MAGIC,
    FrameReader,
    MultiFrameReader,
    ProtocolError,
    encode_request,
    encode_response,
)
from ingress_plus_tpu_torch.utils import faults

UP = "up"
DOWN = "down"
HALF_OPEN = "half_open"

DEFAULT_INFLIGHT_CAP = 256
BACKOFF_MIN_S = 0.25
BACKOFF_MAX_S = 8.0
CONNECT_TIMEOUT_S = 1.0
CANARY_TIMEOUT_S = 3.0
CANARY_REQ_ID = 0xF0F0F0F0F0F0F0F0  # rides a dedicated connection


def _frame(magic: bytes, payload: bytes) -> bytes:
    return magic + struct.pack("<I", len(payload)) + payload


def _http_ready(target: str, timeout_s: float = 1.0) -> bool:
    """Blocking GET /readyz against ``host:port`` → readiness bool.
    (Runs in an executor thread, never on the front's event loop.)"""
    host, _, port = target.rpartition(":")
    try:
        with socket_mod.create_connection((host or "127.0.0.1", int(port)),
                                          timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            s.sendall(b"GET /readyz HTTP/1.0\r\nConnection: close\r\n\r\n")
            head = s.recv(256)
        parts = head.split(None, 2)
        return len(parts) >= 2 and parts[1] == b"200"
    except Exception:
        return False


@dataclass
class BackendNode:
    """One detection replica behind the front."""

    name: str
    socket_path: str
    readyz: Optional[str] = None            # "host:port" of its HTTP plane
    probe: Optional[Callable[[], bool]] = None   # in-process override
    inflight_cap: int = DEFAULT_INFLIGHT_CAP

    state: str = UP
    inflight: int = 0
    backoff_s: float = BACKOFF_MIN_S
    next_probe: float = 0.0
    last_ready_check: float = 0.0
    eject_reason: str = ""

    forwarded: int = 0
    completed: int = 0
    synth_fail_open: int = 0
    ejections: int = 0
    readmissions: int = 0

    @classmethod
    def parse(cls, spec: str) -> "BackendNode":
        """``NAME=SOCKET[@HOST:PORT]`` → node (the --backend flag)."""
        name, sep, rest = spec.partition("=")
        if not sep or not rest:
            raise ValueError("--backend wants NAME=SOCKET[@HOST:PORT], "
                             "got %r" % spec)
        sock, _, ready = rest.partition("@")
        return cls(name=name, socket_path=sock, readyz=ready or None)

    def ready(self) -> bool:
        """Blocking readiness probe (executor thread)."""
        if self.probe is not None:
            try:
                return bool(self.probe())
            except Exception:
                return False
        if self.readyz:
            return _http_ready(self.readyz)
        return True  # no probe surface: the UDS canary is the only gate


class _Link:
    """One UDS connection front→backend, scoped to ONE client
    connection (req_ids are unique per client connection, so no remap
    table is needed — ownership is the only bookkeeping)."""

    def __init__(self, conn: "_ClientConn", node: BackendNode,
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.conn = conn
        self.node = node
        self.reader = reader
        self.writer = writer
        self.owned: Set[int] = set()   # req_ids awaiting their RTPI
        self.closed = False
        self._relay_task = asyncio.ensure_future(self._relay())

    @classmethod
    async def connect(cls, conn: "_ClientConn",
                      node: BackendNode) -> "_Link":
        faults.raise_if("front_backend_refuse")
        reader, writer = await asyncio.wait_for(
            asyncio.open_unix_connection(node.socket_path),
            timeout=CONNECT_TIMEOUT_S)
        return cls(conn, node, reader, writer)

    async def send(self, frame: bytes) -> None:
        """Forward a raw frame; a write failure kills the link (the
        death path synthesizes fail-open for everything owned, so the
        caller must register ownership BEFORE calling this)."""
        try:
            self.writer.write(frame)
            await self.writer.drain()
        except (ConnectionError, RuntimeError, OSError):
            await self.die()

    async def _relay(self) -> None:
        """Pump verdict frames back to the client verbatim."""
        fr = FrameReader(RESP_MAGIC)
        try:
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    break
                for payload in fr.feed(data):
                    (req_id,) = struct.unpack_from("<Q", payload)
                    self._settle(req_id)
                    await self.conn.send_raw(_frame(RESP_MAGIC, payload))
        except (ConnectionError, ProtocolError, OSError):
            pass
        finally:
            await self.die()

    def _settle(self, req_id: int) -> None:
        if req_id in self.owned:
            self.owned.discard(req_id)
            self.node.inflight = max(0, self.node.inflight - 1)
            self.node.completed += 1
        self.conn.owners.pop(req_id, None)
        self.conn.stream_owner.pop(req_id, None)

    async def die(self) -> None:
        """Link lost: every owned request gets its fail-open verdict
        (exactly one — ownership is dropped as each is synthesized),
        stream/ws pins to this link go dead, and the node is ejected
        unless the client connection is closing gracefully."""
        if self.closed:
            return
        self.closed = True
        try:
            self.writer.close()
        except Exception:
            pass
        if self.conn.links.get(self.node.name) is self:
            self.conn.links.pop(self.node.name, None)
        for rid, link in list(self.conn.stream_owner.items()):
            if link is self:
                self.conn.stream_owner.pop(rid, None)
                self.conn.dead_streams.add(rid)
        for sid, link in list(self.conn.ws_owner.items()):
            if link is self:
                self.conn.ws_owner.pop(sid, None)
                self.conn.dead_ws.add(sid)
        owed = list(self.owned)
        self.owned.clear()
        for req_id in owed:
            self.node.inflight = max(0, self.node.inflight - 1)
            self.node.synth_fail_open += 1
            await self.conn.synth_fail_open(req_id)
        if owed and not self.conn.closing:
            self.conn.front.eject(self.node, "link_lost")

    def cancel(self) -> None:
        self.closed = True
        self._relay_task.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


class _ClientConn:
    """Per-sidecar-connection routing state."""

    def __init__(self, front: "FrontLoop",
                 writer: asyncio.StreamWriter):
        self.front = front
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.links: Dict[str, _Link] = {}          # node name → link
        self.owners: Dict[int, _Link] = {}         # req_id → link
        self.stream_owner: Dict[int, _Link] = {}   # body-stream pins
        self.dead_streams: Set[int] = set()        # pin died; chunks drop
        self.ws_owner: Dict[int, _Link] = {}       # ws stream_id → link
        self.dead_ws: Set[int] = set()             # pin died; fail open
        self.closing = False

    async def send_raw(self, data: bytes) -> None:
        try:
            async with self.write_lock:
                self.writer.write(data)
                await self.writer.drain()
        except (ConnectionError, RuntimeError, OSError):
            pass  # sidecar went away; nothing left to deliver to

    async def synth_fail_open(self, req_id: int) -> None:
        """The front's own verdict: pass + fail_open flag, unscanned.
        Served when no node can take the request or the owning node died
        mid-flight — degradation is capacity, not service."""
        self.owners.pop(req_id, None)
        self.front.fail_open_front_total += 1
        await self.send_raw(encode_response(
            req_id, False, False, True, 0, [], []))

    async def acquire(self, exclude: Set[str]) -> Optional[_Link]:
        """Least-loaded ready link, retrying connect failures on
        siblings.  Returns None when no node can take the request."""
        tried = set(exclude)
        while True:
            node = self.front.pick(tried)
            if node is None:
                return None
            link = self.links.get(node.name)
            if link is not None and not link.closed:
                return link
            try:
                link = await _Link.connect(self, node)
            except (OSError, asyncio.TimeoutError, faults.FaultError):
                self.front.eject(node, "connect_failed")
                self.front.retries_total += 1
                tried.add(node.name)
                continue
            self.links[node.name] = link
            return link

    async def forward(self, link: _Link, node: BackendNode,
                      req_id: int, frame: bytes) -> None:
        link.owned.add(req_id)
        self.owners[req_id] = link
        node.inflight += 1
        node.forwarded += 1
        await link.send(frame)

    # ------------------------------------------------- frame handlers

    async def handle_req(self, kind: str, payload: bytes) -> None:
        """Single-shot request (QTPI) or response-scan (PTPI) — and the
        opening frame of a body stream (MODE_STREAM bit)."""
        if len(payload) < 13:
            return
        (req_id,) = struct.unpack_from("<Q", payload)
        mode = payload[12]
        self.front.requests_total += 1
        link = await self.acquire(set())
        if link is None:
            self.front.note_unrouted()
            await self.synth_fail_open(req_id)
            return
        magic = REQ_MAGIC if kind == "req" else RSCAN_MAGIC
        if kind == "req" and mode & 0x80:   # MODE_STREAM: chunks follow
            self.stream_owner[req_id] = link
        await self.forward(link, link.node, req_id, _frame(magic, payload))

    async def handle_chunk(self, payload: bytes) -> None:
        if len(payload) < 9:
            return
        (req_id,) = struct.unpack_from("<Q", payload)
        last = bool(payload[8] & CHUNK_LAST)
        link = self.stream_owner.get(req_id)
        if link is None or link.closed:
            # pinned node died mid-stream: its fail-open verdict was
            # already synthesized at link death (exactly one); the
            # remaining chunks drain into the void
            if last:
                self.dead_streams.discard(req_id)
            return
        if last:
            self.stream_owner.pop(req_id, None)  # RTPI settles ownership
        await link.send(_frame(CHUNK_MAGIC, payload))

    async def handle_ws(self, payload: bytes) -> None:
        if len(payload) < 22:
            return
        req_id, stream_id = struct.unpack_from("<QQ", payload)
        flags = payload[21]
        self.front.requests_total += 1
        if stream_id in self.dead_ws:
            # parser state died with the pinned node: every later frame
            # of this upgraded connection fails open until it ends
            if flags & WS_END:
                self.dead_ws.discard(stream_id)
            await self.synth_fail_open(req_id)
            return
        link = self.ws_owner.get(stream_id)
        if link is None or link.closed:
            link = await self.acquire(set())
            if link is None:
                self.front.note_unrouted()
                await self.synth_fail_open(req_id)
                return
            self.ws_owner[stream_id] = link
        if flags & WS_END:
            self.ws_owner.pop(stream_id, None)
        await self.forward(link, link.node, req_id,
                           _frame(WS_MAGIC, payload))

    async def close(self) -> None:
        self.closing = True
        for link in list(self.links.values()):
            link.cancel()
        self.links.clear()


class FrontLoop:
    """The listener.  Mirrors ServeLoop's lifecycle so ``serve --front``
    slots into the same supervisor: ``run_forever()`` for the CLI,
    ``start_background()/stop()`` for in-process harnesses (the fleet
    drill, the fault matrix)."""

    def __init__(self, nodes: List[BackendNode], socket_path: str,
                 http_port: int = 0, probe_interval_s: float = 0.5):
        self.nodes = list(nodes)
        self.socket_path = socket_path
        self.http_port = http_port
        self.probe_interval_s = probe_interval_s
        self.started = time.time()
        self.connections = 0
        self.requests_total = 0
        self.retries_total = 0
        self.fail_open_front_total = 0
        self.all_down_served = 0
        self.shed_capacity = 0
        self._servers: list = []
        self._conn_tasks: Set[asyncio.Task] = set()
        self._health_task: Optional[asyncio.Task] = None
        # background-thread harness state
        self._thread: Optional[threading.Thread] = None
        self._thread_loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread_stop: Optional[asyncio.Event] = None

    # ------------------------------------------------- routing policy

    def pick(self, tried: Set[str]) -> Optional[BackendNode]:
        ready = [n for n in self.nodes
                 if n.state == UP and n.name not in tried
                 and n.inflight < n.inflight_cap]
        if not ready:
            if any(n.state == UP and n.name not in tried
                   for n in self.nodes):
                self.shed_capacity += 1   # every ready node at its cap
            return None
        return min(ready, key=lambda n: n.inflight)

    def note_unrouted(self) -> None:
        """No node could take a request: it is a total outage only when
        nothing is UP — pure capacity shedding (every node UP but at
        its cap) is already counted by pick() as shed_capacity."""
        if not any(n.state == UP for n in self.nodes):
            self.all_down_served += 1

    def eject(self, node: BackendNode, reason: str) -> None:
        if node.state == DOWN:
            return
        node.state = DOWN
        node.eject_reason = reason
        node.ejections += 1
        node.backoff_s = BACKOFF_MIN_S
        node.next_probe = time.monotonic() + node.backoff_s

    def _readmit(self, node: BackendNode) -> None:
        node.state = UP
        node.eject_reason = ""
        node.backoff_s = BACKOFF_MIN_S
        node.readmissions += 1

    # ------------------------------------------------- health plane

    async def _canary(self, node: BackendNode) -> bool:
        """Half-open re-admission: one real request over a dedicated
        connection must round-trip a verdict frame."""
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_unix_connection(node.socket_path),
                timeout=CONNECT_TIMEOUT_S)
        except (OSError, asyncio.TimeoutError):
            return False
        try:
            writer.write(encode_request(
                Request(method="GET", uri="/__front_canary"),
                req_id=CANARY_REQ_ID, mode=1))
            await writer.drain()
            fr = FrameReader(RESP_MAGIC)
            deadline = time.monotonic() + CANARY_TIMEOUT_S
            while True:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    return False
                data = await asyncio.wait_for(reader.read(1 << 16),
                                              timeout=budget)
                if not data:
                    return False
                for payload in fr.feed(data):
                    (rid,) = struct.unpack_from("<Q", payload)
                    if rid == CANARY_REQ_ID:
                        return True
        except (OSError, asyncio.TimeoutError, ProtocolError):
            return False
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _health_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = time.monotonic()
            for node in self.nodes:
                if node.state == UP:
                    if (node.probe is None and not node.readyz):
                        continue
                    if now - node.last_ready_check < self.probe_interval_s:
                        continue
                    node.last_ready_check = now
                    ok = await loop.run_in_executor(None, node.ready)
                    if not ok:
                        self.eject(node, "readyz_failed")
                elif node.state == DOWN and now >= node.next_probe:
                    node.state = HALF_OPEN
                    ok = await loop.run_in_executor(None, node.ready)
                    if ok:
                        ok = await self._canary(node)
                    if ok:
                        self._readmit(node)
                    else:
                        node.state = DOWN
                        node.backoff_s = min(node.backoff_s * 2,
                                             BACKOFF_MAX_S)
                        node.next_probe = (time.monotonic()
                                           + node.backoff_s)
            await asyncio.sleep(min(self.probe_interval_s, 0.25))

    # ------------------------------------------------- UDS plane

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        conn = _ClientConn(self, writer)
        frames = MultiFrameReader({REQ_MAGIC: "req", CHUNK_MAGIC: "chunk",
                                   RSCAN_MAGIC: "rscan", WS_MAGIC: "ws"})
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                try:
                    payloads = frames.feed(data)
                except ProtocolError:
                    break
                for kind, payload in payloads:
                    if kind == "chunk":
                        await conn.handle_chunk(payload)
                    elif kind == "ws":
                        await conn.handle_ws(payload)
                    else:
                        await conn.handle_req(kind, payload)
        finally:
            await conn.close()
            try:
                writer.close()
            except Exception:
                pass

    # ------------------------------------------------- HTTP plane

    def status(self) -> dict:
        nodes_up = sum(1 for n in self.nodes if n.state == UP)
        return {
            "role": "front",
            "uptime_s": round(time.time() - self.started, 1),
            "nodes_up": nodes_up,
            "nodes_total": len(self.nodes),
            "connections": self.connections,
            "requests_total": self.requests_total,
            "retries_total": self.retries_total,
            "fail_open_front_total": self.fail_open_front_total,
            "all_down_served": self.all_down_served,
            "shed_capacity": self.shed_capacity,
            "nodes": [{
                "name": n.name,
                "socket": n.socket_path,
                "state": n.state,
                "inflight": n.inflight,
                "inflight_cap": n.inflight_cap,
                "forwarded": n.forwarded,
                "completed": n.completed,
                "synth_fail_open": n.synth_fail_open,
                "ejections": n.ejections,
                "readmissions": n.readmissions,
                "backoff_s": n.backoff_s,
                "eject_reason": n.eject_reason,
            } for n in self.nodes],
        }

    def metrics_text(self) -> str:
        st = self.status()
        lines = []
        for name, val in (
                ("ipt_front_nodes_up", st["nodes_up"]),
                ("ipt_front_requests_total", st["requests_total"]),
                ("ipt_front_retries_total", st["retries_total"]),
                ("ipt_front_fail_open_total",
                 st["fail_open_front_total"]),
                ("ipt_front_all_down_served_total",
                 st["all_down_served"])):
            lines.append("# HELP %s front routing counter" % name)
            lines.append("# TYPE %s %s" % (
                name, "counter" if name.endswith("_total") else "gauge"))
            lines.append("%s %d" % (name, val))
        for n in self.nodes:
            lines.append('ipt_front_node_up{node="%s"} %d'
                         % (n.name, 1 if n.state == UP else 0))
            lines.append('ipt_front_node_inflight{node="%s"} %d'
                         % (n.name, n.inflight))
            lines.append('ipt_front_node_forwarded_total{node="%s"} %d'
                         % (n.name, n.forwarded))
        return "\n".join(lines) + "\n"

    def route_http(self, path: str) -> Tuple[str, str, bytes]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return "200 OK", "text/plain; version=0.0.4", \
                self.metrics_text().encode()
        if path == "/healthz":
            return "200 OK", "application/json", \
                json.dumps(self.status()).encode()
        if path == "/readyz":
            # ready while ANY node serves; with zero nodes the front
            # still answers (fail-open) but advertises not-ready so an
            # LB can prefer a healthier front
            up = any(n.state == UP for n in self.nodes)
            code = "200 OK" if up else "503 Service Unavailable"
            return code, "application/json", json.dumps(
                {"ready": up, "nodes_up":
                 sum(1 for n in self.nodes if n.state == UP)}).encode()
        if path == "/front/nodes":
            return "200 OK", "application/json", \
                json.dumps(self.status()["nodes"]).encode()
        return "404 Not Found", "text/plain", b"not found\n"

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5)
            parts = line.split()
            path = parts[1].decode() if len(parts) > 1 else "/"
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=5)
                if not h.strip():
                    break
            status, ctype, body = self.route_http(path)
            writer.write(("HTTP/1.0 %s\r\nContent-Type: %s\r\n"
                          "Content-Length: %d\r\n\r\n"
                          % (status, ctype, len(body))).encode() + body)
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # ------------------------------------------------- lifecycle

    async def start(self) -> None:
        import pathlib
        pathlib.Path(self.socket_path).unlink(missing_ok=True)
        self._servers.append(await asyncio.start_unix_server(
            self._handle_conn, path=self.socket_path))
        if self.http_port:
            self._servers.append(await asyncio.start_server(
                self._handle_http, host="127.0.0.1", port=self.http_port))
        self._health_task = asyncio.ensure_future(self._health_loop())

    async def _shutdown(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
        for t in list(self._conn_tasks):
            t.cancel()
        for s in self._servers:
            s.close()
        self._servers = []
        await asyncio.sleep(0)  # let cancellations unwind their finallys

    async def run_forever(self) -> None:
        await self.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        print("front on %s (http %s), %d backends"
              % (self.socket_path, self.http_port or "off",
                 len(self.nodes)), file=sys.stderr)
        await stop.wait()
        await self._shutdown()

    # in-process harness lifecycle (fleet drill / fault matrix)

    def start_background(self) -> None:
        ready = threading.Event()

        def _run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._thread_loop = loop
            stop = asyncio.Event()
            self._thread_stop = stop

            async def _main() -> None:
                await self.start()
                ready.set()
                await stop.wait()
                await self._shutdown()

            try:
                loop.run_until_complete(_main())
            finally:
                try:
                    loop.run_until_complete(
                        loop.shutdown_asyncgens())
                except Exception:
                    pass
                loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="front-loop")
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError("front failed to start on %s"
                               % self.socket_path)

    def stop(self) -> None:
        loop, stop = self._thread_loop, self._thread_stop
        if loop is not None and stop is not None:
            try:
                loop.call_soon_threadsafe(stop.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def main(argv=None) -> None:
    """``python -m ingress_plus_tpu_torch.serve --front``: the listener,
    the routing table and the health prober, nothing else.  The serve
    CLI's detection-node flags are accepted and ignored, as the front
    builds no batcher."""
    import argparse

    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.serve --front")
    ap.add_argument("--front", action="store_true",
                    help="run as the shared admission front instead of "
                         "a detection node: fan requests across the "
                         "--backend replicas over the same UDS protocol. "
                         "No batcher is built, no kernel is loaded")
    ap.add_argument("--socket", default="/tmp/ingress_plus_tpu.sock")
    ap.add_argument("--http-port", type=int, default=9901)
    ap.add_argument("--backend", action="append", default=[],
                    metavar="NAME=SOCKET[@HOST:PORT]",
                    help="one detection replica behind --front: its UDS "
                         "socket plus optionally its HTTP plane "
                         "(host:port) for /readyz probing; repeatable")
    ap.add_argument("--front-inflight-cap", type=int, default=None,
                    help="per-node in-flight request cap at the front "
                         "(default %d)" % DEFAULT_INFLIGHT_CAP)
    ap.add_argument("--probe-interval-s", type=float, default=0.5,
                    help="front health-probe cadence for /readyz checks "
                         "and down-node backoff ticks")
    ap.add_argument("--faults", default=None)
    ap.add_argument("--faults-seed", type=int, default=0)
    args, _node_flags = ap.parse_known_args(argv)
    if args.faults:
        faults.install(faults.FaultPlan.from_spec(args.faults,
                                                  seed=args.faults_seed))
    else:
        faults.install_from_env()
    if not args.backend:
        ap.error("--front requires at least one --backend")
    try:
        nodes = [BackendNode.parse(spec) for spec in args.backend]
    except ValueError as e:
        ap.error(str(e))
    if args.front_inflight_cap:
        for n in nodes:
            n.inflight_cap = args.front_inflight_cap
    front = FrontLoop(nodes, args.socket, args.http_port,
                      probe_interval_s=args.probe_interval_s)
    asyncio.run(front.run_forever())
