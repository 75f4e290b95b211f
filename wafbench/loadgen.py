"""The benchmark's client, a process of its own: it sends a mix's units
to the serving entry's socket and records each verdict.

Run as ``python -m wafbench.loadgen --mix M --seed N --seconds S
--socket PATH --out FILE``.  It builds the first units while the server
starts, prints ``ready``, and waits for ``go <t>`` on standard input:
``t`` is the monotonic clock's second at which the warm-up starts.  The
mix's ``warmup`` is ``{"seconds": W}`` (its own load for W seconds) or
``{"units": N}`` (a closed-loop burst of N units).  It prints ``open
<t>`` as soon as the window's opening is known; the window closes ``S``
seconds after it; no unit is sent after the close, and the verdicts
still in flight are awaited for up to :data:`DRAIN_S` seconds.  Then it
writes its record (a pickle) to FILE and prints ``done``.

One thread, non-blocking sockets and ``select``: a unit's frames go into
its connection's send buffer the moment it is sent, and its verdict is
read as soon as it arrives.  The loop is closed: each connection keeps
its ``in_flight`` units outstanding, and a unit is timed from when it
was sent.
"""

from __future__ import annotations

import argparse
import json
import pickle
import select
import socket
import sys
import time
from typing import Dict, List, Optional


from wafbench.gen import Traffic, load_mix
from wafbench.wire import VerdictReader

#: seconds past the window's close a verdict is still awaited
DRAIN_S = 60.0


class Conn:
    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.sock.setblocking(False)
        self.out = bytearray()
        self.reader = VerdictReader()
        self.in_flight = 0

    def fileno(self) -> int:
        return self.sock.fileno()

    def flush(self) -> None:
        while self.out:
            try:
                n = self.sock.send(self.out[:1 << 20])
            except BlockingIOError:
                return
            del self.out[:n]


class Record:
    """What a run sent and got back.  Times are ``time.perf_counter``
    seconds (the system's monotonic clock, shared by every process)."""

    def __init__(self, mix: dict, seed: int, seconds: float):
        self.mix = mix
        self.seed = seed
        self.seconds = seconds
        self.t_start = 0.0          # warm-up starts
        self.t_open = 0.0           # the window opens
        self.t_close = 0.0          # the window closes
        self.wall_minus_mono = 0.0  # time.time() - perf_counter()
        self.req_id: List[int] = []
        self.t_sent: List[float] = []
        self.t_done: Dict[int, float] = {}
        self.verdict: Dict[int, dict] = {}
        self.body_bytes: List[int] = []
        self.error: Optional[str] = None


def run(path: str, traffic: Traffic, rec: Record, announce) -> None:
    """Send the mix until the window closes and its verdicts are in.
    ``announce(t_open)`` is called once the window's opening is known."""
    mix = traffic.mix
    load = mix["load"]
    warm = mix["warmup"]
    if load["loop"] != "closed":
        raise ValueError("unknown load loop %r" % load["loop"])
    n_conn = int(load["connections"])
    conns = [Conn(path) for _ in range(n_conn)]
    owner: Dict[int, Conn] = {}
    t_start = rec.t_start
    warm_units = int(warm.get("units", 0))
    in_flight = int(load["in_flight"])
    stagger = float(load.get("stagger_s", 0.0))
    i = 0
    outstanding = 0
    t_open = t_close = float("inf")

    def open_at(t: float) -> None:
        nonlocal t_open, t_close
        t_open, t_close = t, t + rec.seconds
        rec.t_open, rec.t_close = t_open, t_close
        announce(t_open)

    if not warm_units:
        open_at(t_start + float(warm["seconds"]))

    def send(conn: Conn) -> None:
        nonlocal i, outstanding
        u = traffic.unit(i)
        i += 1
        now = time.perf_counter()
        conn.out += b"".join(u.frames)
        conn.in_flight += 1
        owner[u.req_id] = conn
        outstanding += 1
        rec.req_id.append(u.req_id)
        rec.t_sent.append(now)
        rec.body_bytes.append(u.body_bytes)
        conn.flush()

    warming = warm_units > 0
    while True:
        now = time.perf_counter()
        if warming:
            # a closed-loop burst of warm_units units brings the server
            # to its steady state; then the mix's own load takes over
            for c in conns:
                while c.in_flight < in_flight and i < warm_units:
                    send(c)
            # a server that stops answering never finishes the burst:
            # the window opens after DRAIN_S regardless
            if i >= warm_units or now > t_start + DRAIN_S:
                warming = False
                open_at(now)
        elif now < t_close:
            for k, c in enumerate(conns):
                if now < t_start + k * stagger:
                    continue
                while c.in_flight < in_flight:
                    send(c)
        elif outstanding == 0 or now > t_close + DRAIN_S:
            break
        for c in conns:
            c.flush()
        writers = [c for c in conns if c.out]
        readable, _, _ = select.select(conns, writers, [], 0.05)
        for c in readable:
            try:
                data = c.sock.recv(1 << 20)
            except BlockingIOError:
                continue
            if not data:
                raise ConnectionError("the server closed a connection")
            t = time.perf_counter()
            for v in c.reader.feed(data):
                rid = v["req_id"]
                if rid in rec.t_done or rid not in owner:
                    raise ValueError("an unexpected verdict for %d" % rid)
                rec.t_done[rid] = t
                rec.verdict[rid] = v
                owner.pop(rid).in_flight -= 1
                outstanding -= 1
    for c in conns:
        c.sock.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wafbench.loadgen")
    ap.add_argument("--mix", required=True,
                    help="a mix's name, or the path of its .json file")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--socket", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pregen", type=int, default=0,
                    help="units to build before 'ready'")
    args = ap.parse_args(argv)
    mix = (json.loads(open(args.mix).read()) if args.mix.endswith(".json")
           else load_mix(args.mix))
    traffic = Traffic(mix, args.seed)
    if args.pregen:
        traffic.unit(args.pregen - 1)
    rec = Record(mix, args.seed, args.seconds)
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 2
    rec.t_start = float(line[1])
    rec.wall_minus_mono = time.time() - time.perf_counter()
    delay = rec.t_start - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    def announce(t_open: float) -> None:
        print("open %r" % t_open, flush=True)

    try:
        run(args.socket, traffic, rec, announce)
    except (OSError, ValueError) as e:
        rec.error = "%s: %s" % (type(e).__name__, e)
    with open(args.out, "wb") as f:
        pickle.dump(rec.__dict__, f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
