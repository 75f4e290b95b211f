"""A UDS wire-protocol client: pipelined units over several connections.

A *unit* is one request's frames — a request frame, or a streaming
request frame followed by its chunk frames — and gets exactly one
response frame, correlated by ``req_id``.  :func:`drive` spreads units
round robin over ``connections`` sockets; each connection keeps up to
``window`` units in flight (their frames written back to back, responses
read as they arrive, in any order) and records each unit's latency from
its first frame written to its response read.

The serve loop's tests and the card smoke run drive servers through
this; nginx's sidecar speaks the same frames from C++.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Sequence, Tuple

from ingress_plus_tpu_torch.serve.protocol import (
    RESP_MAGIC,
    MultiFrameReader,
    decode_response,
)

#: one request's frames: (req_id, [frame bytes, ...])
Unit = Tuple[int, Sequence[bytes]]


def _run_connection(path: str, units: Sequence[Unit], window: int,
                    timeout: float, out: Dict[int, tuple],
                    errors: List[BaseException]) -> None:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    slots = threading.Semaphore(window)
    sent: Dict[int, float] = {}
    lock = threading.Lock()
    n_want = len(units)

    def _send():
        try:
            for req_id, frames in units:
                if not slots.acquire(timeout=timeout):
                    raise TimeoutError("no response within %.0fs" % timeout)
                with lock:
                    sent[req_id] = time.perf_counter()
                sock.sendall(b"".join(frames))
        except BaseException as e:  # noqa: BLE001 — reported by drive()
            errors.append(e)

    try:
        sock.connect(path)
        sender = threading.Thread(target=_send, daemon=True,
                                  name="ipt-wire-send")
        sender.start()
        reader = MultiFrameReader({RESP_MAGIC: "resp"})
        got = 0
        while got < n_want and not errors:
            data = sock.recv(1 << 16)
            if not data:
                raise ConnectionError("server closed the connection")
            t = time.perf_counter()
            for _kind, payload in reader.feed(data):
                resp = decode_response(payload)
                with lock:
                    t0 = sent.pop(resp["req_id"])
                out[resp["req_id"]] = (resp, t - t0)
                got += 1
                slots.release()
        sender.join(timeout=timeout)
    except BaseException as e:  # noqa: BLE001 — reported by drive()
        errors.append(e)
    finally:
        sock.close()


def drive(path: str, units: Sequence[Unit], connections: int = 4,
          window: int = 32, timeout: float = 120.0
          ) -> Dict[int, Tuple[dict, float]]:
    """Send every unit and return ``{req_id: (decoded response, latency
    seconds)}``; raises the first connection error (a socket timeout
    after ``timeout`` seconds without progress included)."""
    out: Dict[int, tuple] = {}
    errors: List[BaseException] = []
    shards = [list(units[i::connections]) for i in range(connections)]
    threads = [threading.Thread(target=_run_connection,
                                args=(path, s, window, timeout, out, errors),
                                daemon=True, name="ipt-wire-conn")
               for s in shards if s]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout * 4)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise TimeoutError("a connection did not finish")
    return out
