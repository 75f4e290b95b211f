"""The device's side of a traced run, from the server's own
``torch.profiler`` Chrome trace (``--trace-dir``): the measured window
cut out by time, what ran on the card in it, and where the card sat
idle.

An event's time is ``baseTimeNanoseconds / 1000 + ts`` microseconds of
the Unix epoch (a trace without the base key holds absolute times), the
clock the client records the window in."""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

#: trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the port's scan kernels (``csrc/pair_scan.cu``, ``csrc/step_scan.cu``)
SCAN_KERNELS = ("pair_scan_kernel", "step_scan_kernel")
#: trace categories of host work that can name an idle gap: torch ops
#: (on threads the profiler saw start) and the CUDA runtime and driver
#: calls of every thread
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
#: characters of an operation's name the breakdown keeps
NAME_CHARS = 160


@dataclass
class DeviceWindow:
    window_s: float
    busy_s: float
    #: device seconds by operation name, clipped to the window
    by_name: Dict[str, float] = field(default_factory=dict)
    #: device seconds of the scan kernels in the window
    scan_s: float = 0.0
    scan_launches: int = 0
    #: the longest idle gaps: (the innermost host op at the gap's middle,
    #: else "after" the last host op that ended before that, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        """The ten operations with the most device time (names cut to
        :data:`NAME_CHARS`) and the ten longest idle gaps."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_window(path: Path, t0_us: float, t1_us: float) -> DeviceWindow:
    """Cut ``[t0_us, t1_us]`` (Unix-epoch microseconds) out of the trace
    at ``path``."""
    trace = json.loads(Path(path).read_text())
    base = trace.get("baseTimeNanoseconds", 0) / 1000.0
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    win = DeviceWindow(window_s=(t1_us - t0_us) / 1e6, busy_s=0.0)
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = base + float(e["ts"])
        b = a + float(e["dur"])
        if b <= t0_us or a >= t1_us:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, t0_us), min(b, t1_us)
            dev.append((a, b))
            name = e.get("name", "?")
            win.by_name[name] = win.by_name.get(name, 0.0) + (b - a) / 1e6
            if any(k in name for k in SCAN_KERNELS):
                win.scan_s += (b - a) / 1e6
                win.scan_launches += 1
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "?")))
    busy = _union(dev)
    win.busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [t0_us] + [x for ab in busy for x in ab] + [t1_us]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k])
                   for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]), reverse=True)[:10]
    ends = sorted((b, n) for _a, b, n in host)
    for length, start in gaps:
        mid = start + length / 2
        spans = [(b - a, n) for a, b, n in host if a <= mid <= b]
        if spans:
            label = min(spans)[1]
        else:
            # no profiled op spans it (the host ran Python: confirm,
            # prep, the serve loop): name the last op that ended before
            # the gap's middle
            k = bisect.bisect_right(ends, (mid, "\uffff"))
            label = ("after " + ends[k - 1][1] if k
                     else "(no profiled host op)")
        win.gaps.append((label, length / 1e6))
    return win
