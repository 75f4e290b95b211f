"""The system under test as the benchmark runs it: ``python -m
ingress_plus_tpu_torch.serve`` in a process of its own, with the
configuration's flags, its socket, spool and trace under the run's
directory, and an HTTP port that is free."""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional

from wafbench.manifest import ROOT

#: the socket's name, bound relative to the run directory (the server's
#: working directory), so a long TMPDIR never exceeds AF_UNIX's limit
SOCKET = "s.sock"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: prctl(2), resolved before any fork so that a child only calls it
_PRCTL = ctypes.CDLL(None, use_errno=True).prctl
PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """``preexec_fn`` of every child the benchmark starts: the kernel
    kills the child when the benchmark's process ends, however it
    ends, so no child outlives a run."""
    _PRCTL(PR_SET_PDEATHSIG, signal.SIGKILL)


def child_env() -> Dict[str, str]:
    """The environment of the benchmark's children: the checkout on the
    import path; no JAX backend for a library that would load one."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"
    # kernel caches at fixed paths inside the checkout (the port builds
    # its own kernels into ingress_plus_tpu_torch/build/)
    build = ROOT / "ingress_plus_tpu_torch" / "build"
    env["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(build / "triton")
    return env


class Server:
    def __init__(self, run_dir: Path, flags: List[str], trace: bool,
                 extra: List[str] = (), env: Optional[Dict[str, str]] = None):
        self.run_dir = run_dir
        self.port = free_port()
        self.trace_dir = run_dir / "trace" if trace else None
        argv = [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
                "--socket", SOCKET, "--http-port", str(self.port),
                *flags, "--spool-dir", str(run_dir / "spool"), *extra]
        if self.trace_dir is not None:
            argv += ["--trace-dir", str(self.trace_dir)]
        self.log_path = run_dir / "server.log"
        self._log = open(self.log_path, "wb")
        penv = child_env()
        penv.update(env or {})
        self.proc = subprocess.Popen(argv, cwd=run_dir, env=penv,
                                     stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     preexec_fn=die_with_parent)

    def get(self, path: str, timeout: float = 10.0) -> bytes:
        url = "http://127.0.0.1:%d%s" % (self.port, path)
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()

    def wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError("the server exited with %s before it was "
                                   "ready:\n%s" % (self.proc.returncode,
                                                   self.log_tail()))
            try:
                self.get("/readyz", timeout=2.0)
                return
            except (urllib.error.URLError, OSError):
                time.sleep(0.1)
        raise RuntimeError("the server was not ready in %.0f s" % timeout)

    def counters(self) -> Dict[str, float]:
        """The unlabelled series of ``/metrics``, by name."""
        out: Dict[str, float] = {}
        for line in self.get("/metrics").decode().splitlines():
            if not line or line[0] == "#":
                continue
            name, _, value = line.rpartition(" ")
            if "{" in name:
                continue
            try:
                out[name] = float(value)
            except ValueError:
                pass
        return out

    def log_tail(self, n: int = 4000) -> str:
        self._log.flush()
        data = self.log_path.read_bytes()
        return data[-n:].decode("utf-8", "replace")

    def stop(self, timeout: float = 180.0) -> Optional[Path]:
        """SIGTERM, wait (the profiler writes its trace on the way out),
        SIGKILL past ``timeout``.  Returns the trace file, if any."""
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
                self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
        self._log.close()
        if self.trace_dir is None or not self.trace_dir.is_dir():
            return None
        traces = sorted(self.trace_dir.glob("serve-*.json"))
        return traces[-1] if traces else None
