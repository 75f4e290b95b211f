"""Run a test file of the JAX package against the port.

``ported(name, exclude)`` reads ``tests/<name>.py``, rewrites every
``ingress_plus_tpu`` name to ``ingress_plus_tpu_torch`` and executes the
result as a module of its own.  A ``tests/test_torch_*.py`` file puts the
returned tests and fixtures into its globals, so pytest collects the JAX
package's own cases, unchanged but for the package name, against the
port.  ``exclude`` maps each left-out test to the reason; a name there
that the file no longer defines fails the import, so the list stays true.
``patch`` replaces names in the rewritten module before its tests run
(a twin that also runs the JAX function on the same input, say).

Two more rewrites keep a twin from colliding with its JAX file when both
run at once (``-n 6 --dist loadfile``):

- ``ports``: each fixed TCP port named there is replaced, wherever the
  file spells it, by a free port of this process's choosing;
- a server the file starts (``"-m", "ingress_plus_tpu_torch.serve"``)
  gets ``--http-port 0`` (no HTTP) ahead of its own flags: one started
  without ``--http-port`` would take the default 9901, which its JAX
  file's servers take too; a port the file names after it still wins;
- every unix socket path spelled ``str(<dir> / "<name>.sock")`` goes
  through ``ingress_plus_tpu_torch/utils/uds.py socket_path``, so it fits
  AF_UNIX under any temporary directory.

:func:`native_patch` gives the ``patch`` entries of the front door's test
files: their binaries from the port's build of ``native/``
(``ops/cuda_build.py build_native``), and a ``subprocess`` whose ``make``
builds there, never in ``native/``.
"""

from __future__ import annotations

import re
import socket
import subprocess
import tempfile
import types
from pathlib import Path
from typing import Dict, Iterable, Optional

import pytest
import torch

from ingress_plus_tpu_torch.ops.cuda_build import build_native, native_dir
from ingress_plus_tpu_torch.utils.uds import socket_path

TESTS = Path(__file__).resolve().parent

#: a server's command line in a rewritten file
_SERVE = re.compile(r'("-m", "ingress_plus_tpu_torch\.serve",)')
#: ``str(tmp / "serve.sock")``, ``str(tmp / ("serve%d.sock" % i))``
_SOCKET = re.compile(r'str\((\w+) / (\("[^"]*\.sock" % \w+\)|"[^"]*\.sock")\)')


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs the port's CPU pipeline:
    its plain scan issues many small ops, and under a parallel test run
    the intra-op threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction"))


def free_ports(n: int) -> list:
    """``n`` distinct TCP ports free on 127.0.0.1 just now."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def ported(name: str, exclude: Dict[str, str],
           patch: Optional[Dict[str, object]] = None,
           ports: Iterable[int] = ()) -> Dict[str, object]:
    path = TESTS / (name + ".py")
    src = re.sub(r"\bingress_plus_tpu\b", "ingress_plus_tpu_torch",
                 path.read_text())
    ports = list(ports)
    for fixed, free in zip(ports, free_ports(len(ports))):
        src, n = re.subn(r"\b%d\b" % fixed, str(free), src)
        if not n:
            raise LookupError("%s names no port %d" % (path.name, fixed))
    src = _SERVE.sub(r'\1 "--http-port", "0",', src)
    src = _SOCKET.sub(r"socket_path(\1, \2)", src)
    mod = types.ModuleType("ported_" + name)
    mod.__file__ = str(path)
    mod.socket_path = socket_path
    exec(compile(src, str(path), "exec"), mod.__dict__)
    vars(mod).update(patch or {})
    out = {k: v for k, v in vars(mod).items()
           if (k.startswith("test_") and callable(v)) or _is_fixture(v)}
    missing = sorted(set(exclude) - set(out))
    if missing:
        raise LookupError("%s defines no %s" % (path.name, missing))
    for k in exclude:
        del out[k]
    return out


class _Replay:
    """A child's stderr kept in a file: ``read`` gives all it wrote."""

    def __init__(self, f, text: bool):
        self.f, self.text = f, text

    def read(self):
        self.f.seek(0)
        data = self.f.read()
        return data.decode(errors="replace") if self.text else data

    def close(self):
        self.f.close()


class _Popen(subprocess.Popen):
    """``Popen`` whose ``stderr=PIPE`` is a temporary file: the JAX
    fixtures never read the pipe, and a child that wrote more than a
    pipe holds would block on it.  ``proc.stderr.read()`` still gives
    what the child wrote."""

    def __init__(self, *args, **kw):
        log = None
        if kw.get("stderr") == subprocess.PIPE:
            log = kw["stderr"] = tempfile.TemporaryFile()
        super().__init__(*args, **kw)
        if log is not None:
            self.stderr = _Replay(log, bool(kw.get("text")
                                            or kw.get("universal_newlines")))


#: ``make -C native/<dir> [target]`` as the port builds it
_MAKE = {("sidecar", None): ("sidecar", "loadgen"),
         ("shim", None): ("shim_selftest", "shim_harness"),
         ("shim", "module"): ("ngx_http_detect_tpu_module.o",)}


def _run(cmd, *args, **kw):
    if isinstance(cmd, (list, tuple)) and cmd[:1] == ["make"]:
        rest = list(cmd[1:])
        where = Path(rest[rest.index("-C") + 1]).name
        target = [a for i, a in enumerate(rest)
                  if not a.startswith("-") and rest[i - 1] != "-C"]
        build_native(_MAKE[(where, target[0] if target else None)])
        return subprocess.CompletedProcess(cmd, 0, "", "")
    return subprocess.run(cmd, *args, **kw)


#: the ``subprocess`` a front-door test file sees
NATIVE_SUBPROCESS = types.ModuleType("subprocess")
NATIVE_SUBPROCESS.__dict__.update(
    {k: v for k, v in vars(subprocess).items() if not k.startswith("__")})
NATIVE_SUBPROCESS.Popen = _Popen
NATIVE_SUBPROCESS.run = _run

#: a JAX test file's name for each binary
_BINARIES = {"BIN": "sidecar", "SIDECAR": "sidecar", "LOADGEN": "loadgen",
             "SELFTEST": "shim_selftest", "HARNESS": "shim_harness"}


def native_patch(*names: str) -> Dict[str, object]:
    """``patch`` entries for a front-door test file: each of ``names``
    (``BIN``, ``SIDECAR``, ``LOADGEN``, ``SELFTEST``, ``HARNESS``) the
    path of that binary in the port's build of ``native/`` (built by the
    file's own ``make`` fixture), and ``subprocess`` as
    :data:`NATIVE_SUBPROCESS`."""
    d = native_dir()
    return {"subprocess": NATIVE_SUBPROCESS,
            **{n: d / _BINARIES[n] for n in names}}
