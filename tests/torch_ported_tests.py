"""Run a test file of the JAX package against the port.

``ported(name, exclude)`` reads ``tests/<name>.py``, rewrites every
``ingress_plus_tpu`` name to ``ingress_plus_tpu_torch`` and executes the
result as a module of its own.  A ``tests/test_torch_*.py`` file puts the
returned tests and fixtures into its globals, so pytest collects the JAX
package's own cases, unchanged but for the package name, against the
port.  ``exclude`` maps each left-out test to the reason; a name there
that the file no longer defines fails the import, so the list stays true.
``patch`` replaces names in the rewritten module before its tests run
(a twin that also runs the JAX function on the same input, say).  A
``patch`` module under a name the file binds nowhere at its top level is
one the file imports inside a test (``import retune as rt``): it stands
in ``sys.modules`` under that name while the module's tests run.

``device`` is where the port runs while the module's tests do (``"cpu"``
here; ``chip_smoke.py`` phase 18 passes ``"cuda"``).  The port's entry
points default to the card, and a JAX test file constructs them without
a device: by a top-level name, by a function-local import, or inside a
library helper of the port (``utils/prefilter_gate.py run_gate``,
``serve/server.py build_default_batcher``).  A module-scoped autouse
fixture (:class:`DeviceDefault`) reaches all three: while the file's
fixtures and tests run, every ``resolve_device`` the port's modules hold
takes ``None`` to mean ``device``, and every function of the port whose
``platform``, ``device`` or ``device_type`` parameter defaults to
``"cuda"`` defaults to ``device`` instead.  A twin file's own
hand-written tests see the port as it is, and so does everything once
the module's tests end: the port's source is not changed.

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

import contextlib
import functools
import importlib
import pkgutil
import re
import socket
import subprocess
import sys
import tempfile
import types
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

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


#: the parameters whose ``"cuda"`` default :class:`DeviceDefault` moves
_DEVICE_PARAMS = ("platform", "device", "device_type")
_PACKAGE = "ingress_plus_tpu_torch"


@functools.lru_cache(maxsize=None)
def _import_port() -> None:
    """Import every module of the port (``__main__`` modules aside): one
    a test first imports inside a function must already hold the
    rebound names."""
    import ingress_plus_tpu_torch as pkg

    for m in pkgutil.walk_packages(pkg.__path__, _PACKAGE + "."):
        if not m.name.endswith(".__main__"):
            importlib.import_module(m.name)


def _port_modules() -> list:
    """The port's modules, every one imported."""
    _import_port()
    return [m for k, m in list(sys.modules.items())
            if m is not None and (k == _PACKAGE
                                  or k.startswith(_PACKAGE + "."))]


def _functions(modules) -> Iterator:
    """The functions and methods the port's ``modules`` define."""
    for mod in modules:
        for v in vars(mod).values():
            if getattr(v, "__module__", None) != mod.__name__:
                continue
            if isinstance(v, types.FunctionType):
                yield v
            elif isinstance(v, type):
                for a in vars(v).values():
                    a = getattr(a, "__func__", a)
                    if isinstance(a, types.FunctionType):
                        yield a


def _moved_defaults(fn, dev: str):
    """``fn``'s (``__defaults__``, ``__kwdefaults__``) with each
    ``"cuda"`` default of a device parameter replaced by ``dev``, or
    None where there is none."""
    code = fn.__code__
    pos = code.co_varnames[:code.co_argcount]
    d = fn.__defaults__ or ()
    names = pos[len(pos) - len(d):]
    new_d = tuple(dev if n in _DEVICE_PARAMS and v == "cuda" else v
                  for n, v in zip(names, d))
    kw = fn.__kwdefaults__
    new_kw = kw and {n: dev if n in _DEVICE_PARAMS and v == "cuda" else v
                     for n, v in kw.items()}
    if new_d == d and new_kw == kw:
        return None
    return new_d or None, new_kw


class DeviceDefault:
    """The port's device default moved to ``device`` (the module
    docstring) while it is on: ``with DeviceDefault(d):``, and
    :meth:`set` ``(False)`` / ``(True)`` to put the port back for a
    while and move it again."""

    def __init__(self, device: str):
        from ingress_plus_tpu_torch.utils import device as device_mod

        self.original = original = device_mod.resolve_device

        def resolve_device(dev=None):
            return original(device if dev is None else dev)

        self.moved = resolve_device
        dev_type = torch.device(device).type
        #: fn -> (its defaults, the moved ones)
        self.defaults = {}
        for fn in _functions(_port_modules()):
            new = _moved_defaults(fn, dev_type)
            if new is not None:
                self.defaults[fn] = (fn.__defaults__, fn.__kwdefaults__), new
        self.on = False

    def set(self, on: bool) -> None:
        if on == self.on:
            return
        old, new = ((self.original, self.moved) if on
                    else (self.moved, self.original))
        for mod in _port_modules():
            for k, v in list(vars(mod).items()):
                if v is old:
                    setattr(mod, k, new)
        for fn, pair in self.defaults.items():
            fn.__defaults__, fn.__kwdefaults__ = pair[on]
        self.on = on

    def __enter__(self):
        self.set(True)
        return self

    def __exit__(self, *exc):
        self.set(False)


@contextlib.contextmanager
def in_sys_modules(modules: Dict[str, types.ModuleType]):
    """Each of ``modules`` importable under its key inside the block."""
    saved = {k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k, m in saved.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m


def _device_fixtures(device: str, imports: Dict[str, types.ModuleType],
                     tests) -> tuple:
    """The fixtures that hold the port on ``device`` for ``tests`` and
    the module's fixtures, and leave it as it is for any other test of
    the module (a twin file's own hand-written ones)."""
    state = []

    @pytest.fixture(autouse=True, scope="module")
    def ported_device():
        with DeviceDefault(device) as moved, in_sys_modules(imports):
            state.append(moved)
            yield
            state.pop()

    @pytest.fixture(autouse=True)
    def ported_only(request, ported_device):
        state[-1].set(request.function in tests)
        try:
            yield
        finally:
            state[-1].set(True)

    return ported_device, ported_only


def ported(name: str, exclude: Dict[str, str],
           patch: Optional[Dict[str, object]] = None,
           ports: Iterable[int] = (), device: str = "cpu",
           root: Path = TESTS) -> Dict[str, object]:
    """The tests and fixtures of ``root/<name>.py`` rewritten onto the
    port (the module docstring), with :func:`one_torch_thread` and the
    fixture that holds the port on ``device``."""
    path = root / (name + ".py")
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
    patch = patch or {}
    imports = {k: v for k, v in patch.items()
               if isinstance(v, types.ModuleType) and k not in vars(mod)}
    vars(mod).update(patch)
    out = {k: v for k, v in vars(mod).items()
           if (k.startswith("test_") and callable(v)) or _is_fixture(v)}
    missing = sorted(set(exclude) - set(out))
    if missing:
        raise LookupError("%s defines no %s" % (path.name, missing))
    for k in exclude:
        del out[k]
    tests = [v for k, v in out.items() if k.startswith("test_")]
    out["one_torch_thread"] = one_torch_thread
    out["ported_device"], out["ported_only"] = _device_fixtures(
        device, imports, tests)
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
