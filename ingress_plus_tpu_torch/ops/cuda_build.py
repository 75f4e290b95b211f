"""Build, load and bind the port's native code.

Each source under ``csrc/`` has a plain C interface and is compiled at
first use into a shared library under ``ingress_plus_tpu_torch/build/``,
named after the source and keyed by the hash of the source, its shared
headers, the compiler and the flags, then loaded with ``ctypes``.  The
CUDA kernels (``*.cu``, with the ``csrc/*.cuh`` headers) go through
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``; the host code of the native confirm twin
(``csrc/libdetect.cc``) goes through ``g++`` with the flags of
``native/confirm/Makefile`` (:data:`GXX_FLAGS`).  The front door's
binaries (the C++ sidecar, loadgen and the nginx module's harnesses) are
built from ``native/`` with its Makefiles' flags into
``build/native/`` (:func:`build_native`).  Nothing is built when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from ingress_plus_tpu_torch.ops.segments import WORD_TILE, plan_segments

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
#: ``-lineinfo`` maps SASS to source lines for compute-sanitizer's reports
#: and changes no instruction (``chip_smoke.py`` phase 19 compares both
#: kernels' SASS with and without it)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC")
#: the checked build of the scan kernels (``csrc/scan_common.cuh``):
#: bounds, copy-content and warp-ordering checks counted on the card
CHECK_FLAGS = NVCC_FLAGS + ("-DSCAN_CHECK",)
#: host code: the flags of the JAX package's native/confirm/Makefile
GXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from ingress_plus_tpu_torch/csrc at first use")
    return nvcc


def find_compute_sanitizer() -> str:
    """The path of ``compute-sanitizer``: beside nvcc, under
    ``CUDA_HOME/bin`` or ``CUDA_HOME/extras/compute-sanitizer``, else on
    ``PATH``.  Raises RuntimeError when none is found."""
    from torch.utils.cpp_extension import CUDA_HOME

    homes = [Path(CUDA_HOME)] if CUDA_HOME else []
    nvcc = shutil.which("nvcc")
    if nvcc:
        homes.append(Path(nvcc).resolve().parent.parent)
    for home in homes:
        for sub in ("bin", "extras/compute-sanitizer"):
            cand = home / sub / "compute-sanitizer"
            if cand.exists():
                return str(cand)
    found = shutil.which("compute-sanitizer")
    if found is None:
        raise RuntimeError("compute-sanitizer not found under %s or on PATH"
                           % (", ".join(map(str, homes)) or "no CUDA_HOME"))
    return found


def find_compiler(name: str) -> str:
    """The path of compiler ``name`` ("nvcc" or a host compiler)."""
    if name == "nvcc":
        return find_nvcc()
    path = shutil.which(name)
    if path is None:
        raise RuntimeError("%s not found: the port's native code is built "
                           "from source at first use" % name)
    return path


def build_library(source: Path, verbose: bool = False,
                  compiler: str = "nvcc",
                  flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``source`` with ``compiler`` and ``flags`` (once per source
    hash, compiler and flags); returns the shared library's path.
    ``verbose`` rebuilds and prints the compiler's output (with nvcc,
    under ``-Xptxas -v``: the register and shared-memory report).  A
    failed build raises RuntimeError with the compiler's output."""
    headers = sorted(source.parent.glob("*.cuh")) if source.suffix == ".cu" \
        else []
    extra = ["-Xptxas", "-v"] if verbose and compiler == "nvcc" else []
    return _compile([source], headers, "lib%s_{}.so" % source.stem, compiler,
                    flags, extra, verbose)


def build_program(sources: Sequence[Path], flags: Sequence[str],
                  compiler: str = "g++") -> Path:
    """Compile and link ``sources`` into one executable with ``compiler``
    and ``flags``, once per hash of the sources, compiler and flags, into
    :data:`BUILD_DIR` (named after the first source); returns its path.
    A failed build raises RuntimeError with the compiler's output."""
    return _compile(list(sources), [], "%s_{}" % sources[0].stem, compiler,
                    flags, [], False)


def _compile(sources: Sequence[Path], headers: Sequence[Path], name: str,
             compiler: str, flags: Sequence[str], extra: Sequence[str],
             force: bool) -> Path:
    """``compiler flags extra -o BUILD_DIR/name sources``, ``name``'s
    ``{}`` the key of the sources, the headers, the compiler and the
    flags; skipped when that file exists unless ``force``."""
    src = b"".join(p.read_bytes() for p in (*sources, *headers))
    tag = hashlib.sha256(
        src + " ".join((compiler, *flags)).encode()).hexdigest()
    out = BUILD_DIR / name.format(tag[:16])
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_compiler(compiler), *flags, *extra, "-o", tmp,
             *map(str, sources)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s failed on %s:\n%s%s"
                               % (compiler, ", ".join(p.name for p in sources),
                                  proc.stdout, proc.stderr))
        if force:
            print(proc.stdout + proc.stderr, end="", flush=True)
        os.replace(tmp, out)   # atomic: concurrent builds both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


#: the nginx side of the wire, built from the repository's ``native/``
#: sources (never copied into the port, never built in place)
NATIVE = PKG.parent / "native"
NATIVE_BUILD = BUILD_DIR / "native"
#: ``native/sidecar/Makefile`` and ``native/shim/Makefile``: CXXFLAGS
#: and the module objects' C flags
NATIVE_CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")
NATIVE_CFLAGS = ("-O2", "-std=c11", "-Wall", "-Wextra", "-Werror",
                 "-Inginx_compat")
#: ``native/sidecar/Makefile``'s sanitizer tiers: ``SAN_ASAN`` (ASan and
#: UBSan) and ``SAN_TSAN``, after the flags its sanitizer rules spell
SAN_ASAN = ("-fsanitize=address,undefined", "-fno-omit-frame-pointer", "-g",
            "-O1")
SAN_TSAN = ("-fsanitize=thread", "-fno-omit-frame-pointer", "-g", "-O1")
SAN_CXXFLAGS = ("-std=c++17", "-Wall", "-Wextra")
#: each Makefile target: (directory under native/, compiler, flags,
#: inputs in that directory or earlier targets, extra trailing args);
#: ``-c`` targets are objects, in the order they must be built
NATIVE_TARGETS = {
    "sidecar": ("sidecar", "g++", NATIVE_CXXFLAGS, ("sidecar.cc",), ()),
    "loadgen": ("sidecar", "g++", NATIVE_CXXFLAGS, ("loadgen.cc",), ()),
    "sidecar_asan": ("sidecar", "g++", SAN_CXXFLAGS + SAN_ASAN,
                     ("sidecar.cc",), ()),
    "loadgen_asan": ("sidecar", "g++", SAN_CXXFLAGS + SAN_ASAN,
                     ("loadgen.cc",), ()),
    "sidecar_tsan": ("sidecar", "g++", SAN_CXXFLAGS + SAN_TSAN,
                     ("sidecar.cc",), ()),
    "shim_selftest": ("shim", "g++", NATIVE_CXXFLAGS,
                      ("shim_selftest.cc", "shim_bridge.cc"), ()),
    "ngx_http_detect_tpu_module.o": (
        "shim", "gcc", NATIVE_CFLAGS + ("-c",),
        ("ngx_http_detect_tpu_module.c",), ()),
    "ngx_test_double.o": ("shim", "gcc", NATIVE_CFLAGS + ("-I.", "-c"),
                          ("ngx_test_double.c",), ()),
    "shim_harness.o": ("shim", "gcc", NATIVE_CFLAGS + ("-I.", "-c"),
                       ("shim_harness.c",), ()),
    "shim_harness": ("shim", "g++", NATIVE_CXXFLAGS,
                     ("shim_harness.o", "ngx_test_double.o",
                      "ngx_http_detect_tpu_module.o", "shim_bridge.cc"),
                     ("-lpthread",)),
}
#: what each binary needs built before it
NATIVE_DEPS = {"shim_harness": ("ngx_http_detect_tpu_module.o",
                                "ngx_test_double.o", "shim_harness.o")}
NATIVE_BINARIES = ("sidecar", "loadgen", "shim_selftest", "shim_harness")
#: the sanitizer builds (``make asan tsan``), built only when asked for
SANITIZER_BINARIES = ("sidecar_asan", "loadgen_asan", "sidecar_tsan")


def native_dir(root: Path = NATIVE) -> Path:
    """Where :func:`build_native` puts the binaries of ``root``'s sources:
    ``build/native/<key>``, the key hashing every source and header under
    ``root/sidecar`` and ``root/shim``, the compilers and the flags.
    Nothing is built."""
    h = hashlib.sha256()
    for sub in ("sidecar", "shim"):
        for p in sorted((root / sub).rglob("*")):
            if p.suffix in (".c", ".cc", ".h", ".hpp") and p.is_file():
                h.update(str(p.relative_to(root)).encode() + b"\0"
                         + p.read_bytes())
    for name, (_, cc, flags, _, extra) in sorted(NATIVE_TARGETS.items()):
        h.update(" ".join((name, shutil.which(cc) or cc, *flags,
                           *extra)).encode())
    return NATIVE_BUILD / h.hexdigest()[:16]


def build_native(targets: Sequence[str] = NATIVE_BINARIES,
                 root: Path = NATIVE, force: bool = False) -> Dict[str, Path]:
    """Build the front door's binaries (``sidecar``, ``loadgen``,
    ``shim_selftest``, ``shim_harness``; the :data:`SANITIZER_BINARIES`
    and objects by name too) from
    ``root``'s sources with the Makefiles' compilers and flags, into
    :func:`native_dir` (once per key; ``force`` rebuilds).  Each target is
    compiled in a private temporary directory and moved into place with
    ``os.replace``, so processes building at once all succeed and leave
    whole files.  Nothing is written under ``root``.  A failed compile
    raises RuntimeError with the compiler's output.  Returns {target:
    path}."""
    out_dir = native_dir(root)
    want = {t: out_dir / t for t in targets}
    todo = [t for t in targets if force or not want[t].exists()]
    if not todo:
        return want
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=".build-", dir=out_dir))

    def compile_one(t):
        sub, cc, flags, inputs, extra = NATIVE_TARGETS[t]
        args = [str(work / i) if i in NATIVE_TARGETS else i for i in inputs]
        cmd = [find_compiler(cc), *flags, "-o", str(work / t), *args, *extra]
        # the Makefiles' relative include paths resolve from the source
        # directory; every output goes to ``work``
        proc = subprocess.run(cmd, cwd=str(root / sub), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s failed on %s (%s):\n%s%s"
                               % (cc, t, " ".join(cmd), proc.stdout,
                                  proc.stderr))

    # one compiler per target, all at once; then the links that need them
    first = {d for t in todo for d in NATIVE_DEPS.get(t, ())}
    first |= {t for t in todo if t not in NATIVE_DEPS}
    try:
        for stage in (sorted(first), [t for t in todo if t in NATIVE_DEPS]):
            if stage:
                with ThreadPoolExecutor(len(stage)) as pool:
                    list(pool.map(compile_one, stage))
        for t in todo:
            os.replace(work / t, want[t])   # atomic, as in build_library
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return want


#: a C function's ctypes signature: (argtypes, restype)
Prototype = Tuple[Sequence[type], type]


class KernelLibrary:
    """One source's library: built and loaded at first use, with its
    per-device setup function, if it has one (which allows the kernels
    their dynamic shared memory), run once on each card.  ``hold_gil``
    loads it with ``ctypes.PyDLL``, whose calls keep the interpreter
    lock, in place of ``ctypes.CDLL``, whose calls release it."""

    def __init__(self, source: Path, prototypes: Dict[str, Prototype],
                 init: Optional[str], compiler: str = "nvcc",
                 flags: Sequence[str] = NVCC_FLAGS, hold_gil: bool = False):
        self.source = source
        self.prototypes = dict(prototypes)
        self.init = init
        self.compiler = compiler
        self.flags = tuple(flags)
        self.loader = ctypes.PyDLL if hold_gil else ctypes.CDLL
        self._lib = None
        self._ready = set()     # device indices the setup function ran on
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, verbose, self.compiler, self.flags)

    def load(self, dev: Optional[torch.device] = None):
        """The loaded library; with ``dev``, also run the setup function
        on that card (once)."""
        lib = self._lib
        if lib is not None and dev is None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = self.loader(str(self.build()))
                for name, (argtypes, restype) in self.prototypes.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                if self.init is not None:
                    getattr(lib, self.init).argtypes = []
                    getattr(lib, self.init).restype = ctypes.c_int
                self._lib = lib
            if dev is not None and self.init is not None:
                idx = torch.device(dev).index
                idx = torch.cuda.current_device() if idx is None else idx
                if idx not in self._ready:
                    with torch.cuda.device(idx):
                        err = getattr(self._lib, self.init)()
                    if err != 0:
                        raise RuntimeError("%s setup failed: CUDA error %d"
                                           % (self.source.name, err))
                    self._ready.add(idx)
            return self._lib


def check_tensors(dev: torch.device, want: dict) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` lies on
    ``dev`` with that dtype and shape, contiguous."""
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError("%s on %s, tokens on %s" % (name, t.device, dev))
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def tile_class_table(class_table: torch.Tensor) -> torch.Tensor:
    """(K+1, W) class table -> the kernels' word-tile-major copy,
    (ceil(W/32), K+1, 32) int32 with zero reach past W: one block's
    32-word slice is then one contiguous span."""
    K1, W = class_table.shape
    tiles = -(-W // WORD_TILE)
    padded = torch.nn.functional.pad(class_table.to(torch.int32),
                                     (0, tiles * WORD_TILE - W))
    return padded.view(K1, tiles, WORD_TILE).permute(1, 0, 2).contiguous()


def granule_padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) when it is 16-byte aligned and its storage
    reaches the 16-byte boundary past its last byte, else a copy of it at
    the start of a fresh zero-filled buffer that does: a scan kernel
    copies each token window as the whole 16-byte granules around it."""
    nbytes = t.numel() * t.element_size()
    need = -(-nbytes // 16) * 16
    st = t.untyped_storage()
    if (t.data_ptr() % 16 == 0
            and st.data_ptr() + st.nbytes() - t.data_ptr() >= need):
        return t
    buf = torch.zeros(need, dtype=torch.uint8, device=t.device)
    buf[:nbytes].copy_(t.reshape(-1).view(torch.uint8))
    return buf[:nbytes].view(t.dtype).view(t.shape)


def device_words(x: Optional[torch.Tensor],
                 dev: torch.device) -> Optional[torch.Tensor]:
    """Optional (B, W) words as a contiguous int32 tensor on ``dev``."""
    return None if x is None else x.to(dev, torch.int32).contiguous()


#: the launch scope of the calling thread (:func:`launch_scope`)
_scope = threading.local()

#: the scope of every launch outside a :func:`launch_scope` block: the
#: serving cycles (lane workers, the stream lane, library callers)
SERVE_SCOPE = "serve"
#: the guarded rollout's admission and shadow work (control/rollout.py)
ROLLOUT_SCOPE = "rollout"


def current_scope() -> str:
    """The calling thread's :func:`launch_scope` name."""
    return getattr(_scope, "name", SERVE_SCOPE)


@contextmanager
def launch_scope(name: str) -> Iterator[None]:
    """Tally this thread's kernel launches under ``name`` inside the
    block (the guarded rollout's admission and shadow work use
    ``ROLLOUT_SCOPE``), so the per-shape tally of the serving cycles stays the
    serving cycles' own.  Every launch still adds one to
    ``ScanKernel.launches``."""
    prev = current_scope()
    _scope.name = name
    try:
        yield
    finally:
        _scope.name = prev


class ScanKernel:
    """ctypes binding of one scan kernel, plus its launch count and a
    per-shape tally of its launches (:meth:`shape_snapshot`).

    The scan kernels share one C interface, from ``csrc/<name>.cu``:
    ``<name>_launch(tokens, lengths, byte_class, class_tiles, k1,
    init_mask, final_mask, state_in, match_in, match_out, state_out, B,
    L, W, G, stream)`` returning ``cudaGetLastError()``,
    ``<name>_max_k1()`` and the per-device setup ``<name>_init()``.  ``G``
    is the segment length of :func:`ops.segments.plan_segments`.
    ``class_ids`` says whether the kernel also takes int32 class ids in
    place of uint8 bytes and a ``byte_class`` LUT.  ``flags`` are nvcc's;
    :data:`CHECK_FLAGS` gives the checked build, whose failures
    :meth:`check_errors` reads."""

    def __init__(self, name: str, class_ids: bool,
                 flags: Sequence[str] = NVCC_FLAGS):
        self.name = name
        self.class_ids = class_ids
        self.launches = 0
        # (scope, B, L, carried) -> [launches, launches with host
        # lengths, sum of clamp(length, 0, L), rows of odd length, the
        # latest such launch's clamped lengths]
        self._shapes: Dict[tuple, list] = {}
        self._shapes_lock = threading.Lock()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        prototypes = {
            name + "_launch": ([vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp,
                                ci, ci, ci, ci, vp], ci),
            name + "_max_k1": ([], ci),
        }
        if "-DSCAN_CHECK" in flags:
            prototypes[name + "_check_errors"] = ([vp, vp],
                                                  ctypes.c_longlong)
        self.lib = KernelLibrary(CSRC / (name + ".cu"), prototypes,
                                 init=name + "_init", flags=flags)

    def library(self, dev: Optional[torch.device] = None):
        """The loaded library, built at first use; with ``dev``, also
        set the kernel's shared-memory limit on that card (once)."""
        return self.lib.load(dev)

    def check_errors(self) -> dict:
        """The checked build's failures since the last call: ``total``,
        ``by_code`` (code -> count; codes are ``CheckCode`` in
        ``csrc/scan_common.cuh``) and ``first`` ([code, blockIdx.x,
        blockIdx.y, detail] of the first); resets them."""
        counts, first = (ctypes.c_ulonglong * 16)(), (ctypes.c_int * 4)()
        n = getattr(self.library(), self.name + "_check_errors")(counts,
                                                                 first)
        if n < 0:
            raise RuntimeError("%s: reading the check counters failed"
                               % self.name)
        return {"total": n, "first": list(first),
                "by_code": {c: int(v) for c, v in enumerate(counts) if v}}

    def _tally(self, B: int, L: int, carried: bool,
               host: Optional[torch.Tensor]) -> None:
        n = (None if host is None
             else host.to(torch.int64).clamp(0, L).numpy())
        key = (current_scope(), B, L, carried)
        with self._shapes_lock:
            t = self._shapes.setdefault(key, [0, 0, 0, 0, None])
            t[0] += 1
            if n is not None:
                t[1] += 1
                t[2] += int(n.sum())
                t[3] += int((n & 1).sum())
                t[4] = n

    def shape_snapshot(self, scope: str = SERVE_SCOPE) -> list:
        """The launches of one :func:`launch_scope` so far by (B, L,
        carried), as JSON-ready dicts: ``launches``; over the ``known``
        launches whose caller passed the lengths on the host, ``steps``
        (the sum of every row's clamped length: the work the kernel did)
        and ``odd_rows``; and ``lengths``, the latest such launch's
        clamped lengths."""
        with self._shapes_lock:
            items = [(k[1:], list(v)) for k, v in sorted(self._shapes.items())
                     if k[0] == scope]
        return [{"B": B, "L": L, "carried": c, "launches": t[0],
                 "known": t[1], "steps": t[2], "odd_rows": t[3],
                 "lengths": None if t[4] is None else t[4].tolist()}
                for (B, L, c), t in items]

    def scope_launches(self, scope: str = SERVE_SCOPE) -> int:
        """The launches tallied under one :func:`launch_scope`."""
        with self._shapes_lock:
            return sum(t[0] for k, t in self._shapes.items()
                       if k[0] == scope)

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 class_tiles: torch.Tensor, init_mask: torch.Tensor,
                 final_mask: torch.Tensor,
                 byte_class: Optional[torch.Tensor] = None,
                 state: Optional[torch.Tensor] = None,
                 match: Optional[torch.Tensor] = None,
                 segment: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on ``torch.cuda.current_stream()``; returns (match,
        state) (B, W) int32.  ``byte_class`` (257,) int32 maps uint8
        ``tokens`` to class rows of ``class_tiles`` (the
        :func:`tile_class_table` copy of the (K+1, W) class table);
        without it (class id kernels only) ``tokens`` are int32 class
        ids.  Ids outside [0, K+1) read as the last (dead) row.  The
        launch splits rows by :func:`plan_segments`; ``segment`` forces
        its segment length (``L`` or more: one segment).  ``lengths``
        may lie on the host: they are copied to the card, and the shape
        tally then also counts the work they ask for."""
        label = self.name.replace("_", "-")
        dev = tokens.device
        if dev.type != "cuda":
            raise ValueError("%s kernel needs CUDA tensors, got %s"
                             % (label, dev))
        host = lengths if lengths.device.type == "cpu" else None
        lengths = lengths.to(dev, torch.int32).contiguous()
        if byte_class is None and not self.class_ids:
            raise ValueError("%s kernel needs a byte_class LUT" % label)
        B, L = tokens.shape
        W = init_mask.shape[0]
        K1 = class_tiles.shape[1] if class_tiles.dim() == 3 else 0
        want = {
            "tokens": (tokens, torch.uint8 if byte_class is not None
                       else torch.int32, (B, L)),
            "lengths": (lengths, torch.int32, (B,)),
            "class_tiles": (class_tiles, torch.int32,
                            (-(-W // WORD_TILE), K1, WORD_TILE)),
            "init_mask": (init_mask, torch.int32, (W,)),
            "final_mask": (final_mask, torch.int32, (W,)),
        }
        if byte_class is not None:
            want["byte_class"] = (byte_class, torch.int32, (257,))
        if state is not None:
            want["state"] = (state, torch.int32, (B, W))
        if match is not None:
            want["match"] = (match, torch.int32, (B, W))
        check_tensors(dev, want)
        tokens = granule_padded(tokens)
        for name in ("class_tiles", "byte_class"):   # bulk-copied whole
            t = want.get(name, (None,))[0]
            if t is not None and t.data_ptr() % 16:
                raise ValueError("%s must be 16-byte aligned" % name)
        lib = self.library(dev)
        max_k1 = getattr(lib, self.name + "_max_k1")()
        if not 1 <= K1 <= max_k1:
            raise ValueError("class table has %d rows; the kernel takes "
                             "1..%d" % (K1, max_k1))
        plan = plan_segments(B, L, W, segment)
        match_out = torch.empty((B, W), dtype=torch.int32, device=dev)
        state_out = torch.empty((B, W), dtype=torch.int32, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, self.name + "_launch")(
                ptr(tokens), ptr(lengths), ptr(byte_class), ptr(class_tiles),
                K1, ptr(init_mask), ptr(final_mask), ptr(state), ptr(match),
                ptr(match_out), ptr(state_out), B, L, W, plan.G, stream)
        if err != 0:
            raise RuntimeError("%s kernel launch failed: CUDA error %d"
                               % (label, err))
        if B and W:
            self.launches += 1
            self._tally(B, L, state is not None, host)
        return match_out, state_out
