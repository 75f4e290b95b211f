"""Build, load and bind the port's native code.

Each source under ``csrc/`` has a plain C interface and is compiled at
first use into a shared library under ``ingress_plus_tpu_torch/build/``,
named after the source and keyed by the hash of the source, its shared
headers, the compiler and the flags, then loaded with ``ctypes``.  The
CUDA kernels (``*.cu``, with the ``csrc/*.cuh`` headers) go through
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``; the host code of the native confirm twin
(``csrc/libdetect.cc``) goes through ``g++`` with the flags of
``native/confirm/Makefile`` (:data:`GXX_FLAGS`).  Nothing is built when
a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from ingress_plus_tpu_torch.ops.segments import WORD_TILE, plan_segments

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
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


def find_compiler(name: str) -> str:
    """The path of compiler ``name`` ("nvcc" or a host compiler)."""
    if name == "nvcc":
        return find_nvcc()
    path = shutil.which(name)
    if path is None:
        raise RuntimeError("%s not found: the port's native code is built "
                           "from ingress_plus_tpu_torch/csrc at first use"
                           % name)
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
    src = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
    tag = hashlib.sha256(
        src + " ".join((compiler, *flags)).encode()).hexdigest()
    out = BUILD_DIR / ("lib%s_%s.so" % (source.stem, tag[:16]))
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [find_compiler(compiler), *flags]
    if verbose and compiler == "nvcc":
        cmd += ["-Xptxas", "-v"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(cmd + ["-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s failed on %s:\n%s%s"
                               % (compiler, source.name, proc.stdout,
                                  proc.stderr))
        if verbose:
            print(proc.stdout + proc.stderr, end="", flush=True)
        os.replace(tmp, out)   # atomic: concurrent builds both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


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


@contextmanager
def launch_scope(name: str) -> Iterator[None]:
    """Tally this thread's kernel launches under ``name`` inside the
    block (the guarded rollout's admission and shadow work use
    ``ROLLOUT_SCOPE``), so the per-shape tally of the serving cycles stays the
    serving cycles' own.  Every launch still adds one to
    ``ScanKernel.launches``."""
    prev = getattr(_scope, "name", SERVE_SCOPE)
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
    place of uint8 bytes and a ``byte_class`` LUT."""

    def __init__(self, name: str, class_ids: bool):
        self.name = name
        self.class_ids = class_ids
        self.launches = 0
        # (scope, B, L, carried) -> [launches, launches with host
        # lengths, sum of clamp(length, 0, L), rows of odd length, the
        # latest such launch's clamped lengths]
        self._shapes: Dict[tuple, list] = {}
        self._shapes_lock = threading.Lock()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib = KernelLibrary(CSRC / (name + ".cu"), {
            name + "_launch": ([vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp,
                                ci, ci, ci, ci, vp], ci),
            name + "_max_k1": ([], ci),
        }, init=name + "_init")

    def library(self, dev: Optional[torch.device] = None):
        """The loaded library, built at first use; with ``dev``, also
        set the kernel's shared-memory limit on that card (once)."""
        return self.lib.load(dev)

    def _tally(self, B: int, L: int, carried: bool,
               host: Optional[torch.Tensor]) -> None:
        n = (None if host is None
             else host.to(torch.int64).clamp(0, L).numpy())
        key = (getattr(_scope, "name", SERVE_SCOPE), B, L, carried)
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
