"""Build, load and bind the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first use
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles it into a shared library under
``ingress_plus_tpu_torch/build/``, named after the source and keyed by
the hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, and ``ctypes`` loads it.  Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from ingress_plus_tpu_torch.ops.segments import WORD_TILE, plan_segments

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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


def build_library(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` (once per source hash and flags); returns the
    shared library's path.  ``verbose`` rebuilds with ``-Xptxas -v`` and
    prints the compiler's register and shared-memory report."""
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / ("lib%s_%s.so" % (source.stem, tag[:16]))
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(cmd + ["-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s%s"
                               % (source.name, proc.stdout, proc.stderr))
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
    """One kernel source's library: built and loaded at first use, with
    its per-device setup function (which allows the kernels their
    dynamic shared memory) run once on each card."""

    def __init__(self, source: Path, prototypes: Dict[str, Prototype],
                 init: str):
        self.source = source
        self.prototypes = dict(prototypes)
        self.init = init
        self._lib = None
        self._ready = set()     # device indices the setup function ran on
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, verbose)

    def load(self, dev: Optional[torch.device] = None):
        """The loaded library; with ``dev``, also run the setup function
        on that card (once)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (argtypes, restype) in self.prototypes.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                getattr(lib, self.init).argtypes = []
                getattr(lib, self.init).restype = ctypes.c_int
                self._lib = lib
            if dev is not None:
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


class ScanKernel:
    """ctypes binding of one scan kernel, plus its launch count.

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
        its segment length (``L`` or more: one segment)."""
        label = self.name.replace("_", "-")
        dev = tokens.device
        if dev.type != "cuda":
            raise ValueError("%s kernel needs CUDA tensors, got %s"
                             % (label, dev))
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
        return match_out, state_out
