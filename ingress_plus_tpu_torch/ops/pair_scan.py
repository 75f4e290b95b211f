"""The hand-written CUDA pair-scan kernel and its scanners.

Port of ``ingress_plus_tpu/ops/pallas_scan.py``'s ``_pair_kernel``: the
class-pair shift-AND scan, in its raw-byte configuration (serving name
``pallas3``, :class:`ByteScanner`, the counterpart of
``PallasByteScanner``) and its class-id configuration (``pallas2``,
:class:`PairScanner`, the counterpart of ``PallasPairScanner``).  The
kernel's source, with its design note, is ``csrc/pair_scan.cu``.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` compiles ``csrc/pair_scan.cu`` into a shared
library under ``ingress_plus_tpu_torch/build/`` (keyed by the source's
hash), loaded with ``ctypes``.  Nothing is built when this module is
imported.

Dispatch: a scanner given CUDA tensors launches the kernel or raises; it
never falls back.  Given CPU tensors it runs the plain version,
``ops/scan.py::scan_pairs``, which is the kernel's reference.  The
``launches`` count of :data:`PAIR_SCAN` goes up by one per kernel launch
and nowhere else.
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
from typing import Optional, Tuple

import torch

from ingress_plus_tpu_torch.ops.scan import ScanTables, classes_for, scan_pairs

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pair_scan.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the pair-scan kernel is built "
                           "from csrc/pair_scan.cu at first use")
    return nvcc


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/pair_scan.cu`` (once per source hash); returns the
    shared library's path.  ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's register and shared-memory report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / ("libpair_scan_%s.so" % tag[:16])
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(cmd + ["-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s%s"
                               % (SOURCE.name, proc.stdout, proc.stderr))
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, out)   # atomic: concurrent builds both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class PairScanKernel:
    """ctypes binding of the kernel plus its launch count."""

    name = "pair_scan"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._ready = set()     # device indices pair_scan_init ran on
        self._lock = threading.Lock()

    def library(self, dev: Optional[torch.device] = None):
        """The loaded library, built at first use; with ``dev``, also
        set the kernel's shared-memory limit on that card (once)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library()))
                vp, ci = ctypes.c_void_p, ctypes.c_int
                lib.pair_scan_launch.argtypes = [
                    vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp,
                    ci, ci, ci, vp]
                lib.pair_scan_launch.restype = ci
                lib.pair_scan_max_k1.argtypes = []
                lib.pair_scan_max_k1.restype = ci
                lib.pair_scan_init.argtypes = []
                lib.pair_scan_init.restype = ci
                self._lib = lib
            if dev is not None:
                idx = torch.device(dev).index
                idx = torch.cuda.current_device() if idx is None else idx
                if idx not in self._ready:
                    with torch.cuda.device(idx):
                        err = self._lib.pair_scan_init()
                    if err != 0:
                        raise RuntimeError("pair-scan kernel setup failed: "
                                           "CUDA error %d" % err)
                    self._ready.add(idx)
            return self._lib

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 class_table: torch.Tensor, init_mask: torch.Tensor,
                 final_mask: torch.Tensor,
                 byte_class: Optional[torch.Tensor] = None,
                 state: Optional[torch.Tensor] = None,
                 match: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on ``torch.cuda.current_stream()``; returns (match,
        state) (B, W) int32.  ``byte_class`` (257,) int32 selects the
        raw-byte configuration (``tokens`` uint8); without it ``tokens``
        are int32 class ids.  Ids outside [0, K+1) read as the dead
        class."""
        dev = tokens.device
        if dev.type != "cuda":
            raise ValueError("pair-scan kernel needs CUDA tensors, got %s"
                             % dev)
        B, L = tokens.shape
        K1, W = class_table.shape
        want = {
            "tokens": (tokens, torch.uint8 if byte_class is not None
                       else torch.int32, (B, L)),
            "lengths": (lengths, torch.int32, (B,)),
            "class_table": (class_table, torch.int32, (K1, W)),
            "init_mask": (init_mask, torch.int32, (W,)),
            "final_mask": (final_mask, torch.int32, (W,)),
        }
        if byte_class is not None:
            want["byte_class"] = (byte_class, torch.int32, (257,))
        if state is not None:
            want["state"] = (state, torch.int32, (B, W))
        if match is not None:
            want["match"] = (match, torch.int32, (B, W))
        for name, (t, dtype, shape) in want.items():
            if t.device != dev:
                raise ValueError("%s on %s, tokens on %s"
                                 % (name, t.device, dev))
            if t.dtype != dtype:
                raise TypeError("%s must be %s, got %s"
                                % (name, dtype, t.dtype))
            if tuple(t.shape) != shape:
                raise ValueError("%s must have shape %s, got %s"
                                 % (name, shape, tuple(t.shape)))
            if not t.is_contiguous():
                raise ValueError("%s must be contiguous" % name)
        lib = self.library(dev)
        if not 1 <= K1 <= lib.pair_scan_max_k1():
            raise ValueError("class table has %d rows; the kernel takes "
                             "1..%d" % (K1, lib.pair_scan_max_k1()))
        if B > 8 * 65535:
            raise ValueError("batch of %d rows exceeds the grid" % B)
        match_out = torch.empty((B, W), dtype=torch.int32, device=dev)
        state_out = torch.empty((B, W), dtype=torch.int32, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.pair_scan_launch(
                ptr(tokens), ptr(lengths), ptr(byte_class), ptr(class_table),
                K1, ptr(init_mask), ptr(final_mask), ptr(state), ptr(match),
                ptr(match_out), ptr(state_out), B, L, W, stream)
        if err != 0:
            raise RuntimeError("pair-scan kernel launch failed: CUDA error "
                               "%d" % err)
        if B and W:
            self.launches += 1
        return match_out, state_out


#: the process's one binding of the pair-scan kernel
PAIR_SCAN = PairScanKernel()


def _words(x: Optional[torch.Tensor], dev: torch.device
           ) -> Optional[torch.Tensor]:
    return None if x is None else x.to(dev, torch.int32).contiguous()


class ByteScanner:
    """Raw-byte pair scanner — serving name ``pallas3``.

    uint8 request bytes + lengths in, (match, state) (B, W) int32 out.
    The byte→class mapping, the ragged-row handling and the pair chain
    all run inside the one kernel launch.  State contract = scan_pairs:
    rows shorter than L return state 0 (request scans and equal-length
    chunk waves, not ragged stream carries)."""

    def __init__(self, tables: ScanTables):
        self.tables = tables
        self.byte_class = tables.byte_class.to(torch.int32).contiguous()

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 match: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.tables
        dev = tokens.device
        if dev.type == "cpu":
            return _plain(t, tokens, lengths, state, match)
        return PAIR_SCAN(
            tokens.to(torch.uint8).contiguous(),
            lengths.to(dev, torch.int32).contiguous(),
            t.class_table, t.init_mask, t.final_mask,
            byte_class=self.byte_class, state=_words(state, dev),
            match=_words(match, dev))


class PairScanner:
    """Class-id pair scanner — serving name ``pallas2``.

    Bytes are mapped to class ids (dead class for padding) by
    :func:`classes_for` before the launch; the kernel then looks the ids
    up directly.  Same call contract as :class:`ByteScanner`."""

    def __init__(self, tables: ScanTables):
        self.tables = tables

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 match: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.tables
        dev = tokens.device
        if dev.type == "cpu":
            return _plain(t, tokens, lengths, state, match)
        cls = classes_for(t.byte_class, tokens, lengths.to(dev))
        return PAIR_SCAN(
            cls.to(torch.int32).contiguous(),
            lengths.to(dev, torch.int32).contiguous(),
            t.class_table, t.init_mask, t.final_mask,
            state=_words(state, dev), match=_words(match, dev))


def _plain(t: ScanTables, tokens, lengths, state, match):
    """The kernel's plain version on CPU tensors; an odd L gains one
    padding column, which lies past every row's length (dead class)."""
    if tokens.shape[1] % 2:
        tokens = torch.nn.functional.pad(tokens, (0, 1))
    return scan_pairs(t, tokens, lengths, state, match)
