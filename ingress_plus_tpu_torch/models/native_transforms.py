"""The confirm stage's whitespace transforms in C++.

``compressWhitespace`` and ``removeWhitespace`` (``models/confirm.py``)
were each a ``re.sub`` over ``[\\s\\x0b]+``, which builds one match
object per whitespace run: ~150k on a MiB of decoded form or JSON text,
and the transform chains of the CRS rules run them five times on each
long value of a body.  ``csrc/transforms.cc`` does each in one pass,
byte for byte the same output.  ``g++`` builds it at first use with the
flags of the native confirm twin (:data:`GXX_FLAGS`) into
``ingress_plus_tpu_torch/build/`` (``ops/cuda_build.py``), and it is
loaded with ``ctypes.PyDLL``, as ``models/libdetect.py`` loads its twin
and for the same reason: a call lasts microseconds on a header value, and
a thread that released the interpreter lock that often would wait to
take it back behind every busy thread of the serve plane.
``DetectionPipeline`` builds it when it is constructed
(:func:`native_transforms`), so no request pays for the build; a failed
build or load raises, with the compiler's output.

:func:`compress_whitespace` and :func:`remove_whitespace` return the
input object itself when it needs no change (for compress: it holds no
whitespace but lone spaces), which saves a copy of a base64 body.
``models/confirm.py`` dispatches to them unless ``IPT_NO_NATIVE_CONFIRM``
is set.

:func:`run_sanitized` runs both under ASan and UBSan, linked with the
runner ``csrc/transforms_check.cc`` into one executable, in a process of
its own (as ``models/libdetect.py run_sanitized`` runs the twin).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterable, List, Tuple

from ingress_plus_tpu_torch.models.libdetect import run_framed
from ingress_plus_tpu_torch.ops.cuda_build import (
    CSRC,
    GXX_FLAGS,
    SAN_ASAN,
    SAN_CXXFLAGS,
    KernelLibrary,
    build_program,
)

#: (input, its length, an output buffer at least that long) -> the length
#: written, or -1 when the input needs no change
_SIGNATURE = ([ctypes.c_char_p, ctypes.c_size_t,
               ctypes.POINTER(ctypes.c_char)], ctypes.c_longlong)

_LIB = KernelLibrary(
    CSRC / "transforms.cc",
    {"ipt_compress_whitespace": _SIGNATURE,
     "ipt_remove_whitespace": _SIGNATURE},
    init=None, compiler="g++", flags=GXX_FLAGS, hold_gil=True)


def native_transforms():
    """The library, built and loaded at first use (behind a lock), or
    None when ``IPT_NO_NATIVE_CONFIRM`` is set.  A failed build or load
    raises."""
    if os.environ.get("IPT_NO_NATIVE_CONFIRM"):
        return None
    return _LIB.load()


def _run(fn, data: bytes) -> bytes:
    # the output lives in a bytearray, reached through one c_char: a
    # ctypes array type per length (create_string_buffer) would be
    # created, at ~30 us, and kept for every new length
    n = len(data)
    out = bytearray(n + 1)
    k = fn(data, n, ctypes.byref(ctypes.c_char.from_buffer(out)))
    return data if k < 0 else bytes(memoryview(out)[:k])


def compress_whitespace(data: bytes) -> bytes:
    """Every maximal run of bytes ``\\s`` (9-13, 32) becomes one space."""
    return _run(_LIB.load().ipt_compress_whitespace, data)


def remove_whitespace(data: bytes) -> bytes:
    """Every byte ``\\s`` (9-13, 32) is deleted."""
    return _run(_LIB.load().ipt_remove_whitespace, data)


# ------------------------------------------ both under ASan + UBSan


def sanitized_binary():
    """Both transforms and their runner linked into one ASan + UBSan
    executable (built once per source hash into the port's build
    directory)."""
    return build_program([CSRC / "transforms_check.cc",
                          CSRC / "transforms.cc"],
                         SAN_CXXFLAGS + SAN_ASAN)


def run_sanitized(strings: Iterable[bytes], timeout: float = 300.0
                  ) -> Tuple[List[Tuple[bytes, bytes]], str, int]:
    """Each of ``strings`` (any bytes, any length) through the sanitized
    transforms: ([(compressed, removed)] per string as far as the runner
    got, each the input itself where it needed no change; its stderr;
    its exit code).  The caller reads the sanitizer reports off
    stderr."""
    strings = list(strings)
    proc = run_framed(sanitized_binary(), strings, timeout)
    results, at, raw = [], 0, proc.stdout
    for data in strings:
        pair = []
        while len(pair) < 2 and at + 4 <= len(raw):
            (k,) = struct.unpack_from("<i", raw, at)
            at += 4
            pair.append(data if k < 0 else raw[at:at + k])
            at += max(k, 0)
        if len(pair) < 2:
            break
        results.append(tuple(pair))
    return results, proc.stderr.decode(errors="replace"), proc.returncode
