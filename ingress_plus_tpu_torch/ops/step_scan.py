"""The hand-written CUDA per-byte scan kernel and its scanner.

Port of ``ingress_plus_tpu/ops/pallas_scan.py``'s ``_scan_kernel``: the
per-byte shift-AND scan whose state is exact after each row's length, so
it carries across the chunks of a stream.  :class:`StepScanner` is the
counterpart of ``PallasScanner`` (serving name ``pallas``); the stream
lane (``serve/stream.py``) scans every wave through it.  The kernel's
source, with its design note, is ``csrc/step_scan.cu``.

Build: ``ops/cuda_build.py`` compiles ``csrc/step_scan.cu`` with nvcc for
sm_90a at first use and loads it with ``ctypes``.  Nothing is built when
this module is imported.

Each launch splits its rows' byte chains across warps by the segment
plan of ``ops/segments.py`` (a stream wave of 8-32 rows would otherwise
leave most of the card idle).

Dispatch: the scanner given CUDA tensors launches the kernel or raises;
it never falls back.  Given CPU tensors it runs the plain version,
``ops/scan.py::scan_bytes``, which is the kernel's reference.  The
``launches`` count of :data:`STEP_SCAN` goes up by one per kernel launch
and nowhere else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ingress_plus_tpu_torch.ops.cuda_build import (
    ScanKernel,
    device_words,
    tile_class_table,
)
from ingress_plus_tpu_torch.ops.scan import ScanTables, scan_bytes

#: the process's one binding of the step-scan kernel
STEP_SCAN = ScanKernel("step_scan", class_ids=False)


class StepScanner:
    """Per-byte scanner with exact state carry — serving name ``pallas``.

    uint8 bytes + lengths (and optionally a carried state and sticky
    match) in, (match, state) (B, W) int32 out: the ``scan_bytes``
    contract.  Belongs to one :class:`ScanTables`; a new pack generation
    gets a new scanner."""

    def __init__(self, tables: ScanTables):
        self.tables = tables
        self.byte_class = tables.byte_class.to(torch.int32).contiguous()
        self.class_tiles = tile_class_table(tables.class_table)

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 match: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.tables
        dev = tokens.device
        if dev.type == "cpu":
            return scan_bytes(t, tokens, lengths, state, match)
        return STEP_SCAN(
            tokens.to(torch.uint8).contiguous(),
            lengths,
            self.class_tiles, t.init_mask, t.final_mask,
            byte_class=self.byte_class, state=device_words(state, dev),
            match=device_words(match, dev))
