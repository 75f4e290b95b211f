"""The hand-written CUDA pair-scan kernel and its scanners.

Port of ``ingress_plus_tpu/ops/pallas_scan.py``'s ``_pair_kernel``: the
class-pair shift-AND scan, in its raw-byte configuration (serving name
``pallas3``, :class:`ByteScanner`, the counterpart of
``PallasByteScanner``) and its class-id configuration (``pallas2``,
:class:`PairScanner`, the counterpart of ``PallasPairScanner``).  The
kernel's source, with its design note, is ``csrc/pair_scan.cu``.

Build: ``ops/cuda_build.py`` compiles ``csrc/pair_scan.cu`` with nvcc
for sm_90a at first use and loads it with ``ctypes``.  Nothing is built
when this module is imported.

Each launch splits its rows' pair chains across warps by the segment
plan of ``ops/segments.py`` (the 8-row buckets of long bodies would
otherwise leave most of the card idle).

Dispatch: a scanner given CUDA tensors launches the kernel or raises; it
never falls back.  Given CPU tensors it runs the plain version,
``ops/scan.py::scan_pairs``, which is the kernel's reference.  The
``launches`` count of :data:`PAIR_SCAN` goes up by one per kernel launch
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
from ingress_plus_tpu_torch.ops.scan import ScanTables, classes_for, scan_pairs

#: the process's one binding of the pair-scan kernel
PAIR_SCAN = ScanKernel("pair_scan", class_ids=True)


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
        self.class_tiles = tile_class_table(tables.class_table)

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
            lengths,
            self.class_tiles, t.init_mask, t.final_mask,
            byte_class=self.byte_class, state=device_words(state, dev),
            match=device_words(match, dev))


class PairScanner:
    """Class-id pair scanner — serving name ``pallas2``.

    Bytes are mapped to class ids (dead class for padding) by
    :func:`classes_for` before the launch; the kernel then looks the ids
    up directly.  Same call contract as :class:`ByteScanner`."""

    def __init__(self, tables: ScanTables):
        self.tables = tables
        self.class_tiles = tile_class_table(tables.class_table)

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
            lengths,
            self.class_tiles, t.init_mask, t.final_mask,
            state=device_words(state, dev), match=device_words(match, dev))


def _plain(t: ScanTables, tokens, lengths, state, match):
    """The kernel's plain version on CPU tensors; an odd L gains one
    padding column, which lies past every row's length (dead class)."""
    if tokens.shape[1] % 2:
        tokens = torch.nn.functional.pad(tokens, (0, 1))
    return scan_pairs(t, tokens, lengths, state, match)
