"""How a scan launch splits each row's serial chain into segments.

Both scan kernels (``csrc/step_scan.cu``, ``csrc/pair_scan.cu``) give one
warp one unit: a (row, segment) pair over one 32-word tile.  A row of L
bytes is cut into segments of G bytes; segment s covers bytes
[s*G, min((s+1)*G, length)).  Segment 0 starts from the carried state;
every later segment first re-scans the ``HALO`` bytes before its start
from the zero state, without recording matches.  That warm-up is exact:
the step ``S' = ((S<<1)|I) & R`` moves each bit one place up, so bit j
of the state after a byte depends only on the last j+1 bytes and no bit
survives 32 steps (16 pairs) from the state before them.  The match
words of the segments are OR-ed; the state comes from the segment that
holds the row's end.

:func:`plan_segments` picks G for a launch of B rows x L bytes over W
words.  It splits rows only while the launch has too few warps to fill
the card, and only into at least ``MIN_SPLIT`` segments: row-starved
launches (a stream wave of 8-32 rows, the batch path's 8-row buckets of
long bodies) otherwise run one thread's whole chain while most SMs idle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

#: bytes of warm-up before every segment after the first (16 pairs)
HALO = 32
#: words per block column (one per lane) and units per block (one per warp)
WORD_TILE = 32
UNITS_PER_BLOCK = 8
#: the shortest split segment: the halo then adds at most 25% of the work
MIN_SEGMENT = 128
#: the fewest segments worth a split: a row cut in two or three keeps most
#: of its chain while its blocks, and their prologues, double or triple
MIN_SPLIT = 4
#: the grid's y limit (units are laid out along y, 8 to a block)
MAX_GRID_Y = 65535
#: warps a launch needs before splitting stops paying: 16 resident warps
#: on each of the H100's 132 SMs.  Set from the segment sweep of
#: ``chip_smoke.py`` (PERF.md): the row-starved launches ran fastest
#: at about 2048 warps (B=8 x 16384 at G=512, B=32 x 2048 at G=256), and
#: 2-segment splits of 256-byte rows (B=128 and 256) ran slower than one
#: segment, hence MIN_SPLIT.
TARGET_WARPS = 16 * 132


class SegmentPlan(NamedTuple):
    """G (bytes per segment, a multiple of 32), the segments per row and
    the launch's grid (word tiles, blocks of 8 units)."""
    G: int
    segments: int
    grid: tuple


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan_segments(B: int, L: int, W: int,
                  segment: Optional[int] = None) -> SegmentPlan:
    """The segment length for a launch of ``B`` rows x ``L`` positions
    over ``W`` words.  ``segment`` forces a length (a multiple of 32,
    at least ``HALO``; any value >= L means one segment), as the card
    run does to time the same launch unsplit.  Raises if the units do
    not fit the grid."""
    tiles = _ceil(W, WORD_TILE)
    whole = max(32, _ceil(L, 32) * 32)
    if segment is not None:
        G = segment
        if G < L and (G % 32 or G < HALO):
            raise ValueError("segment length %d: a split segment is a "
                             "multiple of 32 of at least %d" % (G, HALO))
    elif B * tiles >= TARGET_WARPS or L <= MIN_SEGMENT:
        G = whole
    else:
        per_row = _ceil(TARGET_WARPS, B * tiles)
        G = max(MIN_SEGMENT, _ceil(_ceil(L, per_row), 32) * 32)
        if _ceil(L, G) < MIN_SPLIT:
            G = whole
    if G >= L:
        G = max(G, whole)
    segments = max(1, _ceil(L, G))
    blocks = _ceil(B * segments, UNITS_PER_BLOCK)
    if blocks > MAX_GRID_Y:
        raise ValueError("%d rows x %d segments exceed the grid (%d blocks "
                         "of %d units)" % (B, segments, MAX_GRID_Y,
                                           UNITS_PER_BLOCK))
    return SegmentPlan(G, segments, (tiles, blocks))
