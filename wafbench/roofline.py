"""The least time one NVIDIA H100 needs for the shift-AND scan work of a
window, counted once whatever implements it.

The work is the reference's own rows (:mod:`wafbench.check`): their
unpadded bytes, and ``W`` 32-bit words of the pack.  Each input byte is
read once, each row's ``W`` match words are written once, and each row
byte takes one step of the recurrence per word: two LOP3 and one shift
on the integer pipe, and one read of the class table from shared memory
(the same count as ``chip_smoke.py``'s ``bound_counts`` for the step
kernel, which ``chip_smoke.py`` takes per launch, on padded rows and per
kernel).  Each pipe is bounded on its own, at its own throughput, and
the time is the largest of the bytes over the HBM rate and each pipe's
instructions over its rate.

Peaks, at the full 700 W power limit: the H100 SXM data sheet (3.35 TB/s
HBM3; 67 TFLOP/s float32 from 128 FMA lanes of 2 flops per SM per clock
gives the SM-clocks per second); the CUDA C++ Programming Guide's table
of arithmetic instruction throughput, compute capability 9.0 (32-bit
bitwise AND/OR/XOR and shifts: 64 results per SM per clock); shared
memory's 32 banks of 4 bytes (32 32-bit loads per SM per clock).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
#: 32-bit bitwise and shift results per SM per clock (cc 9.0)
ALU_PER_CLOCK = 64
#: 32-bit shared-memory loads per SM per clock (32 banks)
LDS_PER_CLOCK = 32
#: integer-pipe instructions of one byte step of one word: LOP3 x2, shift
STEP_ALU = 3
#: shared-memory loads of one byte step of one word: the class table
STEP_LDS = 1


def bound_s(rows: float, row_bytes: float, n_words: int) -> float:
    """Seconds: the largest of the byte bound and each pipe's bound."""
    nbytes = row_bytes + rows * (4 + 4 * n_words)   # bytes, lengths, match
    t_bytes = nbytes / HBM_BYTES_PER_S
    steps = row_bytes * n_words
    clocks = max(steps * STEP_ALU / ALU_PER_CLOCK,
                 steps * STEP_LDS / LDS_PER_CLOCK)
    return max(t_bytes, clocks / SM_CLOCKS_PER_S)
