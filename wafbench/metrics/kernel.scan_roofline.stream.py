"""kernel.scan_roofline.stream: the least time one H100 needs for the scan
work of the window (wafbench/roofline.py, on the reference's own unpadded
rows), over the device time of both scan kernels in the window
(csrc/pair_scan.cu, csrc/step_scan.cu; the profiler's trace), in %."""

from wafbench.roofline import bound_s


def read(ctx):
    if ctx.trace is None or ctx.trace.scan_s <= 0:
        return None
    rows, nbytes = ctx.work_in_window()
    ctx.notes.append("scan kernels: %d launches, %.6f s of device time in "
                     "the window; %.0f rows, %.0f bytes of work"
                     % (ctx.trace.scan_launches, ctx.trace.scan_s, rows,
                        nbytes))
    return 100.0 * bound_s(rows, nbytes, ctx.n_words) / ctx.trace.scan_s
