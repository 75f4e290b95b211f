"""stream.finish_ms_per_upload: milliseconds a stream's finish takes
(serve/stream.py StreamEngine.finish: the rule fold and the confirm of
the whole body), from the server's counters over the window:
d ipt_stream_finish_us_sum / d ipt_stream_finishes_total / 1000."""


def read(ctx):
    n = ctx.counters.get("ipt_stream_finishes_total", 0.0)
    if n <= 0 or "ipt_stream_finish_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_stream_finish_us_sum"] / n / 1000.0
