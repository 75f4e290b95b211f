"""stream.feed_us_per_MB: microseconds the stream lane spends feeding
chunks (serve/stream.py StreamState.feed and flush: the incremental
decode and normalize) per 10^6 body bytes streamed in, from the
server's counters over the window: d ipt_stream_feed_us_sum /
(d ipt_stream_bytes_total / 1e6)."""


def read(ctx):
    mb = ctx.counters.get("ipt_stream_bytes_total", 0.0) / 1e6
    if mb <= 0 or "ipt_stream_feed_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_stream_feed_us_sum"] / mb
