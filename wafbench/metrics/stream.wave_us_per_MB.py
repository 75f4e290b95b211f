"""stream.wave_us_per_MB: microseconds of the stream lane's scan waves
(serve/stream.py StreamEngine._scan_wave: the copies to the card, the
step kernel, the copies back) per 10^6 body bytes streamed in, from
the server's counters over the window: d ipt_stream_wave_us_sum /
(d ipt_stream_bytes_total / 1e6)."""


def read(ctx):
    mb = ctx.counters.get("ipt_stream_bytes_total", 0.0) / 1e6
    if mb <= 0 or "ipt_stream_wave_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_stream_wave_us_sum"] / mb
