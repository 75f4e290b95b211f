"""engine.us_per_req: microseconds a request spends in the engine (models/engine.py): the scan launches, map_match_words and the copies back, from
the server's counters over the window: d ipt_engine_us_sum /
d ipt_requests_total."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0:
        return None
    return ctx.counters["ipt_engine_us_sum"] / n
