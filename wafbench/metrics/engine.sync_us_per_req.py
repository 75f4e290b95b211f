"""engine.sync_us_per_req: microseconds a request's engine stage waits
on the copy back of its rule hits (models/engine.py detect_device_multi,
the engine's one wait on the card), from the server's counters over the
window: d ipt_engine_sync_us_sum / d ipt_requests_total."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0 or "ipt_engine_sync_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_engine_sync_us_sum"] / n
