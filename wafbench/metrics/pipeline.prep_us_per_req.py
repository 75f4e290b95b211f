"""pipeline.prep_us_per_req: microseconds a request spends in host prep (models/pipeline.py, serve/normalize.py, serve/unpack.py): normalize, unpack and merge a request's rows, from
the server's counters over the window: d ipt_prep_us_sum /
d ipt_requests_total."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0:
        return None
    return ctx.counters["ipt_prep_us_sum"] / n
