"""confirm.us_per_req: microseconds a request spends in confirm (models/confirm.py, the C++ twin csrc/libdetect.cc): the exact check of every candidate, from
the server's counters over the window: d ipt_confirm_us_sum /
d ipt_requests_total."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0:
        return None
    return ctx.counters["ipt_confirm_us_sum"] / n
