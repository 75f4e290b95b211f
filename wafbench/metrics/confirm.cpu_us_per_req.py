"""confirm.cpu_us_per_req: thread CPU microseconds a request's confirm
stage takes (models/confirm.py, models/libdetect.py, the fold in
models/pipeline.py), on the threads that run it, from the server's
counters over the window: d ipt_confirm_cpu_us_sum / d
ipt_requests_total."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0 or "ipt_confirm_cpu_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_confirm_cpu_us_sum"] / n
