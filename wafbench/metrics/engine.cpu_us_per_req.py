"""engine.cpu_us_per_req: thread CPU microseconds a request's engine
stage (models/engine.py, the pad and pack in models/pipeline.py) takes
outside its copy back, on the threads that run it, from the server's
counters over the window: d ipt_engine_cpu_us_sum / d
ipt_requests_total.  What engine.us_per_req holds beyond this and
engine.sync_us_per_req is time the thread could have run and did not."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    if n <= 0 or "ipt_engine_cpu_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_engine_cpu_us_sum"] / n
