"""serve.rows_per_cycle: requests a dispatch cycle of the batcher
carries (serve/batcher.py): d ipt_requests_total / d ipt_batches_total."""


def read(ctx):
    cycles = ctx.counters.get("ipt_batches_total", 0.0)
    if cycles <= 0:
        return None
    return ctx.counters["ipt_requests_total"] / cycles
