"""confirm.candidates_per_req: prefilter candidates a request sends to
confirm, the work a pack hands the confirm stage: d
ipt_prefilter_hits_total / d ipt_requests_total (the confirmed share goes
to standard error)."""


def read(ctx):
    n = ctx.counters.get("ipt_requests_total", 0.0)
    cand = ctx.counters.get("ipt_prefilter_hits_total", 0.0)
    if n <= 0:
        return None
    if cand > 0:
        ctx.notes.append(
            "confirm: %.0f of %.0f candidates confirmed (%.2f%%)"
            % (ctx.counters.get("ipt_confirmed_hits_total", 0.0), cand,
               100.0 * ctx.counters.get("ipt_confirmed_hits_total", 0.0)
               / cand))
    return cand / n
