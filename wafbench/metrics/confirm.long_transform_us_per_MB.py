"""confirm.long_transform_us_per_MB: microseconds the confirm's transform
chains take on values too long for the transform memo (models/confirm.py
ConfirmRule._transformed_iter: a 1 MiB body and its long arguments) per
10^6 bytes they read, from the server's counters over the window:
d ipt_confirm_long_transform_us_sum /
(d ipt_confirm_long_transform_bytes_total / 1e6)."""


def read(ctx):
    mb = ctx.counters.get("ipt_confirm_long_transform_bytes_total", 0.0) / 1e6
    if mb <= 0 or "ipt_confirm_long_transform_us_sum" not in ctx.counters:
        return None
    return ctx.counters["ipt_confirm_long_transform_us_sum"] / mb
