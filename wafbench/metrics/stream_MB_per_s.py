"""stream_MB_per_s: body bytes (10**6 to the MB) of uploads served in
the window, over the window.  An upload's bytes are credited to the time
it was in flight, from when it was sent to its verdict, spread evenly:
the window gets the share of each upload that it overlaps.  Only uploads
whose verdict came back are credited.  (Crediting whole uploads at their
verdict would make the rate step by one upload, a 1 MiB body, about 5%
of a window's bytes.)"""


def read(ctx):
    rec = ctx.rec
    t0, t1 = rec["t_open"], rec["t_close"]
    total = 0.0
    for rid, ts, nbytes in zip(rec["req_id"], rec["t_sent"],
                               rec["body_bytes"]):
        td = rec["t_done"].get(rid)
        if td is None or td <= ts:
            continue
        total += nbytes * max(0.0, min(td, t1) - max(ts, t0)) / (td - ts)
    return total / 1e6 / ctx.seconds
