"""req_per_s: verdicts that came back inside the window, over the window."""


def read(ctx):
    return sum(1 for _ in ctx.done_in_window()) / ctx.seconds
