"""setup_s: from the benchmark's start to the measured window's opening:
the server's start (kernel build on a first run, load, bake-off,
warm-up), the client's traffic and its warm-up."""


def read(ctx):
    return ctx.setup_s
