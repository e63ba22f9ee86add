"""setup_s: process start to the first timed instant, compilation,
weights, warm-up and the traffic that settles the mix included."""


def read(ctx):
    return ctx["setup_s"]
