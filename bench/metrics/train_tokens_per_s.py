"""train_tokens_per_s: B x S x the steps completed in the window, over
the window's seconds; a synchronise closes the window."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["steps"] * ctx["tokens_per_step"] / ctx["window_s"]
