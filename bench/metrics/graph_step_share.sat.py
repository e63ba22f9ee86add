"""graph_step_share.sat: engine steps replayed as CUDA Graphs over all
engine steps (decode, prefill groups and chunk groups), differenced
across the window."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"], ctx["stats1"]

    def d(k):
        return s1[k] - s0[k]
    steps = d("decode_steps") + d("prefill_steps") + d("chunk_steps")
    if steps <= 0:
        return None
    replays = (d("graph_replays") + d("prefill_graph_replays")
               + d("chunk_graph_replays"))
    return 100.0 * replays / steps
