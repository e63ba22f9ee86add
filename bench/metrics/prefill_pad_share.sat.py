"""prefill_pad_share.sat: the share of the positions that prefill and
chunk groups ran which held no prompt token: 100 × (1 − Δprefill_tokens
/ Δprefill_slots) over the window, where a group of ``bp`` slots at
``bucket`` positions counts ``bp × bucket`` (slots padding a group to
its tier included).  None where the program has no such counters or no
group ran."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"], ctx["stats1"]
    if "prefill_slots" not in s0 or "prefill_slots" not in s1:
        return None
    slots = s1["prefill_slots"] - s0["prefill_slots"]
    if slots <= 0:
        return None
    tokens = s1["prefill_tokens"] - s0["prefill_tokens"]
    return 100.0 * (1.0 - tokens / slots)
