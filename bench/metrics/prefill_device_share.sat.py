"""prefill_device_share.sat: the share of the engine graphs' device time
spent in prefill and chunk groups: 100 × the device seconds of the
``prefill/…`` and ``chunk/…`` device spans over those of every device
span, differenced across the window (``repro_torch.spans``: CUDA events
around each graph replay).  None where the program has no device spans
or none ended in the window."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"].get("device_spans"), \
        ctx["stats1"].get("device_spans")
    if s0 is None or s1 is None:
        return None
    d = {k: v[1] - s0.get(k, (0, 0.0))[1] for k, v in s1.items()}
    total = sum(d.values())
    if total <= 0:
        return None
    pre = sum(v for k, v in d.items()
              if k.split("/", 1)[0] in ("prefill", "chunk"))
    return 100.0 * pre / total
