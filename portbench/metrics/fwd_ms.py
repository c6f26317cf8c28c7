"""``fwd_ms.train``: device milliseconds a step between the CUDA events
around the harness's forward and loss calls, in the traced segment."""


def read(ctx):
    spans = ctx.trace["spans_ms"]
    if "forward" not in spans or "loss" not in spans:
        return None
    return spans["forward"] + spans["loss"]
