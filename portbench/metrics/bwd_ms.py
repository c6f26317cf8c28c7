"""``bwd_ms.train``: device milliseconds a step between the CUDA events
around the harness's ``loss.backward()``, in the traced segment."""


def read(ctx):
    return ctx.trace["spans_ms"].get("backward")
