"""``peak_gib.train``: ``torch.cuda.max_memory_allocated()`` over the
window (reset at its start), in GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2**30 or None
