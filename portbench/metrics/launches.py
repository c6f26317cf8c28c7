"""``launches.<mode>``: device operations (kernels, copies, fills) a step
or forward in the traced segment."""


def read(ctx):
    return ctx.trace["launches"] or None
