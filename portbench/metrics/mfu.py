"""``mfu.<mode>``: the model's operations of one step or forward (the
reference family's ``work``: linears and aggregations, no plan work) over
the window's time a step times the card's f32 peak, in %."""


def read(ctx):
    return ctx.flops / (ctx.step_s * ctx.peaks.f32_flops_per_s) * 100
