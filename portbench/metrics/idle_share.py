"""``idle_share.<mode>``: the share of the traced segment's wall time in
which no device operation ran, in %."""


def read(ctx):
    t = ctx.trace
    return (1 - t["busy_s"] / t["window_s"]) * 100
