"""``b1_roofline.<mode>``: the least time of a step's cold-tail sums
(``roofline.b1_least_seconds`` over the aggregations the model runs) over
the device time of the kernels that do them, in %. The kernels are found
by name in the trace (B1: ``shell_prefix_sum_kernel``); none found, the
metric is left out."""

KERNEL = "shell_prefix_sum_kernel"


def read(ctx):
    t = sum(s for name, (s, _n) in ctx.trace["ops"].items() if KERNEL in name)
    if t <= 0 or ctx.b1_least_s <= 0:
        return None
    return ctx.b1_least_s * ctx.trace["steps"] / t * 100
