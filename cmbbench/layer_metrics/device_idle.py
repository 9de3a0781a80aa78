"""``device_idle``: the share (%) of the traced device window in which no
kernel, copy or fill ran."""


def read(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
