"""Device: the share of the profiled slice in which no operation ran on
the card, 1 - (union of device intervals) / (slice), in percent."""


def read(ctx):
    tr = ctx.trace
    if not tr or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
