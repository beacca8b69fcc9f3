"""``device_idle_share`` (device, the H100): the share of the profiled
stretch of the loop (``trace.stretch``) in which the card runs no kernel,
copy or set."""


def read(ctx):
    s = ctx.stretch
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
