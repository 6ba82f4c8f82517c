"""device_idle_share: the share of the profiled pass's wall in which no
kernel, copy or set ran on the device, in percent."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
