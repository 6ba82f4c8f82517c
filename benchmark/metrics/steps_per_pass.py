"""steps_per_pass: the multi-batch device steps a pass sends in count and
incidence (``Engine.stats["dispatches"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "dispatches")
