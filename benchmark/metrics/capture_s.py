"""capture_s: host seconds per pass capturing the steps' CUDA graphs,
warm-up and synchronisation included (the program's span ``step.capture``,
``Engine.stats["step.capture.host_s"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "step.capture.host_s")
