"""cluster_s: seconds per pass in Engine.cluster (the span ``cluster``, the
device synchronised on both sides), the mean over the window's passes."""

from benchmark.readers import span_mean


def read(ctx):
    return span_mean(ctx, "cluster")
