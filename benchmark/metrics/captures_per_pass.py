"""captures_per_pass: step shapes captured into CUDA graphs per pass (the
program's counter ``graph_captures``, ``Engine.stats``), the mean over the
window's passes.  A fresh engine captures each shape anew."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "graph_captures")
