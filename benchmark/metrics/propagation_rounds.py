"""propagation_rounds: rounds of friend clustering's label propagation per
pass (``cluster/sparse.py``'s ``STATS["rounds"]``), the mean over the
window's passes.  The lane sets it: a seed whose components settle a round
sooner passes faster."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "propagation_rounds")
