"""lane_s: host seconds per pass building the lane on the device: the
barcode sort, the batching and the copy (the program's span ``lane`` in
``Engine._lane``, ``Engine.stats["lane.host_s"]``), the mean over the
window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "lane.host_s")
