"""shard_route_s: stream seconds per pass in the sharded path's routing
outside CUDA graphs: the destination sorts, the lane packing and the
one-process exchange of the sharded incidence's redistribution and
transpose and of friend clustering's co-occurrence sweep (the program's
span ``shard.route`` in ``dist/``, ``Engine.stats["shard.route.device_s"]``),
the mean over the window's passes.  The routing inside the count and
incidence steps' graphs is in their time, not here."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "shard.route.device_s")
