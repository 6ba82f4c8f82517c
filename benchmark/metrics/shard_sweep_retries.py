"""shard_sweep_retries: passes, sweeps and routings of the sharded path run
again with doubled lanes after a lane overflow, per pass (the program's
counter ``shard.sweep_retries``, ``Engine.stats``), the mean over the
window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "shard.sweep_retries")
