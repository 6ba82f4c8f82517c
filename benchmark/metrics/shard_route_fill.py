"""shard_route_fill: the share of the sharded path's send-lane slots that
carry a key, over a pass: 100 x the keys placed in lanes (pads and drops
left out) / the slots of those lanes, every routing counted, those inside
the steps' CUDA graphs too (the program's counters ``shard.route_keys``
and ``shard.route_slots``, ``Engine.stats``), over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    keys = stat_mean(ctx, "shard.route_keys")
    slots = stat_mean(ctx, "shard.route_slots")
    if keys is None or not slots:
        return None
    return 100.0 * keys / slots
