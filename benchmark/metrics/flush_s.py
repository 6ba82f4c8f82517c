"""flush_s: stream seconds per pass in the count and pair tables'
sort-merges (the program's span ``table.flush`` in
``sorted_table.flush_grow``, ``Engine.stats["table.flush.device_s"]``: the
stream's time between its marks, idle time inside it included), the mean
over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "table.flush.device_s")
