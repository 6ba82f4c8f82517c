"""host_waits_per_pass: the times a pass makes the host wait for the card
(``Engine.stats["host_waits"]``: the program's counter of its
synchronising statements, each inside ``utils/timing.wait`` under its
site's name), the mean over the window's passes; None where the program
does not count them."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "host_waits")
