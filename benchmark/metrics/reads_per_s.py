"""reads_per_s: every read of every pass in the window over the time from
the first pass's start to the last pass's end."""


def read(ctx):
    w = ctx["window"]
    return w["reads"] / w["seconds"] if w["seconds"] > 0 else None
