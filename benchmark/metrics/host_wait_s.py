"""host_wait_s: host seconds per pass spent blocked in the program's host
waits (the sum of every ``wait.<site>.host_s`` of ``Engine.stats``: the
host clock around each synchronising statement), the mean over the
window's passes; None where the program does not record them."""


def read(ctx):
    vals = [sum(v for k, v in p["stats"].items()
                if k.startswith("wait.") and k.endswith(".host_s"))
            for p in ctx["passes"] if "host_waits" in p["stats"]]
    return sum(vals) / len(vals) if vals else None
