"""sketch_roofline: the least time of a pass's sketch work (``work.py``: one
sketch of the lane for each count or incidence stage) over the summed
device time of the sketch kernel in the profiled pass, in percent."""

from benchmark.work import least_seconds, sketch_work

KERNEL = "sketch_kernel"   # the CUDA kernel's name in the trace


def read(ctx):
    trace, lane = ctx.get("trace"), ctx["lane"]
    if not trace or lane.get("emitted") is None:
        return None
    kernel_s = sum(b - a for a, b, name in trace["spans"]
                   if KERNEL in name) / 1e6
    sketches = sum(s["call"] in ("count", "incidence")
                   for s in ctx["traffic"]["stages"])
    if kernel_s <= 0 or not sketches:
        return None
    nbytes, ops = sketch_work(lane["n_reads"], lane["read_len"], lane["k"],
                              lane["emitted"])
    least, _ = least_seconds(sketches * nbytes, sketches * ops)
    return 100 * least / kernel_s
