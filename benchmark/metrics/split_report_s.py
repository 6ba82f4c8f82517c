"""split_report_s: seconds per pass in Engine.split and Engine.report (the
span ``split_report``, the device synchronised on both sides), the mean
over the window's passes."""

from benchmark.readers import span_mean


def read(ctx):
    return span_mean(ctx, "split_report")
