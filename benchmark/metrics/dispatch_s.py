"""dispatch_s: host seconds per pass dispatching the multi-batch steps,
their graph captures left out: the self time of the program's span
``step`` over its child ``step.capture`` (``Engine.stats["step.host_s"]``
less ``["step.capture.host_s"]``, 0 where no graph was captured), the mean
over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    step = stat_mean(ctx, "step.host_s")
    if step is None:
        return None
    return step - (stat_mean(ctx, "step.capture.host_s") or 0.0)
