"""peak_device_gb: ``torch.cuda.max_memory_allocated`` over the window's
passes (the peak is reset after set-up), in 10^9 bytes."""


def read(ctx):
    peak = ctx["window"]["peak_bytes"]
    return peak / 1e9 if peak else None
