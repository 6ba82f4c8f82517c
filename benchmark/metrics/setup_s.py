"""setup_s: the run's whole set-up, from the harness's start to the
window's: imports, the lane made from the seed, CUDA's start, the kernel's
build or load and one cold pass."""


def read(ctx):
    return ctx["window"]["setup_s"]
