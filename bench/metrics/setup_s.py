"""setup_s: host seconds from the harness's start to the first timed
job: imports, the CUDA context, loading (or, in a fresh checkout,
building) the kernel library, and a warm-up job of the cell's own
shape."""


def read(ctx):
    return ctx.setup_s
