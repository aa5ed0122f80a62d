"""Seconds from the start of the process to the start of the window: imports,
the build or load of the kernels, the read set, its file and the warm-up."""


def read(ctx):
    return ctx.setup_s
