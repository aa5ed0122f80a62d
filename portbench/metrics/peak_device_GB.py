"""The highest peak of allocated device memory of any job of the window, in
10^9 bytes (the peak statistics are reset before each job)."""


def read(ctx):
    return max(ctx.peaks) / 1e9 if ctx.peaks else None
