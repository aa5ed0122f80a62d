"""Seconds a job in remove_censored_exts (the harness's span, synchronized at both ends)."""
from portbench.readers import mean_span


def read(ctx):
    return mean_span(ctx, "censor")
