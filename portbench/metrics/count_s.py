"""Seconds a job in filter_kmers (the harness's span, synchronized at both ends)."""
from portbench.readers import mean_span


def read(ctx):
    return mean_span(ctx, "count")
