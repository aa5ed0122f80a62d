"""Seconds a job in compress_kmers (the harness's span)."""
from portbench.readers import mean_span


def read(ctx):
    return mean_span(ctx, "compress")
