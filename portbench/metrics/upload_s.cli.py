"""Seconds a command-line job uploads the padded reads in filter_kmers
(assemble.run's stats, filter.upload_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "filter.upload")
