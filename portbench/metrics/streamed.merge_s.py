"""Seconds a streamed job merges its chunks' tables into the device table
(filter_kmers_streaming's stats, stream.merge_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "stream.merge")
