"""Seconds a streamed job uploads, unpacks and counts its chunks
(filter_kmers_streaming's stats, stream.count_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "stream.count")
