"""Seconds a streamed job pulls its packed blocks from the FASTQ file, the
native decode (filter_kmers_streaming's stats, stream.read_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "stream.read")
