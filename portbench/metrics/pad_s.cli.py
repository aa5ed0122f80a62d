"""Seconds a command-line job picks out and pads its reads on the host in
filter_kmers (assemble.run's stats, filter.pad_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "filter.pad")
