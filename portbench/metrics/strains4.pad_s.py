"""Seconds a colored job picks out and pads the labelled reads on the host
(filter_kmers_set_arrays' stats, filter.pad_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "filter.pad")
