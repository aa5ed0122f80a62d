"""Seconds a colored job rolls the (kmer, label) pairs up per kmer and
applies min_obs (_pair_table; filter_kmers_set_arrays' stats,
filter.pair_table_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "filter.pair_table")
