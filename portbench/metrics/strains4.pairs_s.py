"""Seconds a colored job counts the (kmer, label) pairs (count_kmer_pairs;
filter_kmers_set_arrays' stats, filter.pairs_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "filter.pairs")
