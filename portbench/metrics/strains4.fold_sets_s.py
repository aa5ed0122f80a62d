"""Seconds a colored job folds the kmers' sets into each unitig's set and
copies them to the host (compress_kmers_color_sets' stats,
compress.fold_sets_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "compress.fold_sets")
