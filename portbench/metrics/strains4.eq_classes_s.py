"""Seconds a colored job groups the kmers' sets into eq classes
(eq_class_ids; compress_kmers_color_sets' stats, compress.eq_classes_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "compress.eq_classes")
