"""Seconds a job in assemble_sharded's read padding (its stats, pad_reads_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "pad_reads")
