"""Seconds a command-line job reads its FASTQ file (assemble.run's stats, read_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "read")
