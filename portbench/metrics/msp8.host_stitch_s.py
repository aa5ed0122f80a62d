"""Seconds a job in assemble_sharded's host stitch: the chain pulls,
stitch_flat and the data reduce (its stats, final.stitch_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "final.stitch")
