"""Seconds a job in assemble_sharded's stitch and final graph (its stats,
stitch_s + final_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "stitch", "final")
