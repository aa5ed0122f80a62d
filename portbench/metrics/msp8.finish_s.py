"""Seconds a job builds assemble_sharded's final graph, add_flat and finish
(its stats, final.finish_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "final.finish")
