"""Seconds a job in the list of reads K long that sharded_tables makes
(assemble_sharded's stats, select_reads_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "select_reads")
