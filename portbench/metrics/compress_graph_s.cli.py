"""Seconds a command-line job in clean_tips' compress_graph
(assemble.run's stats, clean.compress_graph_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "clean.compress_graph")
