"""Seconds a colored job re-compresses the graph after tip removal, joining
nodes only where their eq-class ids are equal (clean_tips' stats,
clean.compress_graph_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "clean.compress_graph")
