"""Seconds a command-line job builds the graph's end-kmer indexes,
BaseGraph.finish (assemble.run's stats, graph.finish_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "graph.finish")
