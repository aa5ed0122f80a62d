"""Seconds a command-line job in the graph layer's per-node host loops: a
tuple a unitig in compress_kmers and a BaseGraph.add a node in
from_compress_output (assemble.run's stats, compress.nodes_s + graph.add_s)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "compress.nodes", "graph.add")
