"""Seconds a job in the graph layer: from_compress_output(...).finish(),
clean_tips and to_gfa (the harness's spans)."""
from portbench.readers import mean_span


def read(ctx):
    return mean_span(ctx, "graph_build", "clean_tips", "gfa")
