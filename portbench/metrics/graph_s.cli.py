"""Seconds a command-line job in compress + graph build, clean_tips and export
(assemble.run's stats)."""
from portbench.readers import mean_stat


def read(ctx):
    return mean_stat(ctx, "compress", "clean_tips", "export")
