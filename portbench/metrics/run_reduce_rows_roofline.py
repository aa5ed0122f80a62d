"""run_reduce_rows' share of its bytes-once bound (rooflines/)."""
from portbench.roofline import share


def read(ctx):
    return share(ctx, "run_reduce_rows")
