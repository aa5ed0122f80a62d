"""extract_canonical's share of its bytes-once bound (rooflines/)."""
from portbench.roofline import share


def read(ctx):
    return share(ctx, "extract_canonical")
