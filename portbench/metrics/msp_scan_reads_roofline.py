"""msp_scan_reads' share of its bytes-once bound, summed over a job's launches."""
from portbench.roofline import share


def read(ctx):
    return share(ctx, "msp_scan_reads")
