"""run_reduce_rows: the count's tail, one launch a job over the sorted rows.

In: one packed row an observation (4 int32 words for W <= 2, else 8).  Out:
one row a run of equal kmers (a distinct kmer), and the number of runs."""

KERNEL = "run_reduce_rows_kernel"


def launches(shape: dict) -> int:
    return 1


def job_bytes(shape: dict) -> int:
    row = 4 * (4 if shape["w"] <= 2 else 8)
    return row * shape["observations"] + row * shape["distinct"] + 4
