"""msp_scan_reads: the MSP scan from the bases, one launch a shard's source
block (the reads cut into ``shards`` contiguous blocks).

What the function needs, at the reads' real length (no padding): in, a
block's bases, one byte a base; out, for each of its kmer positions,
r * (L - k + 1), a bool flag, an int32 minimizer rank and an int32
position."""

KERNEL = "msp_scan_reads_kernel"


def launches(shape: dict) -> int:
    per = -(-shape["reads"] // shape["shards"])
    return -(-shape["reads"] // per)


def job_bytes(shape: dict) -> int:
    return shape["reads"] * shape["length"] + shape["observations"] * (1 + 4 + 4)
