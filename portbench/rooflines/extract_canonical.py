"""extract_canonical: the count's frontend, one launch a job.

What the function needs, at the reads' real length (no padding): in, the
reads' bases, one byte a base, and an int32 length and seq exts a read;
out, for each of the R * (L - k + 1) kmer observations, its W 32-bit limbs
(4 bytes a limb, though the kernel stores each in an int64), an int32
exts word and a bool."""

KERNEL = "extract_canonical_kernel"


def launches(shape: dict) -> int:
    return 1


def job_bytes(shape: dict) -> int:
    r = shape["reads"]
    return r * shape["length"] + 4 * r + 4 * r + shape["observations"] * (4 * shape["w"] + 4 + 1)
