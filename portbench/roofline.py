"""Roofline shares: a kernel's least time over its time on the device.

The least time is the bytes the job's launches of the kernel must move,
each input byte read once and each output byte written once, over the
card's peak memory rate (every kernel here is bound by bytes; none does a
floating-point operation).  The bytes are those the function needs (the
reads' real length, not the padded rows; 4 bytes a 32-bit limb), not those
a kernel happens to move: a kernel that stops moving what it does not need
gets faster against the same bound, and reads higher.  A kernel's bytes live in ``rooflines/<name>.py``,
``<name>`` the kernel's wrapper in ``tpu_debruijn_torch.kernels`` (whose
``launches`` counter the traced run holds the trace to):
``KERNEL``, the substring of its device symbol in a trace; ``launches(shape)``
and ``job_bytes(shape)``, what one job's launches number and move, from the
read set's shape (:func:`shape_of`).
"""

from __future__ import annotations

from portbench.readers import load_file

SUFFIX = "_roofline"  # a metric <kernel>_roofline reads rooflines/<kernel>.py

# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bytes per second
PEAK_BYTES_PER_S = {"H100": 3.35e12}


def peak_bytes_per_s(kind: str) -> float:
    for name, rate in PEAK_BYTES_PER_S.items():
        if name in kind:
            return rate
    raise ValueError(f"no peak memory rate for {kind!r}")


def kernel(name: str):
    """The module ``rooflines/<name>.py``."""
    return load_file("rooflines", name)


def limbs(k: int) -> int:
    """32-bit limbs a kmer of k bases takes: 16 bases a limb."""
    return -(-k // 16)


def shape_of(cfg: dict, n_reads: int, distinct: int) -> dict:
    """The read set's shape: reads, read length, k, W, kmer observations
    (the reads' real ones), distinct canonical kmers, shards."""
    length, k = cfg["reads"]["length"], cfg["k"]
    return {"reads": n_reads, "length": length, "k": k,
            "w": limbs(k), "observations": n_reads * max(0, length - k + 1),
            "distinct": distinct, "shards": cfg.get("msp", {}).get("shards", 1)}


def share(ctx, name: str):
    """100 x the job's bytes over the peak rate, over the device time of the
    kernel's launches in the traced window; None without a trace of them
    or when the trace holds another number of launches than the jobs made."""
    tr = ctx.trace
    if tr is None:
        return None
    mod = kernel(name)
    count, seconds = tr.kernels.get(mod.KERNEL, (0, 0.0))
    if count == 0 or seconds <= 0 or count != ctx.jobs * mod.launches(ctx.shape):
        return None
    least = ctx.jobs * mod.job_bytes(ctx.shape) / peak_bytes_per_s(ctx.device_kind)
    return 100.0 * least / seconds
