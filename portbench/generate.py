"""Read sets from a seed, made on the device in a few large calls.

A configuration's ``genome`` and ``reads`` groups say what to make: a random
genome of ``genome.length`` bases, and reads of ``reads.length`` bases at
``reads.coverage``x, a share ``reads.rc_share`` of them reverse-complemented,
with Illumina-like errors.  Each read starts as a ``reads.window``-base
stretch of the genome.  Each window base is deleted at ``indel_rate``, and
an inserted uniform base follows it at the same rate; the result is cut to
``reads.length``.  After the strand flip each base is substituted at a rate
rising linearly along the read from ``substitution_rate[0]`` to
``substitution_rate[1]``, by one of the other three bases, uniform.

The same seed gives the same reads on the same kind of device; every seed
gives the same number of reads of the same length.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_LUT = np.frombuffer(b"ACGT", np.uint8)


def error_reads(cfg: dict, seed: int, device, genome_length=None, block: int = 1 << 17):
    """(n, read length) uint8 2-bit codes on ``device`` from ``seed``, made
    ``block`` reads at a time (which bounds the device memory it takes)."""
    g, r = cfg["genome"], cfg["reads"]
    glen = int(genome_length or g["length"])
    n = -(-r["coverage"] * glen // r["length"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    genome = torch.randint(0, 4, (glen,), generator=gen, device=device, dtype=torch.uint8)
    return torch.cat([_block(r, genome, min(block, n - lo), gen) for lo in range(0, n, block)])


def _block(r: dict, genome: torch.Tensor, n: int, gen) -> torch.Tensor:
    device = genome.device
    length, win = r["length"], r["window"]
    starts = torch.randint(0, genome.shape[0] - win + 1, (n,), generator=gen, device=device)
    stretch = genome[starts[:, None] + torch.arange(win, device=device)]
    del starts
    rate = r["indel_rate"]
    dele = torch.rand((n, win), generator=gen, device=device) < rate
    ins = torch.rand((n, win), generator=gen, device=device) < rate
    ins_base = torch.randint(0, 4, (n, win), generator=gen, device=device, dtype=torch.uint8)
    # window base j, then its inserted base: slots 2j and 2j + 1
    slots = torch.stack([stretch, ins_base], dim=2).reshape(n, 2 * win)
    keep = torch.stack([~dele, ins], dim=2).reshape(n, 2 * win)
    del stretch, ins_base, dele, ins
    if int(keep.sum(1, dtype=torch.int32).min()) < length:
        raise RuntimeError("a read lost more bases than its window holds")
    pos = keep.cumsum(1, dtype=torch.int16) - 1
    keep &= pos < length
    row = torch.arange(n, device=device)[:, None].expand(n, 2 * win)
    reads = torch.empty((n, length), dtype=torch.uint8, device=device)
    reads[row[keep], pos[keep].to(torch.int64)] = slots[keep]
    del slots, keep, pos, row
    flip = torch.rand(n, generator=gen, device=device) < r["rc_share"]
    reads[flip] = 3 - reads[flip].flip(1)
    lo, hi = r["substitution_rate"]
    sub = torch.rand((n, length), generator=gen, device=device) < torch.linspace(
        lo, hi, length, device=device)
    shift = torch.randint(1, 4, (n, length), generator=gen, device=device, dtype=torch.uint8)
    return torch.where(sub, (reads + shift) & 3, reads)


def write_fastq(path: str, reads: np.ndarray) -> None:
    """One record per row: '@r', the bases, '+', a constant quality."""
    n, l = reads.shape
    rec = np.empty((n, 3 + l + 3 + l + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + l] = _LUT[reads]
    rec[:, 3 + l : 6 + l] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + l : 6 + 2 * l] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path + ".part", "wb") as f:
        f.write(rec.tobytes())
    os.replace(path + ".part", path)
