"""Labelled reads of several strains, derived from a cell's read set.

The harness makes one read set from the seed (:func:`generate.error_reads`)
and hands it, and only it, to a job and to the reference.  A colored cell
derives its labelled reads from that set, so that the job and the reference
make the same reads on the same kind of device:

- a strain seed, from a digest of the read set's shape and first rows;
- an ancestor genome of ``genome.length`` random bases (fewer where the read
  set is smaller than the configuration's, as in a test at a small genome:
  as many as the read count covers at ``reads.coverage``);
- ``strains.count`` strains, each the ancestor with its own substitutions,
  one at every ``strains.snp_every`` bases on average, at distinct positions
  drawn uniformly, each base replaced by one of the other three, uniform;
- the read set's count of reads split into near-equal parts in strain
  order, each part sampled from its strain with the configuration's error
  model (:func:`generate._block`) and labelled with the strain's index.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench import generate

DIGEST_ROWS = 4096  # rows of the read set the strain seed is drawn from


def strain_seed(reads) -> int:
    """A 63-bit seed from the read set's shape and its first rows (numpy or
    a tensor on any device: the same bytes give the same seed)."""
    head = reads[:DIGEST_ROWS]
    head = head.cpu().numpy() if torch.is_tensor(head) else np.asarray(head)
    h = hashlib.blake2b(np.ascontiguousarray(head, np.uint8).tobytes(), digest_size=8)
    h.update(repr(tuple(reads.shape)).encode())
    return int.from_bytes(h.digest(), "little") >> 1


def part_sizes(n: int, parts: int) -> list:
    """``n`` split into ``parts`` near-equal whole parts, the larger first."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def ancestor_length(cfg: dict, n_reads: int) -> int:
    r = cfg["reads"]
    return min(int(cfg["genome"]["length"]), n_reads * r["length"] // r["coverage"])


def labelled_reads(cfg: dict, reads, device, block: int = 1 << 17):
    """(reads (n, read length) uint8, labels (n,) int32) on ``device``, n the
    read count of ``reads`` (the harness's set), made ``block`` reads at a
    time; strain i's reads are the i-th part and carry label i."""
    n = int(reads.shape[0])
    s = cfg["strains"]
    glen = ancestor_length(cfg, n)
    gen = torch.Generator(device=device).manual_seed(strain_seed(reads))
    ancestor = torch.randint(0, 4, (glen,), generator=gen, device=device, dtype=torch.uint8)
    n_snps = glen // s["snp_every"]
    out, labels = [], []
    for label, size in enumerate(part_sizes(n, s["count"])):
        strain = ancestor.clone()
        pos = torch.randperm(glen, generator=gen, device=device)[:n_snps]
        shift = torch.randint(1, 4, (n_snps,), generator=gen, device=device, dtype=torch.uint8)
        strain[pos] = (strain[pos] + shift) & 3
        out += [generate._block(cfg["reads"], strain, min(block, size - lo), gen)
                for lo in range(0, size, block)]
        labels.append(torch.full((size,), label, dtype=torch.int32, device=device))
    return torch.cat(out), torch.cat(labels)
