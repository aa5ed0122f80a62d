"""Hamming-distance-1 neighbor enumeration (counterpart of ``tpu_debruijn/neighbors.py``).

rust-debruijn's neighbors.rs (KmerOneHammingIter).  The host generator
keeps the reference iterator's order: position-major, bases ascending,
the original base skipped.  The batched form is ``kmer.hamming_neighbors``
(all 3K variants of a whole kmer tensor at once).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch.kmer import KmerSpec


def one_hamming_iter(spec: KmerSpec, limbs) -> Iterator[np.ndarray]:
    """Yield the 3K HD-1 neighbors of one kmer as (W,) uint32 limbs
    (neighbors.rs:4-52 order)."""
    bases = KM.to_bases(spec, limbs)
    for pos in range(spec.k):
        orig = int(bases[pos])
        for b in range(4):
            if b == orig:
                continue
            mutated = bases.copy()
            mutated[pos] = b
            yield KM.from_bases(spec, mutated)
