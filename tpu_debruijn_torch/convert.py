"""Move a kmer table or a graph between the JAX package and the port.

This system has no weights: the state the two packages share is the kmer
table and the graph.  The JAX package's ``KmerTable`` holds numpy arrays
(uint32 limbs, int32 columns); the port's holds int64 limb and int32
tensors on a device.  Both packages' graphs keep numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch.filter import KmerTable
from tpu_debruijn_torch.graph import BaseGraph
from tpu_debruijn_torch.kmer import KmerSpec


def table_from_reference(spec_k: int, stranded: bool, kmers_u32, exts, counts, data,
                         device="cuda") -> KmerTable:
    """A JAX ``KmerTable``'s numpy arrays -> the port's table on ``device``."""
    col = lambda a: torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)
    return KmerTable(
        spec=KmerSpec(spec_k),
        stranded=stranded,
        kmers=KM.to_torch(kmers_u32, device).reshape(-1, KmerSpec(spec_k).w),
        exts=col(exts),
        counts=col(counts),
        data=col(data),
    )


def table_to_numpy(table: KmerTable) -> dict:
    """The port's table -> numpy arrays in the JAX package's dtypes:
    ``kmers`` (n, W) uint32, ``exts``/``counts``/``data`` (n,) int32, and
    ``all_kmers`` when the table has a census."""
    out = {
        "kmers": KM.to_numpy(table.kmers),
        "exts": table.exts.cpu().numpy().astype(np.int32),
        "counts": table.counts.cpu().numpy().astype(np.int32),
        "data": table.data.cpu().numpy().astype(np.int32),
    }
    if table.all_kmers is not None:
        out["all_kmers"] = KM.to_numpy(table.all_kmers)
    return out


def graph_from_reference(graph) -> BaseGraph:
    """A JAX ``BaseGraph`` or ``DebruijnGraph`` -> the port's ``BaseGraph``
    from its numpy arrays: flat bases, lengths, exts, data and the ``rich``
    sidecar (copied as a list).  Call ``.finish(device=...)`` on it."""
    base = getattr(graph, "base", graph)
    seqs = base.sequences
    out = BaseGraph(base.spec.k, base.stranded)
    out.add_flat(seqs._flat(), seqs.length, base.exts, base.data,
                 rich=None if base.rich is None else list(base.rich))
    return out
