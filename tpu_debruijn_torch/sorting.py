"""Sort and search primitives on limb tensors (counterpart of ``tpu_debruijn/sorting.py``).

The JAX package sorts with ``jax.lax.sort`` over several key arrays.  Here
a kmer's limbs are packed into int64 sort keys: two 32-bit limbs make one
key, biased by 2**63 so that signed int64 order is the unsigned order.
W <= 2 sorts in one ``torch.sort`` pass; W = 3-4 takes two stable passes,
least-significant key first (LSD), and a (kmer, label) pair of W + 1 = 5
limbs three.  Searches use ``torch.searchsorted`` on
the packed key for W <= 2 and a vectorized binary search over the limbs
for W > 2.  The row gathers of the LSD passes, the searches and the join go
through :func:`~tpu_debruijn_torch.kernels.gather.gather_rows` (the kernel
on a CUDA tensor, plain indexing on a CPU one).
"""

from __future__ import annotations

import math

import torch

from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch.kernels.gather import gather_rows

_BIAS = -(1 << 63)  # flips the sign bit of a packed pair of limbs


def _pack_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return ((hi << 32) | lo) ^ _BIAS


def pack_keys(limbs: torch.Tensor) -> list:
    """(n, W) limbs -> int64 keys, most significant first, whose
    lexicographic order is the limbs' lexicographic order: pairs of limbs
    from the last one up, an odd first limb alone.  W may exceed 4: a
    (kmer, label) pair key has W + 1 limbs."""
    w = limbs.shape[1]
    keys = [limbs[:, 0]] if w % 2 else []
    return keys + [_pack_pair(limbs[:, i], limbs[:, i + 1]) for i in range(w % 2, w, 2)]


def lex_argsort(limbs: torch.Tensor) -> torch.Tensor:
    """Stable permutation that sorts the rows of ``limbs`` lexicographically."""
    perm = None
    for key in reversed(pack_keys(limbs)):  # LSD: least significant key first
        _, p = torch.sort(key if perm is None else gather_rows(key, perm), stable=True)
        perm = p if perm is None else gather_rows(perm, p)
    return perm


def sort_with_payload(limbs: torch.Tensor, payloads=()):
    """Stable lexicographic sort of the rows of ``limbs``, carrying payload
    tensors.  Returns (sorted_limbs, sorted_payloads)."""
    perm = lex_argsort(limbs)
    return limbs[perm], [p[perm] for p in payloads]


lex_eq = KM.eq
lex_lt = KM.lt


def run_starts(sorted_limbs: torch.Tensor) -> torch.Tensor:
    """True at the first row of each run of equal rows."""
    n = sorted_limbs.shape[0]
    starts = torch.ones(n, dtype=torch.bool, device=sorted_limbs.device)
    if n > 1:
        starts[1:] = ~lex_eq(sorted_limbs[1:], sorted_limbs[:-1])
    return starts


def copy_first(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Segmented copy-first: each element gets ``vals`` at the start of its
    segment (``flags`` mark starts); elements before the first start get
    ``vals[0]``, as the JAX package's ``_copy_first_packed`` gives them.

    The running count of starts indexes the list of start positions: one
    cumulative sum and two gathers (``torch.cummax`` over the start
    positions gives the same, several times slower on the card).
    """
    zero = torch.zeros(1, dtype=torch.int64, device=vals.device)
    starts = torch.cat([zero, torch.nonzero(flags).flatten()])
    return vals[starts[torch.cumsum(flags, 0)]]


def copy_last(vals: torch.Tensor, is_end: torch.Tensor) -> torch.Tensor:
    """Segmented copy-last: each element gets ``vals`` at the end of its
    segment (``is_end`` marks ends); :func:`copy_first` run backwards."""
    return copy_first(vals.flip(0), is_end.flip(0)).flip(0)


def segment_min(vals: torch.Tensor, seg: torch.Tensor, n_seg: int, reduce: str = "amin") -> torch.Tensor:
    """Minimum (``reduce="amax"``: maximum) of ``vals`` over each segment
    id in ``[0, n_seg)``; every segment must hold an element.  Where the JAX
    package reads a suffix segmented min or max at segment starts
    (``compress._min_suffix_packed``, ``sorting.seg_op_scan``), this gives
    the same values with one scatter."""
    out = torch.zeros(n_seg, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg, vals, reduce, include_self=False)


def partition(mask: torch.Tensor, arrays):
    """Stable partition: rows where ``mask`` holds move to the front, in
    order, followed by the others in order.  Returns (count, arrays)."""
    order = torch.cat([torch.nonzero(mask).flatten(), torch.nonzero(~mask).flatten()])
    return int(mask.sum()), [a[order] for a in arrays]


def searchsorted_limbs(sorted_limbs: torch.Tensor, query_limbs: torch.Tensor):
    """Lower bound of each query row in lexicographically sorted rows.

    Returns (idx, found): idx = first row with sorted >= query, found =
    idx in range and an exact match.  ``searchsorted_limbs.wide_rows``
    counts the query rows times the rounds that the W > 2 search ran, over
    every call (a host integer from the shapes; W <= 2 counts nothing).
    """
    n, w = sorted_limbs.shape
    m = query_limbs.shape[0]
    dev = query_limbs.device
    if n == 0:
        return (torch.zeros(m, dtype=torch.int64, device=dev),
                torch.zeros(m, dtype=torch.bool, device=dev))
    # gather_rows clamps an index of n to the last row
    if w <= 2:
        skey = pack_keys(sorted_limbs)[0].contiguous()
        qkey = pack_keys(query_limbs)[0].contiguous()
        idx = torch.searchsorted(skey, qkey)
        found = (idx < n) & (gather_rows(skey, idx) == qkey)
        return idx, found
    sorted_limbs = sorted_limbs.contiguous()  # once, not per gather
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    rounds = max(1, math.ceil(math.log2(n + 1)))
    _SEARCH_COUNTS.wide_rows += m * rounds
    for _ in range(rounds):
        mid = (lo + hi) // 2
        # a converged query (lo == hi) stays put: at lo = n the clamped
        # gather would read the last row and step past the end
        is_lt = lex_lt(gather_rows(sorted_limbs, mid), query_limbs) & (lo < hi)
        lo = torch.where(is_lt, mid + 1, lo)
        hi = torch.where(is_lt, hi, mid)
    found = (lo < n) & lex_eq(gather_rows(sorted_limbs, lo), query_limbs)
    return lo, found


searchsorted_limbs.wide_rows = 0  # query rows x rounds of the W > 2 search, over every call
_SEARCH_COUNTS = searchsorted_limbs  # where the count goes, should a caller rebind the module's name


def join_limbs(sorted_limbs: torch.Tensor, query_limbs: torch.Tensor,
               table_vals: torch.Tensor):
    """Exact-match join of queries against a sorted unique table.

    Returns what ``sort_join_limbs`` returns in the JAX package: (idx,
    found, vals) with idx the matching table row (arbitrary where not
    found) and vals the matched row's ``table_vals``.
    """
    idx, found = searchsorted_limbs(sorted_limbs, query_limbs)
    vals = gather_rows(table_vals, idx) if sorted_limbs.shape[0] else torch.zeros_like(idx)
    return idx, found, vals
