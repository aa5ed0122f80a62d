"""Minimum-substring partition (MSP): the minimizer scan that shards kmers.

Counterpart of ``tpu_debruijn/msp.py`` (rust-debruijn's msp.rs: Scanner
:159-277, msp_sequence :279-324; MSPKmerCounter, Li 2015).  The same
semantics: the MinPos tie-break prefers the *rightmost* position on equal
scores (msp.rs:127-141), and a new minimum is taken mid-window only when it
is strictly smaller (msp.rs:237-248).  The p-mer ranks and scores of
every read position and the scanner's recurrence over its kmer positions
(JAX's ``lax.scan``) are one call of ``kernels.msp_scan_reads``: on a CUDA
tensor one launch of ``csrc/msp_scan.cu`` from the read bases, on a CPU
tensor its plain version (ranks by the plain kmer extractor, a windowed
minimum and a loop carrying every read's (value, position) state).

Every kmer of a read lands in exactly one interval; intervals hold p to
2k - p bases; an interval's bucket is its rc-canonical minimizer rank
(msp.rs:115-117), the shard key of ``tpu_debruijn_torch.parallel``.

Scores and positions are int32.  A p-mer rank is a uint32 bit pattern (all
32 bits at p = 16); the scan holds its int32 view, as JAX does, and
:func:`msp_intervals_device` returns ranks and buckets as int64 values in
[0, 2^32).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch.filter import pad_reads
from tpu_debruijn_torch.kernels.msp_scan import msp_scan_reads, msp_scores, pmer_ranks  # noqa: F401
from tpu_debruijn_torch.kmer import M32, KmerSpec


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def msp_scan_batch(k: int, p: int, bases: torch.Tensor, lengths: torch.Tensor,
                   permutation=None, rc: bool = True):
    """Scanner::scan over a padded read batch, on the batch's device.

    Returns (R, Lk) tensors, Lk = L - k + 1: ``new_interval`` (bool, a new
    interval starts at kmer index i), ``min_rank`` (int32 view of the
    minimizer p-mer rank of the interval active at i), ``min_pos`` (int32
    minimizer position) and ``valid`` (i <= len - k).  ``permutation`` is a
    (4^p,) score table (p <= 15), as in JAX.
    """
    lk = bases.shape[1] - k + 1
    flags, min_rank, mposs = msp_scan_reads(bases, k, p, permutation, rc)
    pos = torch.arange(lk, dtype=torch.int32, device=bases.device)[None, :]
    valid = pos <= (lengths.to(torch.int32)[:, None] - k)
    return flags & valid, min_rank, mposs, valid


def msp_intervals_device(k: int, p: int, bases: torch.Tensor, lengths: torch.Tensor,
                         permutation=None, rc: bool = True) -> dict:
    """The interval table of a padded read batch, on the batch's device.

    Returns a dict of (n,) tensors, in read order and then position order:
    ``read``, ``start``, ``length``, ``minimizer_pos`` and ``exts`` (int32),
    ``minimizer_rank`` and ``bucket`` (int64 in [0, 2^32): the bucket is the
    rc-canonical minimizer rank), and ``n_intervals`` (a host int).  JAX
    pads every column to R * Lk slots; here n is the interval count.
    """
    lk = bases.shape[1] - k + 1
    flags, min_rank, min_pos, _ = msp_scan_batch(k, p, bases, lengths, permutation, rc)
    sel = torch.nonzero(flags.reshape(-1)).flatten()
    n = sel.shape[0]
    read, pos = sel // lk, sel % lk
    length = lengths.to(torch.int64)[read]
    last_start = length - k  # the final kmer index of the read
    # an interval ends where the next one of its read starts (msp.rs:253-273)
    nxt = torch.full((n,), lk, dtype=torch.int64, device=sel.device)
    if n > 1:
        nxt[:-1] = torch.where(read[1:] == read[:-1], pos[1:], lk)
    next_start = torch.minimum(nxt, last_start + 1)
    ilen = torch.where(next_start <= last_start, next_start + (k - 1) - pos, length - pos)
    # the interval's exts within its read (lib.rs:645-660)
    flat = bases.reshape(-1).to(torch.int64)
    l = bases.shape[1]
    left = torch.where(pos > 0, 1 << flat[read * l + (pos - 1).clamp(min=0)], 0)
    right_idx = pos + ilen
    right = torch.where(right_idx < length, 1 << flat[read * l + right_idx.clamp(max=l - 1)], 0)
    rank = _u32(min_rank.reshape(-1)[sel])
    bucket = torch.minimum(rank, KM.rc(KmerSpec(p), rank[:, None])[:, 0])
    i32 = lambda t: t.to(torch.int32)
    return {
        "n_intervals": n,
        "read": i32(read),
        "start": i32(pos),
        "length": i32(ilen),
        "minimizer_rank": rank,
        "minimizer_pos": min_pos.reshape(-1)[sel],
        "bucket": bucket,
        "exts": i32((left & 0xF) | ((right & 0xF) << 4)),
    }


def gather_interval_bases(k: int, p: int, bases: torch.Tensor, intervals: dict) -> torch.Tensor:
    """Interval substrings as an (n, 2k - p) uint8 matrix, zero past each
    interval's length (JAX's int32 lanes hold the same values)."""
    maxlen = 2 * k - p
    l = bases.shape[1]
    t = torch.arange(maxlen, device=bases.device)[None, :]
    idx = (intervals["start"].to(torch.int64)[:, None] + t).clamp(max=l - 1)
    sub = bases.reshape(-1)[intervals["read"].to(torch.int64)[:, None] * l + idx]
    return torch.where(t < intervals["length"][:, None], sub, 0).to(torch.uint8)


# ---------------------------------------------------------------------------
# the host API of msp.rs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MspInterval:
    """One MSP substring of a sequence (msp.rs:13-51): ``bucket`` is the
    rc-canonical minimizer p-mer value, ``start``/``len`` the substring."""

    bucket: int
    start: int
    len: int

    @property
    def end(self) -> int:
        return self.start + self.len

    @property
    def range(self) -> range:
        return range(self.start, self.start + self.len)


def _batch(seqs, k: int, device):
    bases, lengths = pad_reads(seqs, min_len=k, pad_to=16)
    return torch.from_numpy(bases).to(device), torch.from_numpy(lengths).to(device)


def simple_scan(k: int, seq, permutation: Optional[np.ndarray] = None, rc: bool = True,
                p: Optional[int] = None, device="cuda") -> List[MspInterval]:
    """MSP intervals of one sequence (msp.rs:61-93), scored through
    ``permutation`` (identity order when None).  ``p`` is inferred from
    ``len(permutation)`` when a table is given, else defaults to the
    reference's cap of 8."""
    seq = np.asarray(seq, np.uint8)
    if permutation is not None:
        permutation = np.asarray(permutation)
        if p is None:
            p = max(1, (len(permutation).bit_length() - 1) // 2)
        if 4**p != len(permutation):
            raise ValueError(f"permutation has {len(permutation)} entries, not 4^p")
    elif p is None:
        p = 8
    if p > 8:
        raise ValueError("simple_scan requires p <= 8 (msp.rs:68)")
    if len(seq) < k:
        raise ValueError("can't partition strings shorter than k (msp.rs:66)")
    iv = msp_intervals_device(k, p, *_batch([seq], k, device), permutation, rc)
    starts, lens, buckets = (iv[f].cpu().tolist() for f in ("start", "length", "bucket"))
    return [MspInterval(b, s, n) for b, s, n in zip(buckets, starts, lens)]


def msp_sequence(seq, k: int, p: int, permutation: Optional[np.ndarray] = None,
                 rc: bool = True, device="cuda") -> List[Tuple[int, int, np.ndarray]]:
    """One read -> [(bucket, exts, sub_bases)] (msp.rs:279-324)."""
    return msp_sequences([np.asarray(seq, np.uint8)], k, p, permutation, rc, device=device)[0]


def msp_sequences(seqs, k: int, p: int, permutation=None, rc: bool = True, device="cuda"):
    """A list of base arrays -> per-read lists of (bucket, exts, sub_bases);
    a read shorter than k has none."""
    keep = [i for i, s in enumerate(seqs) if len(s) >= k]
    results: List[List[Tuple[int, int, np.ndarray]]] = [[] for _ in seqs]
    if not keep:
        return results
    bases, lengths = _batch([seqs[i] for i in keep], k, device)
    iv = msp_intervals_device(k, p, bases, lengths, permutation, rc)
    sub = gather_interval_bases(k, p, bases, iv).cpu().numpy()
    read, length, bucket, exts = (iv[f].cpu().tolist() for f in ("read", "length", "bucket", "exts"))
    for j in range(iv["n_intervals"]):
        results[keep[read[j]]].append((bucket[j], exts[j], sub[j, : length[j]]))
    return results


def score_table_from_fn(p: int, fn) -> np.ndarray:
    """A p-mer score function as a (4^p,) int32 table (p <= 13), the
    ``permutation`` argument of the scan: the reference's Scanner takes any
    ``Fn(K) -> D`` score (msp.rs:166).  ``fn`` gets the (4^p,) uint32 array
    of every rank and returns their scores, or is called once a rank."""
    if p > 13:
        raise ValueError("score_table_from_fn requires p <= 13")
    ranks = np.arange(4**p, dtype=np.uint32)
    try:
        out = np.asarray(fn(ranks), np.int32)
        if out.shape != ranks.shape:
            raise TypeError
    except (TypeError, ValueError):
        out = np.fromiter((fn(int(r)) for r in ranks), np.int32, len(ranks))
    return out


def inverse_frequency_score_table(p: int, bases, lengths=None) -> np.ndarray:
    """A load-balancing (4^p,) int32 score table from a sample of reads
    (msp.rs:57-59, :298-311): p-mers scored by ascending canonical
    frequency, so rare p-mers win window minima and no frequent p-mer
    collects a giant bucket; ties break lexicographically.  ``bases``: an
    (R, L) read matrix, ``lengths`` optional (R,) lengths; p <= 13."""
    if p > 13:
        raise ValueError("inverse_frequency_score_table requires p <= 13")
    b = np.asarray(bases, np.int64)
    r, l = b.shape
    if l < p:
        raise ValueError(f"sample reads shorter than p={p}")
    ranks = np.zeros((r, l - p + 1), np.int64)
    for j in range(p):
        ranks = (ranks << 2) | b[:, j : j + l - p + 1]
    if lengths is not None:
        mask = np.arange(l - p + 1)[None, :] <= (np.asarray(lengths)[:, None] - p)
        ranks = ranks[mask]
    hist = np.bincount(ranks.reshape(-1), minlength=4**p)
    # canonical: a p-mer and its rc share a frequency
    rcr = np.arange(4**p, dtype=np.int64)
    rc = np.zeros_like(rcr)
    for _ in range(p):
        rc = (rc << 2) | (3 - (rcr & 3))
        rcr >>= 2
    hist = hist + hist[rc]
    score = np.empty(4**p, np.int32)
    score[np.argsort(hist, kind="stable")] = np.arange(4**p, dtype=np.int32)
    return score
