"""The MSP scanner over a batch of reads.

Kernel 7 of the port, ``csrc/msp_scan.cu``.  It replaces the ``jax.lax.scan``
of ``tpu_debruijn/msp.py:msp_scan_batch`` (``msp.py:133-148``, plain XLA)
and, in its reads form, the p-mer ranks and scores before it: for every
kmer position of every read, whether a new MSP interval starts there and
the position and rank of the interval's minimizer.  Two forms:

* :func:`msp_scan_reads`, from the padded read bases: one thread a read
  rolls the p-mer ranks in registers, scores them, keeps the last window's
  scores in a ring in shared memory and runs the recurrence; bound by
  device memory (bases in, 9 bytes a kmer position out).
* :func:`msp_scan`, the recurrence alone over (R, N) int32 scores.

The plain versions: :func:`msp_scores` (ranks by the plain kmer extractor,
scores as the JAX package makes them), :func:`msp_scan_plain` (the windowed
minimum of every position, a sparse table, and the recurrence as a Python
loop of Lk - 1 steps over (R,) columns), and :func:`msp_scan_reads_plain`,
the two with the minimizer's rank gathered after.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; ``<wrapper>.launches`` counts kernel launches.
Outputs are (Lk, R) columns on the card, so stores are coalesced, returned
as (R, Lk) transposed views, the layout the plain loop returns.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch.kernels import _build
from tpu_debruijn_torch.kernels.extract_canonical import extract_kmers
from tpu_debruijn_torch.kmer import M32, KmerSpec

INF = 2**31 - 1
_SIGN = -(2**31)

# (scores, r, n, w, flags, mvals, mposs, stream)
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
# (bases, r, l, p, w, perm, rc, flags, min_rank, min_pos, stream)
_READS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def _i32_view(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit patterns."""
    return (((x + 2**31) & M32) - 2**31).to(torch.int32)


def pmer_ranks(p: int, bases: torch.Tensor, lengths: torch.Tensor):
    """Ranks of all p-mers: (R, L - p + 1) int32 bit patterns (p <= 16),
    and their validity.  At p = 16 a rank fills 32 bits, so its int32 view
    may be negative; compare through :func:`_order_key`."""
    if p > 16:
        raise ValueError(f"p-mer ranks need p <= 16 (one 32-bit limb), got p={p}")
    spec = KmerSpec(p)
    zeros = torch.zeros(bases.shape[0], dtype=torch.int32, device=bases.device)
    kmers, _, valid = extract_kmers(spec, bases, lengths, zeros)
    return _i32_view(kmers[..., 0]), valid


def _order_key(ranks: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 key of uint32 rank bit patterns: flipping the
    sign bit maps unsigned order onto signed order."""
    return ranks ^ _SIGN


def _rc_rank(p: int, ranks: torch.Tensor) -> torch.Tensor:
    return _i32_view(KM.rc(KmerSpec(p), (ranks.to(torch.int64) & M32)[..., None])[..., 0])


def _table(permutation, p: int, device) -> torch.Tensor:
    """A (4^p,) score table as an int32 tensor on ``device`` (p <= 15)."""
    if p > 15:
        raise ValueError("permutation scoring requires p <= 15 (int32 table indexing)")
    t = permutation if torch.is_tensor(permutation) else torch.from_numpy(np.asarray(permutation))
    return t.to(device=device, dtype=torch.int32)


def msp_scores(p: int, bases: torch.Tensor, lengths: torch.Tensor, permutation=None,
               rc: bool = True):
    """(ranks, scores), each (R, L - p + 1) int32: every p-mer's rank (its
    uint32 bit pattern) and the score the scanner minimizes: the
    permutation table's entry (p <= 15) or the rank's order key, the
    lesser of the p-mer's and its reverse complement's with ``rc``."""
    ranks, _ = pmer_ranks(p, bases, lengths)
    if permutation is not None:
        perm = _table(permutation, p, bases.device)
        score = lambda rk: torch.index_select(perm, 0, rk.reshape(-1)).reshape(rk.shape)
    else:
        score = _order_key
    scores = score(ranks)
    if rc:
        scores = torch.minimum(scores, score(_rc_rank(p, ranks)))
    return ranks, scores


def _best(av, ap, bv, bp):
    """MinPos combine: value ascending, ties prefer the larger position."""
    take_b = (bv < av) | ((bv == av) & (bp > ap))
    return torch.where(take_b, bv, av), torch.where(take_b, bp, ap)


def _shift_left(x: torch.Tensor, by: int, fill: int) -> torch.Tensor:
    """Columns ``by..`` of (R, N) ``x`` moved to the front, ``fill`` after."""
    return torch.cat([x[:, by:], torch.full((x.shape[0], by), fill, dtype=x.dtype,
                                            device=x.device)], dim=1)


def _window_min(scores: torch.Tensor, w: int):
    """Sparse-table windowed minimum over [i, i + w) with the rightmost
    tie-break: (vals, poss), each (R, N) int32; positions past N count as
    +inf."""
    r, n = scores.shape
    fv = scores
    fp = torch.arange(n, dtype=torch.int32, device=scores.device).expand(r, n)
    level = 1
    while level * 2 <= w:
        fv, fp = _best(fv, fp, _shift_left(fv, level, INF), _shift_left(fp, level, 0))
        level *= 2
    # combine [i, i + level) and [i + w - level, i + w)
    off = w - level
    return _best(fv, fp, _shift_left(fv, off, INF), _shift_left(fp, off, 0))


def _check(scores: torch.Tensor, w: int) -> int:
    if scores.dim() != 2 or scores.dtype != torch.int32:
        raise ValueError("msp_scan: scores must be (R, N) int32")
    lk = scores.shape[1] - w + 1
    if w < 1 or lk < 1:
        raise ValueError(f"msp_scan: a window of {w} scores in rows of {scores.shape[1]}")
    return lk


def msp_scan_plain(scores: torch.Tensor, w: int):
    """:func:`msp_scan` in plain PyTorch: the window minima of every
    position, then a loop over the kmer positions carrying every read's
    (value, position) state at once."""
    lk = _check(scores, w)
    rr, dev = scores.shape[0], scores.device
    wv, wp = _window_min(scores, w)
    # the loop reads one column a step: lay columns out contiguously
    scores_t, wv_t, wp_t = (x.t().contiguous() for x in (scores, wv, wp))
    del wv, wp
    flags = torch.empty((lk, rr), dtype=torch.bool, device=dev)
    mvals = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    mposs = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    mval, mpos = wv_t[0], wp_t[0]
    flags[0], mvals[0], mposs[0] = True, mval, mpos
    for i in range(1, lk):
        end_pos = i + w - 1
        end_val = scores_t[end_pos]
        rescan = i > mpos
        better = end_val < mval
        mval = torch.where(rescan, wv_t[i], torch.where(better, end_val, mval))
        mpos = torch.where(rescan, wp_t[i], torch.where(better, end_pos, mpos))
        flags[i] = rescan | better
        mvals[i], mposs[i] = mval, mpos
    return flags.t(), mvals.t(), mposs.t()


def msp_scan(scores: torch.Tensor, w: int):
    """Scanner::scan over (R, N) int32 scores (the order keys of a batch's
    p-mers), w = k - p + 1 p-mers a kmer.

    Returns (R, Lk) tensors, Lk = N - w + 1: ``flags`` (bool, a new
    interval starts at kmer index i: i = 0, a rescan, or a strictly smaller
    score entering the window), ``mvals`` and ``mposs`` (int32, the score
    and position of the minimizer active at i; a window's minimum is its
    rightmost least score).  Every position is computed, padding included.
    """
    lk = _check(scores, w)
    if not scores.is_cuda:
        if scores.is_cpu:
            return msp_scan_plain(scores, w)
        raise ValueError(f"msp_scan: no kernel for device {scores.device}")
    rr, n = scores.shape
    if rr * n >= 1 << 31 or rr * lk >= 1 << 31:
        raise ValueError("msp_scan: the kernel takes fewer than 2^31 scores")
    dev = scores.device
    flags = torch.empty((lk, rr), dtype=torch.bool, device=dev)
    mvals = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    mposs = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    if rr:
        scores = scores.contiguous()
        fn = _build.library().function("tdb_msp_scan", _ARGTYPES)
        _build.check("tdb_msp_scan", fn(
            scores.data_ptr(), rr, n, w, flags.data_ptr(), mvals.data_ptr(),
            mposs.data_ptr(), _build.stream_ptr(dev),
        ))
        msp_scan.launches += 1
    return flags.t(), mvals.t(), mposs.t()


msp_scan.launches = 0


# ---------------------------------------------------------------------------
# the reads form
# ---------------------------------------------------------------------------


def _reads_check(bases: torch.Tensor, k: int, p: int) -> int:
    if bases.dim() != 2:
        raise ValueError("msp_scan_reads: bases must be (R, L)")
    if not 1 <= p <= 16:
        raise ValueError(f"p-mer ranks need 1 <= p <= 16 (one 32-bit limb), got p={p}")
    if not p <= k <= p + 63:
        raise ValueError(f"msp_scan_reads: k = {k} with p = {p} (windows of 1 to 64 p-mers)")
    lk = bases.shape[1] - k + 1
    if lk < 1:
        raise ValueError(f"msp_scan_reads: rows of {bases.shape[1]} bases, k = {k}")
    return lk


def msp_scan_reads_plain(bases: torch.Tensor, k: int, p: int, permutation=None,
                         rc: bool = True):
    """:func:`msp_scan_reads` in plain PyTorch: :func:`msp_scores`, the
    recurrence by :func:`msp_scan_plain`, the minimizer's rank gathered."""
    _reads_check(bases, k, p)
    lengths = torch.full((bases.shape[0],), bases.shape[1], dtype=torch.int32,
                         device=bases.device)
    ranks, scores = msp_scores(p, bases, lengths, permutation, rc)
    flags, _, mposs = msp_scan_plain(scores, k - p + 1)
    return flags, torch.take_along_dim(ranks, mposs.long(), dim=1), mposs


def msp_scan_reads(bases: torch.Tensor, k: int, p: int, permutation=None, rc: bool = True):
    """Scanner::scan over a padded read batch ((R, L) 2-bit codes), from its
    bases: the p-mers' ranks, their scores (the permutation table's entry,
    p <= 15, or the rank's order key; with ``rc`` the lesser of the
    p-mer's and its reverse complement's) and the recurrence.

    Returns (R, Lk) tensors, Lk = L - k + 1: ``flags`` (bool: a new interval
    starts at kmer index i, before masking by the read's length),
    ``min_rank`` (the int32 view of the forward rank of the minimizer active
    at i) and ``min_pos`` (int32, its p-mer index).  Every position is
    computed, padding included.
    """
    lk = _reads_check(bases, k, p)
    if not bases.is_cuda:
        if bases.is_cpu:
            return msp_scan_reads_plain(bases, k, p, permutation, rc)
        raise ValueError(f"msp_scan_reads: no kernel for device {bases.device}")
    rr, l = bases.shape
    if rr * l >= 1 << 31 or rr * lk >= 1 << 31:
        raise ValueError("msp_scan_reads: the kernel takes fewer than 2^31 bases")
    dev = bases.device
    bases = bases.to(torch.uint8).contiguous()
    perm = None if permutation is None else _table(permutation, p, dev)
    flags = torch.empty((lk, rr), dtype=torch.bool, device=dev)
    min_rank = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    min_pos = torch.empty((lk, rr), dtype=torch.int32, device=dev)
    if rr:
        fn = _build.library().function("tdb_msp_scan_reads", _READS_ARGTYPES)
        _build.check("tdb_msp_scan_reads", fn(
            bases.data_ptr(), rr, l, p, k - p + 1, None if perm is None else perm.data_ptr(),
            int(rc), flags.data_ptr(), min_rank.data_ptr(), min_pos.data_ptr(),
            _build.stream_ptr(dev),
        ))
        msp_scan_reads.launches += 1
    return flags.t(), min_rank.t(), min_pos.t()


msp_scan_reads.launches = 0
