"""The MSP scanner's recurrence over a batch of reads.

Kernel 7 of the port, ``csrc/msp_scan.cu``.  It replaces the ``jax.lax.scan``
of ``tpu_debruijn/msp.py:msp_scan_batch`` (``msp.py:133-148``, plain XLA):
for every kmer position of every read, whether a new MSP interval starts
there and the (score, position) of the interval's minimizer.  The plain
version, :func:`msp_scan_plain`, builds the windowed minimum of every
position (a sparse table, log2(w) passes) and runs the recurrence as a
Python loop of Lk - 1 steps over (R,) columns.

On the H100 the kernel is bound by device memory (scores in, three (R, Lk)
arrays out).  It is one thread a read with the recurrence in registers,
rescanning a window itself when its minimum slides out, the read's scores
staged in shared memory by coalesced loads, and the outputs written as
(Lk, R) columns, so every store is coalesced.

:func:`msp_scan` launches the kernel for a CUDA tensor and runs
:func:`msp_scan_plain` for a CPU tensor; ``msp_scan.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_debruijn_torch.kernels import _build

INF = 2**31 - 1

# (scores, r, n, w, flags, mvals, mposs, stream)
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


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
