"""The plain versions of the port's two scan kernels against the JAX package.

``kernels.msp_scan_plain`` (the MSP scanner's recurrence) against the
``jax.lax.scan`` of ``tpu_debruijn.msp.msp_scan_batch``, and
``kernels.run_reduce_plain`` (the count's per-run exts OR and sums) against
``tpu_debruijn.sorting.seg_or_suffix8`` and
``tpu_debruijn.filter._seg_sum_or_suffix`` read at run starts.  The same
numpy inputs from a seed go through both packages, JAX on the CPU; every
output is an integer and must be equal.  ``tests/test_torch_cuda.py`` holds
the kernels to these plain versions on the card.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn import msp as M
from tpu_debruijn import sorting as S
from tpu_debruijn_torch import msp as TM
from tpu_debruijn_torch.kernels import msp_scan, msp_scan_plain, run_reduce, run_reduce_plain

# ---------------------------------------------------------------------------
# msp_scan_plain
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 4))
def _jax_scan(k, p, bases, lengths, rc, perm):
    return M.msp_scan_batch(k, p, bases, lengths, perm, rc)


def _reads(rng, k: int, kind: str):
    """(bases (R, L) uint8, lengths (R,) int32) of one kind; rows padded to
    a multiple of 16 as pad_reads pads them, except "lk1" (rows of exactly
    k bases: one kmer a row)."""
    if kind == "lk1":
        return rng.integers(0, 4, (7, k)).astype(np.uint8), np.full(7, k, np.int32)
    n = 2 * k + 23
    if kind == "random":
        seqs = [rng.integers(0, 4, int(m)).astype(np.uint8) for m in rng.integers(k, n, 9)]
    elif kind == "poly":  # all-equal scores: poly-A, poly-T, and a poly-C of length k
        seqs = [np.zeros(n, np.uint8), np.full(n, 3, np.uint8), np.full(k, 1, np.uint8)]
    elif kind == "periodic":  # repeating scores: equal minima recur across windows
        seqs = [np.tile(rng.integers(0, 4, period).astype(np.uint8), n // period + 1)[:n]
                for period in (1, 2, 3, 5, 7)]
    else:  # "short": reads shorter than k beside full ones; valid masks them
        seqs = [rng.integers(0, 4, int(m)).astype(np.uint8) for m in (1, k - 1, k, n, 3)]
    bases, lengths = F.pad_reads(seqs, min_len=k, pad_to=16)
    return bases, lengths


KP = [(5, 3), (15, 5), (31, 8), (31, 16), (47, 11)]
KINDS = ["random", "poly", "periodic", "short", "lk1"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,p,score", [
    (k, p, score) for k, p in KP for score in ("rc", "forward", "permutation")
    if score != "permutation" or p <= 15])  # a permutation table needs p <= 15
def test_msp_scan_plain_matches_jax(rng, k, p, score, kind):
    """Whole (R, Lk) arrays, padding positions included: the new-interval
    flags (JAX returns them masked by validity), the minimizer positions
    and ranks; every minimizer score is the score at its position."""
    bases, lengths = _reads(rng, k, kind)
    rc = score != "forward"
    perm = rng.permutation(4**p).astype(np.int32) if score == "permutation" else None
    if perm is not None and kind == "periodic":
        perm //= 4  # scores that repeat across distinct p-mers
    want = _jax_scan(k, p, jnp.asarray(bases), jnp.asarray(lengths), rc,
                     None if perm is None else jnp.asarray(perm))
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    ranks, scores = TM.msp_scores(p, tb, tl, perm, rc)
    flags, mvals, mposs = msp_scan_plain(scores, k - p + 1)
    lk = bases.shape[1] - k + 1
    assert flags.shape == mvals.shape == mposs.shape == (bases.shape[0], lk)
    assert flags.dtype == torch.bool and mvals.dtype == mposs.dtype == torch.int32
    valid = np.asarray(want[3])
    assert bool(flags[:, 0].all())
    assert np.array_equal(flags.numpy() & valid, np.asarray(want[0]))
    assert np.array_equal(mposs.numpy(), np.asarray(want[2]))
    assert torch.equal(mvals, torch.take_along_dim(scores, mposs.long(), dim=1))
    assert np.array_equal(torch.take_along_dim(ranks, mposs.long(), dim=1).numpy(),
                          np.asarray(want[1]))
    # the wrapper runs the plain version for a CPU tensor, and so does the batch
    for g, w in zip(msp_scan(scores, k - p + 1), (flags, mvals, mposs)):
        assert torch.equal(g, w)
    got = TM.msp_scan_batch(k, p, tb, tl, perm, rc)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("w", [1, 2, 7, 24])
def test_msp_scan_plain_tie_breaks(w):
    """Hand-checked recurrences: a step takes a new minimum only when it is
    strictly smaller (the older position wins a tie), a rescan takes the
    rightmost minimum, and negative scores (p = 16 order keys) order below
    positive ones."""
    n = w + 40
    rising = torch.arange(n, dtype=torch.int32)[None, :] - 20
    flat = torch.zeros((1, n), dtype=torch.int32)
    falling = -rising
    flags, mvals, mposs = msp_scan_plain(torch.cat([rising, flat, falling]), w)
    lk = n - w + 1
    i = torch.arange(lk, dtype=torch.int32)
    # rising: the window's first score is its minimum, rescanned every step
    assert torch.equal(mposs[0], i) and bool(flags[0].all())
    # flat: a rescan takes the window's last position, kept until it leaves
    want = (i // w) * w + w - 1
    assert torch.equal(mposs[1], want)
    assert torch.equal(flags[1], (i % w) == 0)
    # falling: every entering score is strictly smaller
    assert torch.equal(mposs[2], i + w - 1) and bool(flags[2].all())
    assert torch.equal(mvals, torch.take_along_dim(torch.cat([rising, flat, falling]),
                                                   mposs.long(), dim=1))


def test_msp_scan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        msp_scan_plain(torch.zeros((2, 5), dtype=torch.int32), 6)
    with pytest.raises(ValueError):
        msp_scan(torch.zeros((2, 5), dtype=torch.int64), 2)
    flags, mvals, mposs = msp_scan(torch.zeros((0, 9), dtype=torch.int32), 4)
    assert flags.shape == mvals.shape == mposs.shape == (0, 6)


# ---------------------------------------------------------------------------
# run_reduce_plain
# ---------------------------------------------------------------------------


def _runs(rng, n: int, kind: str) -> np.ndarray:
    """Exclusive run ends partitioning [0, n), strictly increasing."""
    if n == 0:
        return np.zeros(0, np.int64)
    if kind == "ones":
        return np.arange(1, n + 1, dtype=np.int64)
    if kind == "one_big":  # one run of 90% of the rows among runs of one
        big = max(1, int(0.9 * n))
        lo = int(rng.integers(0, n - big + 1))
        return np.array([*range(1, lo + 1), lo + big, *range(lo + big + 1, n + 1)], np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(n - 1, n // 20), replace=False))
    return np.append(cuts, n).astype(np.int64)


def _jax_at_starts(out, ends) -> np.ndarray:
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64) if len(ends) else ends
    return np.asarray(out)[starts]


@pytest.mark.parametrize("kind", ["random", "ones", "one_big"])
@pytest.mark.parametrize("n", [0, 1, 2, 31, 33, 1000, 20_000])
def test_run_reduce_plain_matches_jax(rng, n, kind):
    """Exts bytes with every bit, counts that saturate 16 bits in some runs:
    the OR against seg_or_suffix8 and _seg_sum_or_suffix at run starts, the
    sum (saturated as the JAX package saturates it) against the latter."""
    ends = _runs(rng, n, kind)
    exts = rng.integers(0, 256, n).astype(np.int32)
    exts[: min(n, 8)] = 1 << np.arange(min(n, 8))
    counts = rng.integers(0, 1 << 15, n).astype(np.int32)
    is_end = np.zeros(n, bool)
    is_end[ends - 1] = True
    want_or = _jax_at_starts(S.seg_or_suffix8(jnp.asarray(exts), jnp.asarray(is_end)), ends)
    packed = F._seg_sum_or_suffix(jnp.asarray((counts << 8) | exts), jnp.asarray(is_end))
    want_packed = _jax_at_starts(packed, ends)
    got_or, got_sum = run_reduce_plain(torch.from_numpy(ends), torch.from_numpy(exts),
                                       torch.from_numpy(counts))
    assert got_or.dtype == torch.int32 and got_sum.dtype == torch.int64
    assert got_or.shape == got_sum.shape == (len(ends),)
    assert np.array_equal(got_or.numpy(), want_or)
    assert np.array_equal(got_or.numpy(), want_packed & 0xFF)
    assert np.array_equal(np.minimum(got_sum.numpy(), 65535), (want_packed >> 8) & 0xFFFF)
    # exact sums against numpy
    if n:
        assert np.array_equal(got_sum.numpy(), np.add.reduceat(counts.astype(np.int64),
                                                               np.concatenate([[0], ends[:-1]])))


@pytest.mark.parametrize("words", [4, 8])
def test_run_reduce_reads_row_columns(rng, words):
    """The callers' form: columns of packed rows, as strided views, through
    the wrapper (the plain version on the CPU), one output or both; a
    negative label sums as a signed int32."""
    n = 5000
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n, words)).astype(np.int32))
    ends = torch.from_numpy(_runs(rng, n, "random"))
    or_col, sum_col = rows[:, words - 3], rows[:, words - 2]
    assert or_col.stride(0) == words
    both = run_reduce(ends, or_col, sum_col)
    assert torch.equal(both[0], run_reduce(ends, or_col)[0])
    assert torch.equal(both[1], run_reduce(ends, sum_col=sum_col)[1])
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    for u in range(0, len(ends), 97):
        seg = slice(int(starts[u]), int(ends[u]))
        want_or = 0
        for v in or_col[seg].tolist():
            want_or |= v & 0xFF
        assert int(both[0][u]) == want_or
        assert int(both[1][u]) == sum(sum_col[seg].tolist())
    assert run_reduce(ends[:0], or_col[:0], sum_col[:0])[0].shape == (0,)
    with pytest.raises(ValueError):
        run_reduce(ends)
