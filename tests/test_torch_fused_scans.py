"""The plain versions of the two one-pass kernels against the JAX package.

``kernels.run_reduce_rows_plain`` (the count's whole tail over its sorted
packed rows: run starts, counts, exts OR, head rows, labels) against the
JAX package's ``filter_kmers`` tables and colored sets, and
``kernels.msp_scan_reads_plain`` (p-mer ranks, scores and the scanner's
recurrence from the read bases) against ``tpu_debruijn.msp.msp_scan_batch``.
The same numpy reads from a seed go through both packages, JAX on the CPU;
every output is an integer and must be equal (tolerance 0).
``tests/test_torch_cuda.py`` holds the kernels to these plain versions on
the card.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn import msp as M
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import msp as TM
from tpu_debruijn_torch.kernels import (
    msp_scan_reads,
    msp_scan_reads_plain,
    run_reduce_rows,
    run_reduce_rows_plain,
)
from tpu_debruijn_torch.kmer import KmerSpec

# ---------------------------------------------------------------------------
# run_reduce_rows_plain
# ---------------------------------------------------------------------------


def _reads(rng, kind: str, k: int):
    """(bases, exts, label) reads of one kind, labels negative too."""
    lab = lambda: int(rng.integers(-500, 500))
    if kind == "genome":  # ragged reads of one genome, half reverse-complemented
        g = rng.integers(0, 4, 300)
        out = []
        for _ in range(40):
            s = int(rng.integers(0, 200))
            r = g[s : s + int(rng.integers(k, 100))].copy()
            out.append(((3 - r)[::-1] if rng.random() < 0.5 else r, int(rng.integers(0, 256)), lab()))
        return [(r.astype(np.uint8), e, l) for r, e, l in out]
    if kind == "one_run":  # poly-A: one run over every row, 72,600 > 65535 rows
        return [(np.zeros(150, np.uint8), int(rng.integers(0, 256)), lab()) for _ in range(600)]
    if kind == "distinct":  # every observation its own run
        return [(rng.integers(0, 4, 200).astype(np.uint8), 7, lab()) for _ in range(3)]
    if kind == "single":  # one read of k bases: one row
        return [(rng.integers(0, 4, k).astype(np.uint8), 17, -3)]
    return [(rng.integers(0, 4, k - 1).astype(np.uint8), 0, 0)]  # "empty": no kmer


def _sorted_rows(spec, reads, data_reduce: str, stranded: bool, by_label: bool = False):
    """The count's sorted packed rows of ``reads`` on the CPU, labelled as
    ``filter.count_kmers`` labels them."""
    items = [s for s in reads if len(s[0]) >= spec.k]
    if not items:
        return torch.zeros((0, TF.obs_row_words(spec.w)), dtype=torch.int32)
    bases, lengths, seq_exts, labels = TF._read_batch(spec, items, "cpu")
    lab = None
    if data_reduce == "obs_min":
        lk = bases.shape[1] - spec.k + 1
        lab = torch.arange(bases.shape[0] * lk, dtype=torch.int32).reshape(-1, lk)
    elif data_reduce != "none":
        lab = labels[:, None]
    return TF._sorted_rows(spec, bases, lengths, seq_exts, lab, stranded, by_label)


def _fields(heads: torch.Tensor, w: int) -> dict:
    return {"kmers": TF.row_limbs(heads, w).numpy(), "exts": (heads[:, w] & 0xFF).numpy(),
            "counts": (heads[:, w] >> 8).numpy(), "data": heads[:, w + 1].numpy()}


def _reduce_both_ways(srows, w, by_label=False, label_op="first"):
    """The plain version into a separate ``out`` (``srows`` untouched), then
    the wrapper in place (the plain version on a CPU tensor): equal."""
    keep = srows.clone()
    out = torch.full_like(srows, -1)
    got = run_reduce_rows_plain(srows, w, by_label, label_op, out=out)
    assert torch.equal(srows, keep)
    assert got.data_ptr() == out.data_ptr()
    inplace = run_reduce_rows(srows, w, by_label, label_op)
    assert inplace.data_ptr() == srows.data_ptr()
    assert torch.equal(inplace, got)
    assert not got[:, w + 2 :].any()  # padding words zero
    return got


@pytest.mark.parametrize("data_reduce", ["label_first", "min", "max", "sum", "obs_min", "none"])
@pytest.mark.parametrize("k", [15, 16, 31, 33, 63])
def test_rows_plain_matches_jax_count(rng, k, data_reduce):
    """Every run of the sorted rows against the JAX package's table at
    min_obs = 1: kmers, exts OR, counts, data under each data_reduce."""
    reads = _reads(rng, "genome", k)
    spec = KmerSpec(k)
    heads = _reduce_both_ways(_sorted_rows(spec, reads, data_reduce, False), spec.w,
                              label_op=TF._LABEL_OP[data_reduce])
    ref = F.filter_kmers(reads, k, stranded=False, min_obs=1, data_reduce=data_reduce)
    got = _fields(heads, spec.w)
    assert len(got["kmers"]) == len(ref.kmers) > 0
    for key in got:
        assert np.array_equal(np.asarray(getattr(ref, key)), got[key]), key
    if data_reduce in ("label_first", "min", "sum"):
        assert got["data"].min() < 0  # negative labels took part


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("kind", ["one_run", "distinct", "single", "empty"])
@pytest.mark.parametrize("k", [16, 31])
def test_rows_plain_skewed_inputs(rng, k, kind, stranded):
    """One run over all 72,600 rows (count saturated at 65535), all rows
    distinct, one row and none, against the JAX package's tables."""
    reads = _reads(rng, kind, k)
    spec = KmerSpec(k)
    srows = _sorted_rows(spec, reads, "sum", stranded)
    n = srows.shape[0]
    heads = _reduce_both_ways(srows, spec.w, label_op="sum")
    got = _fields(heads, spec.w)
    want_runs = {"one_run": 1, "distinct": n, "single": 1, "empty": 0}[kind]
    assert len(got["kmers"]) == want_runs
    if kind == "one_run":
        assert n == 600 * (150 - k + 1) > 65535 and got["counts"][0] == 65535
    if kind == "empty":
        assert heads.shape == (0, TF.obs_row_words(spec.w))
        return
    ref = F.filter_kmers(reads, k, stranded=stranded, min_obs=1, data_reduce="sum")
    for key in got:
        assert np.array_equal(np.asarray(getattr(ref, key)), got[key]), key


@pytest.mark.parametrize("k", [15, 31, 33])
def test_rows_plain_by_label_matches_jax_sets(rng, k):
    """With by_label the runs are (kmer, label) pairs, labels sorted as
    uint32 (negative ones last): each kmer's labels, summed counts and OR'd
    exts against the JAX package's filter_kmers_set_arrays."""
    reads = _reads(rng, "genome", k)
    for i in range(0, len(reads), 3):  # shared labels: pairs of several rows
        reads[i] = (reads[i][0], reads[i][1], -7)
    spec, w = KmerSpec(k), KmerSpec(k).w
    heads = _reduce_both_ways(_sorted_rows(spec, reads, "label_first", False, by_label=True),
                              w, by_label=True)
    got = _fields(heads, w)
    table, pair_label, split = F.filter_kmers_set_arrays(reads, k, stranded=False, min_obs=1)
    kmers, idx = np.unique(got["kmers"], axis=0, return_inverse=True)
    idx = idx.reshape(-1)
    assert np.array_equal(kmers, np.asarray(table.kmers))
    assert np.array_equal(got["data"], np.asarray(pair_label))
    assert np.array_equal(np.searchsorted(idx, np.arange(len(kmers) + 1)), np.asarray(split))
    assert np.array_equal(np.bincount(idx, weights=got["counts"]).astype(np.int64),
                          np.asarray(table.counts))
    assert np.array_equal(np.bitwise_or.reduceat(got["exts"], np.asarray(split)[:-1]),
                          np.asarray(table.exts))
    assert (got["data"] < 0).any()


def test_rows_refuses_bad_inputs():
    rows = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        run_reduce_rows(rows, 3)  # W = 3 rows are 8 words
    with pytest.raises(ValueError):
        run_reduce_rows(rows, 1, label_op="mean")
    with pytest.raises(ValueError):
        run_reduce_rows(rows, 1, out=torch.zeros((4, 4), dtype=torch.int32))
    assert run_reduce_rows(rows[:0], 1).shape == (0, 4)


# ---------------------------------------------------------------------------
# msp_scan_reads_plain
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 4))
def _jax_scan(k, p, bases, lengths, rc, perm):
    return M.msp_scan_batch(k, p, bases, lengths, perm, rc)


def _rc(s: np.ndarray) -> np.ndarray:
    return (3 - s[::-1]).astype(np.uint8)


def _msp_reads(rng, k: int, p: int, kind: str):
    """(bases (R, L) uint8, lengths) of one kind, padded as pad_reads pads."""
    n = 2 * k + 23
    if kind == "random":  # reads shorter than k beside full ones; valid masks them
        seqs = [rng.integers(0, 4, int(m)).astype(np.uint8) for m in (1, k - 1, k, n, 3, k + 5)]
        seqs += [rng.integers(0, 4, int(m)).astype(np.uint8) for m in rng.integers(k, n, 6)]
    elif kind == "poly":  # all-equal scores
        seqs = [np.zeros(n, np.uint8), np.full(n, 3, np.uint8), np.full(k, 1, np.uint8)]
    else:  # "palindrome": reads equal to their reverse complement, palindromic p-mers
        half = [rng.integers(0, 4, int(m)).astype(np.uint8) for m in (k // 2 + 1, k, n // 2)]
        seqs = [np.concatenate([h, _rc(h)]) for h in half]
        pal = np.concatenate([np.arange(p // 2) % 4, _rc(np.arange(p // 2) % 4)]).astype(np.uint8)
        seqs.append(np.tile(pal, n // max(len(pal), 1) + 1)[:n] if len(pal) else np.zeros(n, np.uint8))
    return F.pad_reads(seqs, min_len=k, pad_to=16)


@pytest.mark.parametrize("kind", ["random", "poly", "palindrome"])
@pytest.mark.parametrize("k,p,score", [
    (k, p, score) for k, p in [(15, 5), (31, 8), (33, 9), (63, 16)]
    for score in ("rc", "forward", "permutation", "tied")
    if p <= 15 or score in ("rc", "forward")])  # a permutation table needs p <= 15
def test_reads_plain_matches_jax(rng, k, p, score, kind):
    """All four outputs of msp_scan_batch (through msp_scan_reads) and the
    reads form's own (flags before the validity mask), padding positions
    included, against JAX; a permutation table with and without ties."""
    bases, lengths = _msp_reads(rng, k, p, kind)
    rc = score != "forward"
    perm = None
    if score == "permutation":
        perm = rng.permutation(4**p).astype(np.int32)
    elif score == "tied":  # a few distinct scores: ties within windows
        perm = rng.integers(-3, 4, 4**p).astype(np.int32)
    want = _jax_scan(k, p, jnp.asarray(bases), jnp.asarray(lengths), rc,
                     None if perm is None else jnp.asarray(perm))
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    flags, min_rank, min_pos = msp_scan_reads_plain(tb, k, p, perm, rc)
    lk = bases.shape[1] - k + 1
    assert flags.shape == min_rank.shape == min_pos.shape == (bases.shape[0], lk)
    assert flags.dtype == torch.bool and min_rank.dtype == min_pos.dtype == torch.int32
    valid = np.asarray(want[3])
    assert bool(flags[:, 0].all())
    assert np.array_equal(flags.numpy() & valid, np.asarray(want[0]))
    assert np.array_equal(min_rank.numpy(), np.asarray(want[1]))
    assert np.array_equal(min_pos.numpy(), np.asarray(want[2]))
    for g, x in zip(msp_scan_reads(tb, k, p, perm, rc), (flags, min_rank, min_pos)):
        assert torch.equal(g, x)
    for g, x in zip(TM.msp_scan_batch(k, p, tb, tl, perm, rc), want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(x).astype(np.int64))


def test_reads_lk1_and_refusals(rng):
    """Rows of exactly k bases (Lk = 1); p = 17, a window over 64 p-mers,
    rows shorter than k and a p = 16 table are refused."""
    bases = torch.from_numpy(rng.integers(0, 4, (5, 31)).astype(np.uint8))
    flags, min_rank, min_pos = msp_scan_reads(bases, 31, 8)
    assert flags.shape == (5, 1) and bool(flags.all())
    ranks, scores = TM.msp_scores(8, bases, torch.full((5,), 31))
    # the window's rightmost least score
    want = [max(range(24), key=lambda j, r=r: (-int(scores[r, j]), j)) for r in range(5)]
    assert min_pos[:, 0].tolist() == want
    assert min_rank[:, 0].tolist() == [int(ranks[r, j]) for r, j in enumerate(want)]
    with pytest.raises(ValueError):
        msp_scan_reads(bases, 31, 17)
    with pytest.raises(ValueError):
        msp_scan_reads(torch.zeros((2, 80), dtype=torch.uint8), 70, 2)  # 69 p-mers a window
    with pytest.raises(ValueError):
        msp_scan_reads(bases, 32, 8)
    with pytest.raises(ValueError):
        msp_scan_reads(bases, 31, 16, np.zeros(4**8, np.int32))
