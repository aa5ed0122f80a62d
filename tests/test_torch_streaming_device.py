"""Port parity: filter_kmers_streaming's device merge against the JAX
package's, on the CPU, at the eight K of the corpus path.

The JAX package keeps a static-shape table (capacity, block compaction,
lagged confirmation and replays); the port joins each chunk's table into a
sorted unique table (``filter.merge_unique``) and accepts the capacity
arguments without using them.  So the JAX runs take ``init_capacity=256``,
with and without ``unique_capacity=64`` (every chunk overflows its block
table and is replayed), and the port must give the same table either way.
Exact equality.  Also: ``merge_unique`` against a concatenate-and-sort
merge, and the device unpack of packed rows against the JAX package's.
"""

import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import sorting as TS

from test_torch_streaming_host import _same

KS = [15, 16, 17, 31, 32, 33, 63, 64]


def _genome_reads(rng, n=120, glen=900, read_len=90, labels=(0,)):
    """Reads of one genome, half reverse-complemented, each with an exts
    byte and a label drawn from ``labels``."""
    g = rng.integers(0, 4, glen).astype(np.uint8)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, glen - read_len))
        r = g[s : s + read_len].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        out.append((r, int(rng.integers(0, 256)), int(rng.choice(labels))))
    return out


@pytest.mark.parametrize("unique_capacity", [None, 64])
@pytest.mark.parametrize("k", KS)
def test_device_merge_matches_jax(rng, k, unique_capacity):
    reads = _genome_reads(rng)
    reads.append((np.full(80, 3, np.uint8), 0, 0))  # the poly-T kmer at K = 16/32/64
    stranded = k % 2 == 0
    kw = dict(stranded=stranded, min_obs=2, data_reduce="none", merge="device",
              chunk_reads=32, init_capacity=256, unique_capacity=unique_capacity)
    ref = F.filter_kmers_streaming(iter(reads), k, **kw)
    port = TF.filter_kmers_streaming(iter(reads), k, device="cpu", **kw)
    assert len(ref) > 0
    _same(ref, port, f"K={k}")


def test_device_merge_u_overflow_replay(rng):
    """test_filter.py's replay case, run through the port: the same table
    as the JAX package and as one-batch filter_kmers."""
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    reads = []
    for _ in range(120):
        s = int(rng.integers(0, 2900))
        r = g[s : s + 90].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        reads.append((r, 0, 0))
    kw = dict(stranded=False, min_obs=1, chunk_reads=32, data_reduce="none", merge="device",
              init_capacity=256, unique_capacity=64)
    ref = F.filter_kmers_streaming(iter(reads), 31, **kw)
    port = TF.filter_kmers_streaming(iter(reads), 31, device="cpu", **kw)
    _same(ref, port)
    _same(TF.filter_kmers(reads, 31, stranded=False, min_obs=1, data_reduce="none",
                          device="cpu"), port)


@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_merge_unique_is_a_sorted_union(rng, w):
    """The join equals concatenation, a stable sort and per-run sums (u16
    saturating) and ORs, on key sets that overlap in part, including an
    empty side and a key above every table key."""
    def table(n):
        keys = torch.from_numpy(np.unique(rng.integers(0, 4, (n, w)) << 30, axis=0))
        n = keys.shape[0]
        return (keys, torch.from_numpy(rng.integers(0, 256, n).astype(np.int32)),
                torch.from_numpy(rng.integers(1, 40000, n).astype(np.int32)))

    for n_a, n_b in ((50, 40), (0, 30), (30, 0), (200, 3)):
        a, b = table(n_a), table(n_b)
        keys = torch.cat([a[0], b[0]])
        perm = TS.lex_argsort(keys)
        start = TS.run_starts(keys[perm])
        run = torch.cumsum(start, 0) - 1
        n = int(start.sum())
        counts = torch.zeros(n, dtype=torch.int64).index_add_(0, run, torch.cat([a[2], b[2]])[perm].long())
        or_exts = torch.zeros(n, dtype=torch.int32)
        for v, r in zip(torch.cat([a[1], b[1]])[perm].tolist(), run.tolist()):
            or_exts[r] |= v
        got = TF.merge_unique(*(t.clone() for t in a), *b)
        assert torch.equal(got[0], keys[perm][start])
        assert torch.equal(got[1], or_exts)
        assert torch.equal(got[2], counts.clamp(max=65535).to(torch.int32))


def test_unpack_2bit_matches_jax(rng):
    from tpu_debruijn.filter import _unpack2bit

    packed = rng.integers(0, 256, (37, 40)).astype(np.uint8)
    want = np.asarray(_unpack2bit(packed, 160))
    got = TF.unpack_2bit(torch.from_numpy(packed))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 5, 1000])
def test_searchsorted_limbs_past_the_end(n):
    """A query above every row of a table of W > 2 limbs gets the lower
    bound n (the binary search once stepped to n + 1 after converging)."""
    table = torch.zeros((n, 3), dtype=torch.int64)
    table[:, 2] = torch.arange(n)
    query = torch.tensor([[0, 0, n], [0, 0, 0], [0, 1, 0], [0, 0, n - 1]], dtype=torch.int64)
    idx, found = TS.searchsorted_limbs(table, query)
    assert idx.tolist() == [n, 0, n, n - 1]
    assert found.tolist() == [False, True, False, True]
