"""Port parity for the MSP scan (tpu_debruijn_torch.msp): the interval table,
the interval bases, the scan's per-position arrays, the host API and its
refusals, the score tables, and the shard of a p = 16 bucket.

The same numpy reads go through the JAX package (on the CPU, its scan
compiled once a shape) and through the port (device="cpu"); every column
must be identical, ranks and buckets compared as uint32."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn import msp as M
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import msp as TM
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch.parallel import shard as TS

CPU = "cpu"
FIELDS = ("read", "start", "length", "minimizer_rank", "minimizer_pos", "bucket", "exts")


@partial(jax.jit, static_argnums=(0, 1, 4))
def _jax_scan(k, p, bases, lengths, rc, perm):
    return M.msp_scan_batch(k, p, bases, lengths, perm, rc)


def _batch(rng, k, n=9):
    """Reads of ragged lengths, many shorter than the padded width."""
    seqs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(k, 3 * k + 20, n)]
    return F.pad_reads(seqs, min_len=k, pad_to=16)


def _same_intervals(k, p, bases, lengths, perm, rc):
    """JAX's intervals and interval bases against the port's; returns the
    port's intervals."""
    want, wsub = M._msp_jit(k, p, jnp.asarray(bases), jnp.asarray(lengths), rc,
                            None if perm is None else jnp.asarray(perm))
    got = TM.msp_intervals_device(k, p, torch.from_numpy(bases), torch.from_numpy(lengths),
                                  perm, rc)
    n = int(want["n_intervals"])
    assert got["n_intervals"] == n > 0
    for f in FIELDS:
        w = np.asarray(want[f])[:n].astype(np.uint32)
        assert np.array_equal(got[f].numpy().astype(np.uint32), w), f
    sub = TM.gather_interval_bases(k, p, torch.from_numpy(bases), got)
    assert sub.dtype == torch.uint8 and sub.shape == (n, 2 * k - p)
    assert np.array_equal(sub.numpy(), np.asarray(wsub)[:n])
    return got


KP = [(k, p) for k in (15, 16, 17, 31, 33, 63) for p in (4, 8, 12, 16) if p <= k]


@pytest.mark.parametrize("k,p", KP)
def test_msp_intervals_match_jax(rng, k, p):
    """Every (k, p) with rc, and without it at p = 8 (stranded p = 16:
    test_p16_destination_trap); the scan's (R, Lk) arrays as well at k = 16
    and 63, p = 8 and 16."""
    for rc in (True, False) if p == 8 else (True,):
        bases, lengths = _batch(rng, k)
        assert (lengths < bases.shape[1]).any()  # padding is present
        _same_intervals(k, p, bases, lengths, None, rc)
        if k in (16, 63) and p in (8, 16) and rc:
            want = _jax_scan(k, p, jnp.asarray(bases), jnp.asarray(lengths), rc, None)
            got = TM.msp_scan_batch(k, p, torch.from_numpy(bases), torch.from_numpy(lengths),
                                    None, rc)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p,rc", [(4, True), (8, True), (8, False), (12, True)])
def test_msp_permutation_matches_jax(rng, p, rc):
    perm = rng.permutation(4**p).astype(np.int32)
    bases, lengths = _batch(rng, 31)
    _same_intervals(31, p, bases, lengths, perm, rc)
    # a tensor table works as well as a numpy one
    got = TM.msp_intervals_device(31, p, torch.from_numpy(bases), torch.from_numpy(lengths),
                                  torch.from_numpy(perm), rc)
    want = TM.msp_intervals_device(31, p, torch.from_numpy(bases), torch.from_numpy(lengths),
                                   perm, rc)
    assert all(torch.equal(got[f], want[f]) for f in FIELDS)
    with pytest.raises(ValueError, match="p <= 15"):
        TM.msp_scan_batch(31, 16, torch.from_numpy(bases), torch.from_numpy(lengths),
                          np.zeros(4, np.int32))


@pytest.mark.parametrize("rc", [True, False])
def test_host_api_matches_jax(rng, rc):
    """msp_sequences (a short read among them), msp_sequence and simple_scan
    against the JAX package; the reference oracle too."""
    k, p = 20, 6
    perm = rng.permutation(4**p).astype(np.int32)
    # one padded width (32) for every call of the JAX package's eager scan
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (k, 27, 32, 12, 25)]
    for pm in (None, perm):
        got = TM.msp_sequences(seqs, k, p, pm, rc=rc, device=CPU)
        want = M.msp_sequences(seqs, k, p, pm, rc=rc)
        assert [len(g) for g in got] == [len(w) for w in want] and got[3] == []
        for g, w in zip(got, want):
            for (gb, ge, gs), (wb, we, ws) in zip(g, w):
                assert (gb, ge) == (wb, we) and gs.dtype == np.uint8 and np.array_equal(gs, ws)
        oracle = O.msp_sequence(list(seqs[2]), k, p, None if pm is None else list(pm), rc=rc)
        assert [(b, e, tuple(s.tolist())) for b, e, s in got[2]] == \
            [(b, e, tuple(s)) for b, e, s in oracle]
    one = TM.msp_sequence(seqs[2], k, p, perm, rc=rc, device=CPU)
    assert [(b, e) for b, e, _ in one] == [(b, e) for b, e, _ in M.msp_sequence(seqs[2], k, p, perm, rc=rc)]
    assert TM.msp_sequence(seqs[3], k, p, device=CPU) == []
    tup = lambda ivs: [dataclasses.astuple(iv) for iv in ivs]
    for s in seqs[:3]:
        assert tup(TM.simple_scan(k, s, perm, rc=rc, device=CPU)) == \
            tup(M.simple_scan(k, s, perm, rc=rc))
    # p = 5 without a table: the identity order, as the reference oracle
    parts = O.msp_sequence(list(seqs[2]), k, 5, None, rc=rc)
    assert [(iv.bucket, iv.len) for iv in TM.simple_scan(k, seqs[2], rc=rc, p=5, device=CPU)] == \
        [(b, len(sub)) for b, _, sub in parts]
    iv = TM.simple_scan(k, seqs[2], perm, rc=rc, device=CPU)[0]
    assert iv.end == iv.start + iv.len and iv.range == range(iv.start, iv.end)


def test_simple_scan_validation():
    with pytest.raises(ValueError, match="p <= 16"):
        TM.pmer_ranks(17, torch.zeros((2, 32), dtype=torch.uint8), torch.full((2,), 32))
    with pytest.raises(ValueError, match="shorter than k"):
        TM.simple_scan(31, np.zeros(10, np.uint8), device=CPU)
    with pytest.raises(ValueError, match="p <= 8"):
        TM.simple_scan(16, np.zeros(20, np.uint8), p=9, device=CPU)
    with pytest.raises(ValueError, match="not 4\\^p"):
        TM.simple_scan(16, np.zeros(20, np.uint8), np.zeros(100, np.int32), device=CPU)


def test_score_tables_match_jax(rng):
    p = 5

    def at_count(ranks):
        c = np.zeros_like(ranks, dtype=np.int32)
        r = ranks.copy()
        for _ in range(p):
            b = r & 3
            c += ((b == 0) | (b == 3)).astype(np.int32)
            r >>= 2
        return c

    assert np.array_equal(TM.score_table_from_fn(p, at_count), M.score_table_from_fn(p, at_count))
    scalar = lambda r: bin(int(r)).count("1")
    assert np.array_equal(TM.score_table_from_fn(4, scalar), M.score_table_from_fn(4, scalar))
    bases, lengths = _batch(rng, 31, n=40)
    for ln in (None, lengths):
        assert np.array_equal(TM.inverse_frequency_score_table(6, bases, ln),
                              M.inverse_frequency_score_table(6, bases, ln))
    for fn, args in ((TM.score_table_from_fn, (14, at_count)),
                     (TM.inverse_frequency_score_table, (14, bases)),
                     (TM.inverse_frequency_score_table, (6, bases[:, :4]))):
        with pytest.raises(ValueError):
            fn(*args)


def test_p16_destination_trap(rng):
    """At p = 16 a bucket may be 2^31 or more: JAX keeps it in an int32 lane
    and shards by the floor mod of that view.  With 3 shards the view and
    the unsigned value give different shards; the port's tables per shard
    equal JAX's on a 3-device mesh."""
    from tpu_debruijn.parallel import make_mesh, sharded_tables
    from tpu_debruijn.parallel.shard import _dest_histogram_fn

    k, p = 31, 16
    # stranded, a read of 30 bases of G/T then one of A/C may have a
    # minimizer that starts with G/T and ends with A/C: it and its rc are
    # both 2^31 or more
    seqs = [np.concatenate([rng.integers(2, 4, 30), rng.integers(0, 2, 1)]).astype(np.uint8)
            for _ in range(24)] + [rng.integers(0, 4, 90).astype(np.uint8) for _ in range(24)]
    bases, lengths = F.pad_reads(seqs, min_len=k, pad_to=16)
    iv = TM.msp_intervals_device(k, p, torch.from_numpy(bases), torch.from_numpy(lengths),
                                 rc=False)
    high = iv["bucket"] >= 2**31
    assert high.any()
    dest = TS._dest(iv["bucket"], 3)
    assert (dest != iv["bucket"] % 3)[high].any()
    view = iv["bucket"].numpy().astype(np.uint32).view(np.int32)
    assert np.array_equal(dest.numpy(), view % 3)

    mesh = make_mesh(3)
    plan, table, *_ = sharded_tables(seqs, k, p, mesh=mesh, min_obs=1, stranded=True)
    stats = {}
    got = TP.sharded_tables(seqs, k, p, mesh=TP.make_mesh(3, device=CPU), min_obs=1,
                            stranded=True, device=CPU, stats=stats)
    nv = np.asarray(table.n_valid)
    assert len(got[1]) == 3 and (nv > 0).all()
    for s in range(3):
        n = int(nv[s])
        assert np.array_equal(got[1][s].kmers.numpy().astype(np.uint32),
                              np.asarray(table.kmers)[s, :n])
        assert np.array_equal(got[1][s].counts.numpy(), np.asarray(table.counts)[s, :n])
    hist = TP.dest_histogram(k, p, 3, bases, lengths, stranded=True, device=CPU)
    want = _dest_histogram_fn(k, p, 3, True, mesh)(jnp.asarray(bases), jnp.asarray(lengths))
    assert np.array_equal(hist, np.asarray(want))
    assert list(hist.sum(0)) == stats["intervals"]
