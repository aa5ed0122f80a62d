"""Port parity for the read-ordered chain-linking path: pointer-doubling
ranking (``_rank_all``), the segmented scans, the ``obs_min``/``min``
tables, ``link_chains_ordered`` and the slice end to end, against the JAX
package on the CPU.  Every output is an integer: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import sorting as TS
from tpu_debruijn_torch import table_from_reference, table_to_numpy


def _forest(rng, m, n_cycles=0):
    """Successors over m states: random lists, plus ``n_cycles`` cycles."""
    order = rng.permutation(m)
    succ = np.full(m, -1, np.int64)
    cuts = np.sort(rng.choice(np.arange(1, m), size=m // 9, replace=False))
    for part in np.split(order, cuts):
        succ[part[:-1]] = part[1:]
        if n_cycles and len(part) > 1:
            succ[part[-1]] = part[0]
            n_cycles -= 1
    return succ


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("n_cycles", [0, 3])
@pytest.mark.parametrize("m", [1, 2, 77, 1000])
def test_rank_all_matches_jax(rng, m, n_cycles, seeded):
    succ = _forest(rng, m, n_cycles) if m > 2 else np.array([1, -1], np.int64)[-m:]
    mnmo = rng.integers(0, 1 << 30, m)
    args = [succ, mnmo]
    if seeded:
        args += [rng.integers(0, 50, m), np.where(succ < 0, rng.integers(0, 1 << 20, m), -1)]
    want = C._rank_all(*[jnp.asarray(a.astype(np.int32)) for a in args])
    got = TC._rank_all(*[torch.from_numpy(a) for a in args])
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_rank_all_refuses_wide_carry():
    succ = torch.empty(1 << 31, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        TC._rank_all(succ, succ)


@pytest.mark.parametrize("first_set", [False, True])
@pytest.mark.parametrize("n", [1, 5, 300])
def test_segmented_scans_match_jax(rng, n, first_set):
    vals = rng.integers(0, 1 << 29, n)
    flags = rng.random(n) < 0.2
    flags[0] = first_set
    jv, jf = jnp.asarray(vals.astype(np.int32)), jnp.asarray(flags)
    tv, tf = torch.from_numpy(vals), torch.from_numpy(flags)
    assert np.array_equal(TS.copy_first(tv, tf).numpy(), np.asarray(C._copy_first_packed(jv, jf)))
    assert np.array_equal(TS.copy_last(tv, tf).numpy(), np.asarray(C._copy_last_packed(jv, jf)))
    # the interval minimum: JAX's suffix segmented min read at segment
    # starts equals one scatter-min per segment
    is_end = flags.copy()
    is_end[-1] = True
    starts = np.concatenate([[True], is_end[:-1]])
    want = np.asarray(C._min_suffix_packed(jv, jnp.asarray(is_end)))[starts]
    seg = torch.from_numpy(np.cumsum(starts) - 1)
    assert np.array_equal(TS.segment_min(tv, seg, int(starts.sum())).numpy(), want)


def _ragged_reads(rng, n=40, glen=300):
    g = rng.integers(0, 4, glen)
    out = []
    for i in range(n):
        s = int(rng.integers(0, glen - 100))
        r = g[s : s + int(rng.integers(20, 100))].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        out.append((r.astype(np.uint8), int(rng.integers(0, 256)), int(rng.integers(0, 1000))))
    return out


@pytest.mark.parametrize("data_reduce", ["obs_min", "min"])
@pytest.mark.parametrize("min_obs", [1, 2])
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 31, 47, 63])
def test_filter_data_reduce_matches_jax(rng, k, stranded, min_obs, data_reduce):
    """Reads shorter than K are dropped and the rest padded: the obs_min
    slot index counts the padded slots of every kept read."""
    reads = _ragged_reads(rng)
    kw = dict(stranded=stranded, min_obs=min_obs, data_reduce=data_reduce)
    ref = F.filter_kmers(reads, k, **kw)
    got = table_to_numpy(TF.filter_kmers(reads, k, device="cpu", **kw))
    assert len(got["kmers"]) == len(ref.kmers) > 0
    for key in ("kmers", "exts", "counts", "data"):
        assert np.array_equal(np.asarray(getattr(ref, key)), got[key]), key


def _corpus(rng, k):
    """Reads tiling random contigs (tests/test_compress.py's corpus)."""
    reads = []
    for c in O.random_contigs(rng):
        c = np.asarray(c, np.uint8)
        for s in range(0, max(len(c) - 60, 1), 13):
            r = c[s : s + 60]
            if len(r) < k:
                continue
            if rng.random() < 0.5:
                r = (3 - r[::-1]).astype(np.uint8)
            reads.append((r, 0, 0))
    return reads


def _chains(ch):
    nu = int(ch.n_unitigs)
    cols = (ch.uid, ch.pos, ch.flip)
    per_unitig = (ch.length, ch.first_item, ch.last_item, ch.first_flip, ch.last_flip)
    return (
        [np.asarray(a).astype(np.int64).tolist() for a in cols],
        nu,
        [np.asarray(a)[:nu].astype(np.int64).tolist() for a in per_unitig],
    )


def _both_ordered(k, stranded, table, first_pos, cap):
    """(JAX ordered compress, port ordered compress) on one table."""
    n = len(table.kmers)
    want = C._compress_ordered_jit(
        C.KmerSpec(k), stranded, cap, jnp.asarray(table.kmers), jnp.asarray(table.exts),
        jnp.int32(n), jnp.asarray(first_pos.astype(np.int32)),
    )
    t = table_from_reference(k, stranded, table.kmers, table.exts, table.counts, table.data, device="cpu")
    got = TC.compress_kmer_table_device(
        t.spec, stranded, t.kmers, t.exts, first_pos=torch.from_numpy(first_pos), order_cap=cap
    )
    return want, got, t


def _same_compress(want, got):
    assert bool(got[3]) == bool(want[3])
    assert _chains(got[0]) == _chains(want[0])
    nu = got[0].n_unitigs
    assert np.array_equal(got[1].numpy()[:nu], np.asarray(want[1])[:nu])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]).astype(np.int64))


@pytest.mark.parametrize("order", ["real", "junk", "ties"])
@pytest.mark.parametrize("stranded", [False, True])
def test_link_chains_ordered_matches_jax(rng, stranded, order):
    """Real first-occurrence order, a random permutation, and all ties: the
    result never depends on the ordering hint."""
    k = 21
    table = F.filter_kmers(_corpus(rng, k), k, stranded=stranded, min_obs=1, data_reduce="obs_min")
    n = len(table.kmers)
    assert n > 100
    fp, cap = {
        "real": (np.asarray(table.data, np.int64), 1 << 12),
        "junk": (rng.permutation(n).astype(np.int64), n),
        "ties": (np.zeros(n, np.int64), n),
    }[order]
    want, got, t = _both_ordered(k, stranded, table, fp, cap)
    assert not bool(got[3])
    _same_compress(want, got)
    plain = TC.compress_kmer_table_device(t.spec, stranded, t.kmers, t.exts)
    assert _chains(plain[0]) == _chains(got[0])


@pytest.mark.parametrize("stranded", [False, True])
def test_link_chains_ordered_cycle_fallback(rng, stranded, monkeypatch):
    """A circular genome contracts to a cycle of intervals: the ordered
    linker ranks every state instead, and cuts the cycle as the reference
    does."""
    k = 25
    g = rng.integers(0, 4, 240).astype(np.uint8)
    circ = np.concatenate([g, g[: k + 59]])
    reads = [(circ[s : s + 60], 0, 0) for s in range(0, 240, 11)]
    table = F.filter_kmers(reads, k, stranded=stranded, min_obs=1, data_reduce="obs_min")
    calls = []
    rank_all = TC._rank_all
    monkeypatch.setattr(TC, "_rank_all", lambda *a: calls.append(len(a[0])) or rank_all(*a))
    want, got, _ = _both_ordered(k, stranded, table, np.asarray(table.data, np.int64), 1 << 12)
    n = len(table.kmers)
    # contracted ranking, then the full 2n-state ranking and its re-rank
    assert calls[1:] == [2 * n, 2 * n] and calls[0] < 2 * n
    _same_compress(want, got)
    assert got[0].n_unitigs == 1


def test_link_chains_ordered_overflow_flag(rng):
    """Too small a cap reports overflow; the port's chains then come from
    the plain linker."""
    reads = [(O.random_dna(rng, 80), 0, 0) for _ in range(40)]
    table = F.filter_kmers(reads, 31, stranded=False, min_obs=1, data_reduce="obs_min")
    want, got, t = _both_ordered(31, False, table, np.asarray(table.data, np.int64), 4)
    assert bool(want[3]) and got[3] is True
    plain = TC.compress_kmer_table_device(t.spec, False, t.kmers, t.exts)
    assert _chains(got[0]) == _chains(plain[0])


def test_link_chains_ordered_empty():
    z = torch.zeros(0, dtype=torch.int64)
    ch, overflow = TC.link_chains_ordered(z, z, z, z, None, z, cap=16)
    assert not overflow and ch.n_unitigs == 0 and ch.uid.shape == (0,)


@pytest.mark.parametrize("k,stranded", [(31, False), (16, True), (47, False)])
def test_ordered_slice_matches_jax_compress(rng, k, stranded):
    """obs_min table -> ordered compress -> assemble_unitigs, against the
    JAX package's compress_kmers on its own table."""
    reads = _corpus(rng, k)
    want = C.compress_kmers(F.filter_kmers(reads, k, stranded=stranded, min_obs=2))
    table = TF.filter_kmers(reads, k, stranded=stranded, min_obs=2, data_reduce="obs_min", device="cpu")
    chains, u_exts, contrib, overflow = TC.compress_kmer_table_device(
        table.spec, stranded, table.kmers, table.exts, first_pos=table.data
    )
    assert not overflow
    cpu = lambda a: a.numpy()
    got = TC.assemble_unitigs(
        table.spec, table_to_numpy(table)["kmers"], cpu(chains.uid), cpu(chains.pos),
        cpu(chains.flip), cpu(chains.length), cpu(chains.first_item), cpu(chains.first_flip),
        chains.n_unitigs, cpu(u_exts), cpu(contrib), cpu(table.counts),
    )
    assert len(got) == len(want) > 1
    for (gs, ge, gd), (ws, we, wd) in zip(got, want):
        assert np.array_equal(gs, ws) and ge == we and gd == wd
