"""Port parity for device unitig assembly: compress_kmers_flat_device
against the JAX package's and against the port's host assembly, the count
saturation rule on a chain of more than 65,535 items, kmer.get_base_dyn,
and graph.from_flat_output's GFA bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn import kmer as KM
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch import table_from_reference

CPU = "cpu"


def _port(table):
    return table_from_reference(table.spec.k, table.stranded, table.kmers, table.exts,
                                table.counts, table.data, device=CPU)


def _host_flat(t):
    """The port's host assembly of the default policy, as flat buffers."""
    chains, u_exts, contrib = TC.compress_kmer_table_device(t.spec, t.stranded, t.kmers, t.exts)
    cpu = lambda a: a.numpy()
    return TC.assemble_unitigs_flat(
        t.spec, TK.to_numpy(t.kmers), cpu(chains.uid), cpu(chains.pos), cpu(chains.flip),
        cpu(chains.length),
        cpu(chains.first_item), cpu(chains.first_flip), chains.n_unitigs, cpu(u_exts),
        cpu(contrib), cpu(t.counts))


def _same_flat(got, want):
    for g, w, dt in zip(got, want, (np.uint8, np.int64, np.int32, np.int32)):
        assert g.dtype == dt and np.array_equal(g, np.asarray(w).astype(dt))


@pytest.mark.parametrize("contigs", ["palindromes", "repeats"])
@pytest.mark.parametrize("k,stranded", [(16, False), (16, True), (31, False), (47, False), (63, True)])
def test_flat_device_matches_jax_and_host(rng, k, stranded, contigs):
    make = O.simple_random_contigs if contigs == "palindromes" else O.random_contigs
    seqs = [(np.asarray(c, np.uint8), 0, 0) for c in make(rng) if len(c) >= k]
    table = F.filter_kmers(seqs + seqs[::2], k, stranded=stranded, min_obs=1)
    t = _port(table)
    got = TC.compress_kmers_flat_device(t, device=CPU)
    _same_flat(got, C.compress_kmers_flat_device(table))
    _same_flat(got, _host_flat(t))
    assert len(got[1]) > 1 and got[1].sum() == len(t) + len(got[1]) * (k - 1)
    # the default policy of compress_kmers is this assembly
    nodes = TC.compress_kmers(t, device=CPU)
    assert [len(s) for s, _, _ in nodes] == got[1].tolist()


LONG_K, LONG_N = 31, 66_000


@pytest.fixture(scope="module")
def long_chain():
    """The table of one random sequence of 66,000 kmers: one unitig."""
    g = np.random.default_rng(7).integers(0, 4, LONG_N + LONG_K - 1).astype(np.uint8)
    reads = [(g[s : s + 2000], 0, 0) for s in range(0, len(g) - 2000, 1900)] + [(g[-2000:], 0, 0)]
    table = F.filter_kmers(reads, LONG_K, stranded=False, min_obs=1)
    assert len(table) == LONG_N
    return table


@pytest.mark.parametrize("counts", ["ones", "zeros", "max"])
def test_count_saturation_long_chain(long_chain, counts):
    """One unitig of 66,000 items: its data saturates at 65535, whatever
    the counts (zeros included, the JAX package's rule)."""
    n, t = LONG_N, long_chain
    c = {"ones": np.ones(n), "zeros": np.zeros(n), "max": np.full(n, 65535)}[counts].astype(np.int32)
    table = F.KmerTable(t.spec, False, t.kmers, t.exts, c, t.data)
    got = TC.compress_kmers_flat_device(_port(table), device=CPU)
    _same_flat(got, C.compress_kmers_flat_device(table))
    assert got[1].tolist() == [n + LONG_K - 1] and got[3].tolist() == [65535]


def test_flat_device_empty_table():
    z = np.zeros(0, np.int32)
    t = table_from_reference(31, False, np.zeros((0, 2), np.uint32), z, z, z, device=CPU)
    got = TC.compress_kmers_flat_device(t, cap_bases=1 << 10, device=CPU)
    assert [a.shape for a in got] == [(0,)] * 4


@pytest.mark.parametrize("k", [4, 16, 31, 47, 64])
def test_get_base_dyn_matches_jax(rng, k):
    spec = KM.KmerSpec(k)
    limbs = KM.from_bases_batch_np(spec, rng.integers(0, 4, (200, k)))
    pos = rng.integers(0, k, (200, 3))
    want = KM.get_base_dyn(spec, jnp.asarray(limbs)[:, None, :].repeat(3, axis=1), jnp.asarray(pos))
    got = TK.get_base_dyn(TK.KmerSpec(k), TK.to_torch(limbs, CPU)[:, None, :].expand(-1, 3, -1),
                          torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_from_flat_output_gfa_identical(rng, tmp_path):
    seqs = [(np.asarray(c, np.uint8), 0, 0) for c in O.random_contigs(rng)]
    table = F.filter_kmers(seqs, 31, stranded=False, min_obs=1)
    flat = C.compress_kmers_flat_device(table)
    G.from_flat_output(31, False, *flat).finish().to_gfa(str(tmp_path / "jax.gfa"))
    tflat = TC.compress_kmers_flat_device(_port(table), device=CPU)
    g = TG.from_flat_output(31, False, *tflat)
    assert g.rich is None and np.array_equal(g.data, flat[3])
    g.finish(device=CPU).to_gfa(str(tmp_path / "torch.gfa"))
    want = (tmp_path / "jax.gfa").read_bytes()
    assert (tmp_path / "torch.gfa").read_bytes() == want and want.count(b"\nS\t") > 1
