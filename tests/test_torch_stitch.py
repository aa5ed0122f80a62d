"""The device stitch (``compress.stitch_device``) against the host one
(``compress.stitch_flat``), byte for byte, and the merges that run it:
``compress_graph``, ``clean_tips`` and both forms of ``assemble_sharded``
take the device path and give the GFA bytes the host stitch gave.  CPU
tensors; no JAX."""

import numpy as np
import pytest
import torch

from tpu_debruijn_torch import clean as TCL
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch.dna import pack_bases, unpack_bases

CPU = "cpu"
KS = (5, 16, 31, 32, 33, 63)
LAYOUTS = ("random", "singletons", "reused", "left_out", "no_unitig", "passes")


def layout(rng, k: int, name: str):
    """A source of node sequences and a chain layout over some of them:
    (flat, starts, lens, node_ids, uid, pos, flip, nutg).  Lengths are
    random from K, so nodes and the whole source end mid-word."""
    n = 1 if name == "no_unitig" else int(rng.integers(20, 60))
    lens = rng.integers(k, k + 40, n).astype(np.int64)
    if int(lens.sum()) % 16 == 0:
        lens[-1] += 1
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    flat = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    nodes = rng.permutation(n)
    if name == "no_unitig":
        nodes = nodes[:0]
    elif name == "left_out":  # some nodes in no chain
        nodes = nodes[: n // 2]
    uid, pos = [], []
    most = 1 if name == "singletons" else 6
    while len(uid) < len(nodes):  # unitigs of 1 to ``most`` nodes, in any row order
        m = min(int(rng.integers(1, most + 1)), len(nodes) - len(uid))
        pos += rng.permutation(m).tolist()
        uid += [uid[-1] + 1 if uid else 0] * m
    uid, pos = np.asarray(uid, np.int64), np.asarray(pos, np.int64)
    if name == "reused":  # two-node unitigs more: a node past position 0, then one at 0
        pair = np.stack([nodes[pos > 0][:5], nodes[pos == 0][:5]], 1)
        new = int(uid.max()) + 1 + np.arange(len(pair))
        nodes = np.concatenate([nodes, pair.reshape(-1)])
        uid = np.concatenate([uid, np.repeat(new, 2)])
        pos = np.concatenate([pos, np.tile([0, 1], len(pair))])
    flip = rng.random(len(nodes)) < 0.5
    nutg = int(uid.max()) + 1 if len(uid) else 0
    return flat, starts, lens, nodes.astype(np.int64), uid, pos, flip, nutg


@pytest.mark.parametrize("form", ["bytes", "words"])
@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("k", KS)
def test_stitch_device_matches_stitch_flat(k, name, form, monkeypatch):
    rng = np.random.default_rng(1000 * k + LAYOUTS.index(name))
    flat, starts, lens, nodes, uid, pos, flip, nutg = layout(rng, k, name)
    if name == "passes":  # many passes of a few words, the last one partial
        monkeypatch.setattr(TC, "_PASS_WORDS", 3)
    want_flat, want_lens = TC.stitch_flat(k, flat, starts, lens, nodes, uid, pos, flip, nutg)
    src = (torch.from_numpy(flat) if form == "bytes"
           else torch.from_numpy(pack_bases(flat).view(np.int32)))
    t = torch.from_numpy
    words, got_lens = TC.stitch_device(k, src, t(starts), t(lens), t(nodes), t(uid), t(pos),
                                       t(flip), nutg)
    assert got_lens.dtype == torch.int64 and np.array_equal(got_lens.numpy(), want_lens)
    got = words.numpy().view(np.uint32)
    assert np.array_equal(got, pack_bases(want_flat))
    assert np.array_equal(unpack_bases(got, len(want_flat)), want_flat)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 100, 1000])
def test_pack_words_matches_pack_bases(n, monkeypatch):
    monkeypatch.setattr(TC, "_PASS_WORDS", 4)
    bases = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    got = TC.pack_words(torch.from_numpy(bases))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), pack_bases(bases))


# --- every merge takes the device stitch -----------------------------------

K, P = 31, 8


def error_reads(seed=21, genome_len=2000, n=250, read_len=70):
    """Reads of a random genome, half reverse-complemented, one in five
    with one substitution: unitigs, tips and bubbles to merge."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    reads = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - read_len + 1))
        r = genome[s : s + read_len].copy()
        if rng.random() < 0.2:
            j = int(rng.integers(0, read_len))
            r[j] = (r[j] + int(rng.integers(1, 4))) & 3
        reads.append((3 - r[::-1]).astype(np.uint8) if rng.random() < 0.5 else r)
    return reads


def host_stitch(k, src, starts, lens, node_ids, uid, pos, flip, nutg):
    """The host stitch as the merge ran it before: the source unpacked to a
    byte a base, ``stitch_flat``, the result packed."""
    host = src.cpu().numpy()
    flat = host if src.dtype == torch.uint8 else unpack_bases(host.view(np.uint32),
                                                              int(lens.sum()))
    out, out_lens = TC.stitch_flat(k, flat, *(x.cpu().numpy() for x in
                                              (starts, lens, node_ids, uid, pos, flip)), nutg)
    return torch.from_numpy(pack_bases(out).view(np.int32)), torch.from_numpy(out_lens)


def refuse(*a, **kw):
    raise AssertionError("the host stitch ran")


def tip(node):
    return node.len() < 2 * K


def table(reads):
    return TF.filter_kmers([(r, 0, 0) for r in reads], K, min_obs=1, device=CPU)


def unsharded(reads):
    nodes = TC.compress_kmers(table(reads), device=CPU)
    return TG.from_compress_output(K, False, nodes).finish(device=CPU)


def node_graph(reads):
    """A node a kmer, so that compress_graph merges them into unitigs."""
    t = table(reads)
    seqs = TK.to_bases_batch_np(t.spec, TK.to_numpy(t.kmers))
    nodes = list(zip(seqs, t.exts.tolist(), t.counts.tolist()))
    return TG.from_compress_output(K, False, nodes).finish(device=CPU)


CASES = {
    "compress_graph": lambda reads: TG.compress_graph(node_graph(reads), device=CPU),
    "clean_tips": lambda reads: TCL.clean_tips(unsharded(reads), tip, device=CPU),
    "sharded_collective": lambda reads: TP.assemble_sharded(
        reads, K, P, mesh=TP.make_mesh(8, device=CPU), device=CPU),
    "sharded_combined": lambda reads: TP.assemble_sharded(
        reads, K, P, mesh=TP.make_mesh(8, device=CPU), collective=False, device=CPU),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_merge_takes_the_device_stitch(case, monkeypatch, tmp_path):
    reads = error_reads()
    with monkeypatch.context() as m:  # the merge as it ran with the host stitch
        m.setattr(TC, "stitch_device", host_stitch)
        before = CASES[case](reads)
        before.to_gfa(str(tmp_path / "before.gfa"))
    monkeypatch.setattr(TC, "stitch_flat", refuse)
    calls, bases = TC.stitch_device.calls, TC.stitch_device.bases
    after = CASES[case](reads)
    after.to_gfa(str(tmp_path / "after.gfa"))
    assert (tmp_path / "after.gfa").read_bytes() == (tmp_path / "before.gfa").read_bytes()
    assert len(after) > 0 and TC.stitch_device.calls == calls + 1
    assert TC.stitch_device.bases == bases + after.base.sequences.total_bases()
