"""The port's host-side API against the JAX package, exactly: ``Exts`` and
``Dir`` over all 256 bytes, the kmer helpers (host converters and tensor
ops) at every limb layout, ``neighbors.one_hamming_iter``, and the
sequence containers ``DnaSeq``, ``SeqSlice``, ``DnaSeqBuilder`` and
``PackedSeqSet.get``."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_debruijn as R
import tpu_debruijn_torch as T
from tpu_debruijn import dna as RD
from tpu_debruijn import exts as RE
from tpu_debruijn import kmer as RK
from tpu_debruijn import neighbors as RN
from tpu_debruijn_torch import dna as TD
from tpu_debruijn_torch import exts as TE
from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch import neighbors as TN

KS = [4, 15, 16, 17, 31, 32, 33, 47, 63, 64]
ALL = np.arange(256, dtype=np.int32)


def test_top_level_exports_match():
    """Every name ``tpu_debruijn/__init__.py`` imports, the port exports."""
    tree = ast.parse(pathlib.Path(R.__file__).read_text())
    names = [a.asname or a.name for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names if node.module != "__future__"]
    assert "SeqSlice" in names and "bases" in names
    missing = [n for n in names if n not in T.__all__]
    assert not missing, missing


def test_exts_vector_ops_all_bytes():
    e = torch.from_numpy(ALL)
    other = torch.from_numpy(ALL[::-1].copy())
    same = lambda got, want: np.array_equal(np.asarray(got), np.asarray(want))
    assert same(TE.merge(e, other), RE.merge(ALL, ALL[::-1]))
    assert same(TE.add(e, other), RE.add(ALL, ALL[::-1]))
    assert same(TE.complement_bits(e), RE.complement_bits(ALL))
    assert same(TE.reverse(e), RE.reverse(ALL))
    assert same(TE.rc(e), RE.rc(ALL))
    assert same(TE.from_single_dirs(e, other), RE.from_single_dirs(ALL, ALL[::-1]))
    for d in (0, 1):
        assert same(TE.dir_bits(e, d), RE.dir_bits(ALL, d))
        assert same(TE.single_dir(e, d), RE.single_dir(ALL, d))
        assert same(TE.num_ext_dir(e, d), RE.num_ext_dir(ALL, d))
        for got, want in zip(TE.unique_extension(e, d), RE.unique_extension(ALL, d)):
            assert same(got, want)
        for b in range(4):
            assert same(TE.set_ext(e, d, b), RE.set_ext(ALL, d, b))
            assert same(TE.has_ext(e, d, b), RE.has_ext(ALL, d, b))
    for b in range(4):
        assert TE.mk_left(b) == RE.mk_left(b) and TE.mk_right(b) == RE.mk_right(b)
        for c in range(4):
            assert TE.mk(b, c) == RE.mk(b, c)
    src = np.random.default_rng(3).integers(0, 4, 40).astype(np.uint8)
    for start in (0, 1, 7, 20):
        for length in (1, 5, 40 - start):
            assert TE.from_slice_bounds(src, start, length) == RE.from_slice_bounds(src, start, length)


def test_exts_scalar_class_all_bytes():
    for v in range(256):
        t, r = TE.Exts(v), RE.Exts(v)
        assert repr(t) == repr(r) and hash(t) == hash(r) and t.val == r.val
        assert t == TE.Exts(v) and t != TE.Exts(v ^ 1) and t != v
        other = 255 - v
        for name in ("add",):
            assert getattr(t, name)(TE.Exts(other)).val == getattr(r, name)(RE.Exts(other)).val
        for name in ("complement", "reverse", "rc"):
            assert getattr(t, name)().val == getattr(r, name)().val
        assert (t.num_exts_l(), t.num_exts_r()) == (r.num_exts_l(), r.num_exts_r())
        for d in (0, 1):
            assert t.get(d) == r.get(d)
            assert t.num_ext_dir(d) == r.num_ext_dir(d)
            assert t.get_unique_extension(d) == r.get_unique_extension(d)
            assert t.single_dir(d).val == r.single_dir(d).val
            for b in range(4):
                assert t.has_ext(d, b) == r.has_ext(d, b)
                assert t.set(d, b).val == r.set(d, b).val
        assert TE.Exts.merge(t, TE.Exts(other)).val == RE.Exts.merge(r, RE.Exts(other)).val
        assert (TE.Exts.from_single_dirs(t, TE.Exts(other)).val
                == RE.Exts.from_single_dirs(r, RE.Exts(other)).val)
    for b in range(4):
        assert TE.Exts.mk_left(b).val == RE.Exts.mk_left(b).val
        assert TE.Exts.mk_right(b).val == RE.Exts.mk_right(b).val
        assert TE.Exts.mk(b, 3 - b).val == RE.Exts.mk(b, 3 - b).val
    assert TE.Exts.empty().val == RE.Exts.empty().val == TE.Exts.new(256).val
    src = np.array([0, 1, 2, 3, 1], np.uint8)
    assert TE.Exts.from_slice_bounds(src, 1, 3).val == RE.Exts.from_slice_bounds(src, 1, 3).val


def test_dir():
    for d in (0, 1):
        assert TE.Dir.flip(d) == RE.Dir.flip(d)
        assert TE.Dir.pick(d, "l", "r") == RE.Dir.pick(d, "l", "r")
        for f in (False, True, np.bool_(True)):
            assert TE.Dir.cond_flip(d, f) == RE.Dir.cond_flip(d, f)
    d = np.array([0, 1, 1, 0])
    f = np.array([True, False, True, False])
    assert np.array_equal(TE.Dir.flip(torch.from_numpy(d)).numpy(), np.asarray(RE.Dir.flip(d)))
    assert np.array_equal(TE.Dir.cond_flip(torch.from_numpy(d), torch.from_numpy(f)).numpy(),
                          np.asarray(RE.Dir.cond_flip(d, f)))
    assert (TE.Dir.Left, TE.Dir.Right) == (RE.Dir.Left, RE.Dir.Right)


@pytest.mark.parametrize("k", KS)
def test_kmer_host_converters(k):
    rng = np.random.default_rng(k)
    spec_t, spec_r = TK.KmerSpec(k), RK.KmerSpec(k)
    bases = rng.integers(0, 4, 3 * k + 5).astype(np.uint8)
    for lo in (0, 1, 2 * k):
        b = bases[lo : lo + k]
        limbs = TK.from_bases(spec_t, b)
        assert limbs.dtype == np.uint32 and np.array_equal(limbs, RK.from_bases(spec_r, b))
        v = RK.to_int(spec_r, limbs)
        assert TK.to_int(spec_t, limbs) == v
        assert TK.to_int(spec_t, TK.to_torch(limbs[None], "cpu")[0]) == v
        assert np.array_equal(TK.from_int(spec_t, v), RK.from_int(spec_r, v))
        assert np.array_equal(TK.to_bases(spec_t, limbs), RK.to_bases(spec_r, limbs))
        s = RK.to_string(spec_r, limbs)
        assert TK.to_string(spec_t, limbs) == s
        assert np.array_equal(TK.from_string(spec_t, s), RK.from_string(spec_r, s))
    top = (1 << (2 * k)) - 1
    assert np.array_equal(TK.from_int(spec_t, top), RK.from_int(spec_r, top))
    assert TK.to_int(spec_t, TK.from_int(spec_t, top)) == top
    assert np.array_equal(TK.kmers_from_bytes(spec_t, bases), RK.kmers_from_bytes(spec_r, bases))
    assert TK.kmers_from_bytes(spec_t, bases[: k - 1]).shape == (0, spec_t.w)
    ascii_ = "".join("ACGT"[b] for b in bases) + "ac"
    assert np.array_equal(TK.kmers_from_ascii(spec_t, ascii_), RK.kmers_from_ascii(spec_r, ascii_))


@pytest.mark.parametrize("k", KS)
def test_kmer_tensor_helpers(k):
    """empty, mask_value, extend, min_rc, set_base, hamming_dist, at_count,
    gc_count and hamming_neighbors on (n, W) limbs, with limbs >= 2^31 and
    pad bits set in the inputs mask_value clears."""
    rng = np.random.default_rng(100 + k)
    spec_t, spec_r = TK.KmerSpec(k), RK.KmerSpec(k)
    n = 64
    a_np = RK.from_bases_batch_np(spec_r, rng.integers(0, 4, (n, k)))
    b_np = a_np.copy()
    b_np[::2] = RK.from_bases_batch_np(spec_r, rng.integers(0, 4, (n // 2, k)))
    a_np[0] = RK.from_int(spec_r, (1 << (2 * k)) - 1)  # all T: every limb bit set
    a_t, b_t = TK.to_torch(a_np, "cpu"), TK.to_torch(b_np, "cpu")
    a_j, b_j = jnp.asarray(a_np), jnp.asarray(b_np)
    same = lambda got, want: np.array_equal(got.numpy().astype(np.int64),
                                            np.asarray(want).astype(np.int64))

    assert same(TK.empty(spec_t, (3, 2), device="cpu"), RK.empty(spec_r, (3, 2)))
    noisy = a_np | np.uint32(0xFFFFFFFF ^ int(spec_r.top_mask)) * np.eye(1, spec_r.w, dtype=np.uint32)
    assert same(TK.mask_value(spec_t, TK.to_torch(noisy, "cpu")), RK.mask_value(spec_r, jnp.asarray(noisy)))
    v = rng.integers(0, 4, n)
    d = rng.random(n) < 0.5
    assert same(TK.extend(spec_t, a_t, torch.from_numpy(v), torch.from_numpy(d)),
                RK.extend(spec_r, a_j, jnp.asarray(v), jnp.asarray(d)))
    assert same(TK.min_rc(spec_t, a_t), RK.min_rc(spec_r, a_j))
    for pos in (0, k // 2, k - 1):
        assert same(TK.set_base(spec_t, a_t, pos, torch.from_numpy(v)),
                    RK.set_base(spec_r, a_j, pos, jnp.asarray(v)))
        assert same(TK.set_base(spec_t, a_t, pos, 2), RK.set_base(spec_r, a_j, pos, 2))
    assert same(TK.hamming_dist(spec_t, a_t, b_t), RK.hamming_dist(spec_r, a_j, b_j))
    assert not TK.hamming_dist(spec_t, a_t, a_t).any()
    at, gc = TK.at_count(spec_t, a_t), TK.gc_count(spec_t, a_t)
    assert same(at, RK.at_count(spec_r, a_j)) and same(gc, RK.gc_count(spec_r, a_j))
    assert bool((at + gc == k).all())
    cands, mask = TK.hamming_neighbors(spec_t, a_t[:8])
    want_c, want_m = RK.hamming_neighbors(spec_r, a_j[:8])
    assert cands.shape == (8, 4 * k, spec_t.w) and same(cands, want_c) and same(mask, want_m)
    assert bool((mask.sum(1) == 3 * k).all())


@pytest.mark.parametrize("k", [4, 16, 17, 33, 64])
def test_one_hamming_iter(k):
    rng = np.random.default_rng(k)
    limbs = RK.from_bases(RK.KmerSpec(k), rng.integers(0, 4, k))
    got = list(TN.one_hamming_iter(TK.KmerSpec(k), limbs))
    want = list(RN.one_hamming_iter(RK.KmerSpec(k), limbs))
    assert len(got) == 3 * k and all(np.array_equal(g, w) for g, w in zip(got, want))
    cands, mask = TK.hamming_neighbors(TK.KmerSpec(k), TK.to_torch(limbs[None], "cpu"))
    assert np.array_equal(TK.to_numpy(cands[0][mask[0]]), np.stack(want))


def _seq_equal(t, r) -> bool:
    return (len(t) == len(r) and np.array_equal(t.bases(), r.bases())
            and repr(t) == repr(r) and t.to_ascii() == r.to_ascii())


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 70, 200])
def test_dnaseq(length):
    rng = np.random.default_rng(length)
    b = rng.integers(0, 4, length).astype(np.uint8)
    t, r = TD.DnaSeq.from_bases(b), RD.DnaSeq.from_bases(b)
    assert np.array_equal(t.words, r.words) and _seq_equal(t, r)
    assert t.is_empty() == r.is_empty() and t.to_dna_string() == r.to_dna_string()
    assert (t.at_count(), t.gc_count()) == (r.at_count(), r.gc_count())
    assert _seq_equal(t.rc(), r.rc()) and _seq_equal(t.reverse(), r.reverse())
    assert _seq_equal(t.push(7), r.push(7)) and _seq_equal(t.extend([1, 2, 6]), r.extend([1, 2, 6]))
    packed = bytes(rng.integers(0, 256, 5).astype(np.uint8))
    assert _seq_equal(t.push_bytes(packed, 17), r.push_bytes(packed, 17))
    with pytest.raises(ValueError):
        t.push_bytes(packed, 21)
    other = rng.integers(0, 4, length).astype(np.uint8)
    ot, orr = TD.DnaSeq.from_bases(other), RD.DnaSeq.from_bases(other)
    assert t.hamming_distance(ot) == r.hamming_distance(orr) == t.ndiffs(ot) == r.ndiffs(orr)
    assert (t == TD.DnaSeq.from_bases(b)) and not (t == r)
    assert _seq_equal(TD.DnaSeq.blank(length), RD.DnaSeq.blank(length))
    if length:
        for pos in {0, length // 2, length - 1}:
            assert t.get(pos) == r.get(pos)
            assert _seq_equal(t.set(pos, 3), r.set(pos, 3))
        half = length // 2
        assert _seq_equal(t.slice(1, half + 1), r.slice(1, half + 1))
        assert _seq_equal(t.prefix(half), r.prefix(half)) and _seq_equal(t.suffix(half), r.suffix(half))
    for k in (4, 15):
        if length >= k:
            assert np.array_equal(t.get_kmer(k, length - k), r.get_kmer(k, length - k))
            assert np.array_equal(t.first_kmer(k), r.first_kmer(k))
            assert np.array_equal(t.last_kmer(k), r.last_kmer(k))
            assert all(np.array_equal(x, y) for x, y in zip(t.iter_kmers(k), r.iter_kmers(k)))
            got, want = list(t.iter_kmer_exts(k, 0x5A)), list(r.iter_kmer_exts(k, 0x5A))
            assert len(got) == len(want) == length - k + 1
            assert all(np.array_equal(x, y) and e == f for (x, e), (y, f) in zip(got, want))


def test_dnaseq_from_ascii():
    for s in ["", "ACGTacgt", "ACGTNNACxGT", "NNNN", "acgtRYacgtN", "A" * 40 + "N" + "C" * 3]:
        assert _seq_equal(TD.DnaSeq.from_dna_string(s), RD.DnaSeq.from_dna_string(s))
        assert _seq_equal(TD.DnaSeq.from_acgt_bytes(s.encode()), RD.DnaSeq.from_acgt_bytes(s.encode()))
        got, want = TD.DnaSeq.from_dna_only_string(s), RD.DnaSeq.from_dna_only_string(s)
        assert len(got) == len(want) and all(_seq_equal(g, w) for g, w in zip(got, want))
        for name in (b"read1", b"", b"r/2 extra"):
            assert _seq_equal(TD.DnaSeq.from_acgt_bytes_hashn(s.encode(), name),
                              RD.DnaSeq.from_acgt_bytes_hashn(s.encode(), name))
            assert _seq_equal(TD.DnaSeq.from_acgt_bytes_hashn(s, name),
                              RD.DnaSeq.from_acgt_bytes_hashn(s, name))
    # the Ns draw different bases for different names, the same for the same
    n = "N" * 64
    assert (TD.DnaSeq.from_acgt_bytes_hashn(n, b"a").bases().tolist()
            != TD.DnaSeq.from_acgt_bytes_hashn(n, b"b").bases().tolist())


@pytest.mark.parametrize("length", [1, 16, 45, 130])
def test_seqslice(length):
    rng = np.random.default_rng(7 + length)
    b = rng.integers(0, 4, length).astype(np.uint8)
    pt, pr = TD.DnaSeq.from_bases(b), RD.DnaSeq.from_bases(b)
    for start, end in {(0, length), (length // 3, length), (1 if length > 1 else 0, length // 2 + 1)}:
        t, r = pt.slice_view(start, end), pr.slice_view(start, end)
        for view_t, view_r in ((t, r), (t.rc(), r.rc()), (t.rc().rc(), r.rc().rc())):
            assert _seq_equal(view_t, view_r) and view_t.is_rc == view_r.is_rc
            assert view_t.to_dna_string() == view_r.to_dna_string()
            assert _seq_equal(view_t.to_owned(), view_r.to_owned())
            assert _seq_equal(view_t.to_dna_seq(), view_r.to_dna_seq())
            m = len(view_t)
            assert [view_t.get(i) for i in range(m)] == [view_r.get(i) for i in range(m)]
            if m >= 2:
                s2t, s2r = view_t.slice(1, m), view_r.slice(1, m)
                assert (s2t.start, s2t.length, s2t.is_rc) == (s2r.start, s2r.length, s2r.is_rc)
                assert _seq_equal(view_t.prefix(m - 1), view_r.prefix(m - 1))
                assert _seq_equal(view_t.suffix(m - 1), view_r.suffix(m - 1))
            if m >= 4:
                assert np.array_equal(view_t.get_kmer(4, m - 4), view_r.get_kmer(4, m - 4))
                assert np.array_equal(view_t.first_kmer(4), view_r.first_kmer(4))
                assert np.array_equal(view_t.last_kmer(4), view_r.last_kmer(4))
                assert all(np.array_equal(x, y) for x, y in zip(view_t.iter_kmers(4), view_r.iter_kmers(4)))
            assert view_t == view_t.to_owned() and view_t.to_owned() == view_t.to_owned()
            assert view_t.__eq__(3) is NotImplemented
        for bad in ((-1, 1), (0, length + 1)):
            with pytest.raises(ValueError):
                TD.SeqSlice(pt, bad[0], bad[1])
        with pytest.raises(ValueError):
            t.slice(0, len(t) + 1)


def test_dnaseq_builder_and_packed_set_get():
    rng = np.random.default_rng(11)
    bt, br = TD.DnaSeqBuilder(), RD.DnaSeqBuilder()
    assert _seq_equal(bt.build(), br.build())
    for _ in range(20):
        b = int(rng.integers(0, 8))
        bt.push(b)
        br.push(b)
        chunk = rng.integers(0, 8, int(rng.integers(0, 30)))
        bt.extend(chunk if rng.random() < 0.5 else chunk.tolist())
        br.extend(chunk)
    assert len(bt) == len(br) and _seq_equal(bt.build(), br.build())
    bt.clear()
    assert len(bt) == 0 and len(bt.build()) == 0
    seqs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(0, 60, 30)]
    st, sr = TD.PackedSeqSet.from_arrays(seqs), RD.PackedSeqSet.from_arrays(seqs)
    for i in range(len(seqs)):
        assert _seq_equal(st.get(i), sr.get(i))
