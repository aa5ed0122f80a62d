"""Host padding: ``filter.pad_reads`` and ``filter._read_batch`` against
the Python loop they replaced.

A list or tuple of rows is padded by one native walk (``csrc/host_pad.cpp``)
up to the first row it cannot take, and by the Python loop from there; the
bytes, lengths, exts and labels must equal the loop's (kept below as the
oracle) bit for bit, and ``pad_reads.native_rows`` / ``python_rows`` count
the rows each padded.  Then ragged labelled reads through ``filter_kmers``,
``filter_kmers_set_arrays`` and ``assemble_sharded`` on the native path
against the JAX package (on the CPU).
"""

import collections

import numpy as np
import pytest

from tpu_debruijn import filter as F
from tpu_debruijn.parallel import assemble_sharded, make_mesh
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import host_pad as HP
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch.kmer import KmerSpec

from test_torch_colored import same_table

CPU = "cpu"


def loop_pad_reads(seqs, min_len, pad_to=None):
    """The Python loop ``pad_reads`` ran before the native walk."""
    if not seqs:
        raise ValueError("no sequences")
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    l = max(int(lengths.max()), min_len)
    if pad_to:
        l = -(-l // pad_to) * pad_to
    out = np.zeros((len(seqs), l), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    return out, lengths


def loop_read_batch(items, min_len, pad_to, labels=None):
    """``_read_batch``'s arrays before the native walk."""
    bases, lengths = loop_pad_reads([s[0] for s in items], min_len, pad_to)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    if labels is None:
        labels = np.array([s[2] for s in items], dtype=np.int32)
    return bases, lengths, seq_exts, labels


def ragged(rng, n=40, lo=0, hi=200):
    return [rng.integers(0, 4, int(m)).astype(np.uint8) for m in rng.integers(lo, hi, n)]


def _odd_row(kind, rng, m=50):
    """Bases the native walk cannot take; the loop pads them."""
    if kind == "strided":
        return rng.integers(0, 4, 2 * m).astype(np.uint8)[::2]
    if kind == "int64":
        return rng.integers(0, 4, m).astype(np.int64)
    return rng.integers(0, 4, m).tolist()


# name -> (rows, min_len, the row the native walk stops at, or None)
def _case(name, rng):
    rows = ragged(rng)
    if name == "ragged":
        return rows, 31, None
    if name == "empty_read":
        rows[7] = np.zeros(0, np.uint8)
        return rows, 31, None
    if name == "short":
        return ragged(rng, lo=0, hi=31), 31, None
    if name == "min_len_above":
        return rows, 257, None
    if name == "one_row":
        return rows[:1], 1, None
    kind, stop = name.split("_at_")
    rows[int(stop)] = _odd_row(kind, rng)
    return rows, 31, int(stop)


CASES = ["ragged", "empty_read", "short", "min_len_above", "one_row",
         "strided_at_0", "strided_at_13", "int64_at_39", "list_at_5"]


PAD = TF.pad_reads  # the function that holds the counts


class Counts:
    """The padding counters' growth over a block."""

    def __enter__(self):
        self.n0, self.p0 = PAD.native_rows, PAD.python_rows
        return self

    def __exit__(self, *exc):
        self.native = PAD.native_rows - self.n0
        self.python = PAD.python_rows - self.p0


def _items(rng, rows):
    """(bases, exts, label) items: every exts byte and negative labels,
    the int32 extremes among them."""
    exts = rng.integers(0, 256, len(rows))
    exts[:2] = [0, 255][: len(rows)]
    labels = rng.integers(-(2**31), 2**31, len(rows))
    labels[:2] = [-(2**31), 2**31 - 1][: len(rows)]
    return [(r, int(e), int(b)) for r, e, b in zip(rows, exts, labels)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("pad_to", [None, 1, 16])
@pytest.mark.parametrize("form", ["reads", "items", "items_labels", "tuple"])
@pytest.mark.parametrize("case", CASES)
def test_pad_matches_loop(rng, case, form, pad_to):
    """Bit-equal to the loop; the native walk pads every row before the
    first it cannot take, the loop the rest."""
    assert HP.library() is not None  # the walk under test needs a host C++ compiler
    rows, min_len, stop = _case(case, rng)
    r = len(rows)
    with Counts() as c:
        if form in ("reads", "tuple"):
            seqs = rows if form == "reads" else tuple(rows)
            _same(TF.pad_reads(seqs, min_len, pad_to), loop_pad_reads(rows, min_len, pad_to))
        else:
            items = _items(rng, rows)
            labels = (np.arange(r, dtype=np.int32) - 3) if form == "items_labels" else None
            got = TF.pad_reads(items, min_len, pad_to, items=True, labels=labels)
            _same(got, loop_read_batch(items, min_len, pad_to, labels))
    native = r if stop is None else stop
    assert (c.native, c.python) == (native, r - native)


@pytest.mark.parametrize("odd", ["numpy_exts", "numpy_label", "float_label", "short_item",
                                 "list_item", "bytearray", "memoryview"])
def test_items_the_walk_reads_or_leaves(rng, odd):
    """An exts or label that is no Python int stops the measure pass and
    the loop reads the rest; a list item and a bytearray or memoryview of
    uint8 bases are taken whole.  Either way the loop's arrays, and every
    row's bytes from the copy pass."""
    items = _items(rng, ragged(rng, lo=31))
    r = len(items)
    bases, e, b = items[9]
    items[9] = {"numpy_exts": (bases, np.int64(e), b), "numpy_label": (bases, e, np.int32(b)),
                "float_label": (bases, e, 2.0), "short_item": (bases, e),
                "list_item": [bases, e, b], "bytearray": (bytearray(bases), e, b),
                "memoryview": (memoryview(bases), e, b)}[odd]
    if odd == "short_item":  # the loop's IndexError, from the loop
        with pytest.raises(IndexError):
            TF.pad_reads(items, 31, 16, items=True)
        with Counts() as c:
            got = TF.pad_reads(items, 31, 16, items=True, labels=np.zeros(r, np.int32))
        _same(got, loop_read_batch(items, 31, 16, np.zeros(r, np.int32)))
        assert c.native == r
        return
    with Counts() as c:
        got = TF.pad_reads(items, 31, 16, items=True)
    _same(got, loop_read_batch(items, 31, 16))
    assert c.native == r


def test_refusals_match_loop(rng):
    """The inputs the loop refuses are refused alike: an empty list, a
    bytes row (NumPy reads it as a string), a label beyond int32."""
    with pytest.raises(ValueError, match="no sequences"):
        TF.pad_reads([], 31)
    rows = ragged(rng, lo=31)
    rows[3] = b"\x01\x02"
    with pytest.raises(ValueError):
        loop_pad_reads(rows, 31)
    with pytest.raises(ValueError):
        TF.pad_reads(rows, 31)
    items = _items(rng, ragged(rng, lo=31))
    items[4] = (items[4][0], 0, 2**31)
    with pytest.raises(OverflowError):
        TF.pad_reads(items, 31, items=True)


def test_other_sequences_take_the_loop(rng):
    """Not a list or tuple (a deque): the loop pads it all."""
    reads = collections.deque(ragged(rng, n=20))
    with Counts() as c:
        got = TF.pad_reads(reads, 31, 16)
    _same(got, loop_pad_reads(reads, 31, 16))
    assert (c.native, c.python) == (0, 20)


def test_loop_without_the_library(rng, monkeypatch):
    """No library (no host compiler or no Python.h): the loop pads every
    row, with the same bytes."""
    monkeypatch.setattr(HP, "library", lambda: None)
    items = _items(rng, ragged(rng))
    with Counts() as c:
        got = TF._read_batch(KmerSpec(31), items, CPU)
    _same([t.numpy() for t in got], loop_read_batch(items, 31, 16))
    assert (c.native, c.python) == (0, len(items))


def test_counts_survive_a_rebound_name(rng, monkeypatch):
    """A wrapper put over the module's ``pad_reads`` (as a test's
    monkeypatch does) leaves the counts on the function."""
    orig = TF.pad_reads
    monkeypatch.setattr(TF, "pad_reads", lambda *a, **kw: orig(*a, **kw))
    with Counts() as c:
        TF._read_batch(KmerSpec(31), _items(rng, ragged(rng, lo=31)), CPU)
    assert c.native == 40


# ---------------------------------------------------------------------------
# the callers on the native path, against the JAX package
# ---------------------------------------------------------------------------


def ragged_reads(rng, n=80, lo=20, hi=120):
    """Reads of one 600-base genome from 20 to 119 bases long (some shorter
    than K = 31), half reverse complemented, with labels in [-1, 3)."""
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    reads = []
    for m in rng.integers(lo, hi, n):
        s = int(rng.integers(0, len(genome) - m + 1))
        r = genome[s : s + m].copy()
        reads.append((3 - r[::-1]).astype(np.uint8) if rng.random() < 0.5 else r)
    return reads, (rng.integers(0, 4, n) - 1).tolist()


@pytest.mark.parametrize("data_reduce", ["label_first", "min"])
def test_filter_kmers_native_matches_jax(rng, data_reduce):
    reads, labels = ragged_reads(rng)
    items = [(r, int(e), b) for r, e, b in zip(reads, rng.integers(0, 256, len(reads)), labels)]
    with Counts() as c:
        got = TF.filter_kmers(items, 31, min_obs=1, data_reduce=data_reduce, device=CPU)
    want = F.filter_kmers(items, 31, min_obs=1, data_reduce=data_reduce)
    assert c.native > 0 and c.python == 0 and len(want) > 100
    same_table(got, want)


def test_filter_kmers_set_arrays_native_matches_jax(rng):
    reads, labels = ragged_reads(rng)
    items = list(zip(reads, [0] * len(reads), labels))
    with Counts() as c:
        got, gl, gs = TF.filter_kmers_set_arrays(items, 31, device=CPU)
    want, wl, ws = F.filter_kmers_set_arrays(items, 31)
    assert c.native > 0 and c.python == 0 and len(want) > 100
    same_table(got, want)
    assert np.array_equal(gl.numpy(), wl) and np.array_equal(gs.numpy(), ws)


def test_assemble_sharded_native_matches_jax(rng, tmp_path):
    reads, labels = ragged_reads(rng)
    reads = reads + reads  # each kmer seen twice, so min_obs = 2 keeps it
    long_labels = np.array([b for r, b in zip(reads, labels + labels) if len(r) >= 31], np.int32)
    with Counts() as c:
        got = TP.assemble_sharded(reads, 31, 8, min_obs=2, labels=long_labels,
                                  mesh=TP.make_mesh(8, device=CPU), device=CPU)
    want = assemble_sharded(reads, 31, 8, min_obs=2, labels=long_labels, mesh=make_mesh(8),
                            cap_per_dest=256)
    assert c.native == len(long_labels) and c.python == 0 and len(got) > 0
    got.to_gfa(str(tmp_path / "t.gfa"))
    want.to_gfa(str(tmp_path / "j.gfa"))
    assert (tmp_path / "t.gfa").read_bytes() == (tmp_path / "j.gfa").read_bytes()
