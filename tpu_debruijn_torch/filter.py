"""Kmer counting / filtering (counterpart of ``tpu_debruijn/filter.py``).

Same semantics as the JAX package's ``filter_kmers`` (rust-debruijn's
filter.rs:139-231): enumerate every kmer of every read with its extension
byte, canonicalize to min(kmer, rc) unless stranded, group equal kmers,
and keep a kmer when it was seen at least ``min_obs`` times; its exts are
the OR over its observations and its count saturates at 65535.

Shapes are dynamic here, so the JAX package's static-shape devices (the
sentinel-validity sort layout, the packed ``pos << 8`` partition key) are
gone: invalid slots are dropped before the sort and per-run aggregates come
from run boundaries.  On a CUDA tensor the frontend is the fused kernel
(``kernels/extract_canonical.py``); on a CPU tensor it is the plain
:func:`extract_kmers` + :func:`canonicalize`.

``jax.lax.sort`` carries each observation's exts and label through the sort
as payload operands; ``torch.sort`` has none.  So each observation becomes
one packed int32 row (:func:`pack_obs_rows`: the limbs' 32-bit words, exts,
the label, padding to 16 or 32 bytes) and every per-observation move is one
row gather (``kernels.gather_rows``): the valid-slot compaction and the
sort permutation.  The count's whole tail (run starts, counts, the exts
OR, each run's head row and reduced label) is one ``kernels.run_reduce_rows``
pass over the sorted rows, which writes one row a run in place over them.

:func:`filter_kmers_streaming` counts a corpus in chunks: each chunk's
table is LSM-merged on the host (``merge="host"``), or joined into a
sorted unique table kept on the device (``merge="device"``,
:func:`merge_unique`: a searchsorted join, not a sort).  The JAX package's
static-shape state of that merge (sentinel rows, block compaction,
capacity growth, lagged confirmation and replays, power-of-two row
padding) is gone.

The policy layer (filter.rs:27-101): label sets
(:func:`filter_kmers_set_arrays`, one :func:`count_kmer_pairs` batch rolled
up per kmer), eq classes (:func:`eq_class_ids`, by one sort), pluggable
summarizers called on the host over the card's sorted observations
(:func:`filter_kmers_with_summarizer`), and censored-extension repair by
one search of each kmer's eight neighbors (:func:`neighbor_bits`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_debruijn_torch import host_pad as HP
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.kernels.canonical import canonicalize as _canonicalize
from tpu_debruijn_torch.kernels.extract_canonical import extract_canonical, extract_kmers
from tpu_debruijn_torch.kernels.gather import gather_rows
from tpu_debruijn_torch.kernels.run_reduce import COUNT_MAX, run_reduce, run_reduce_rows
from tpu_debruijn_torch.kmer import M32, KmerSpec
from tpu_debruijn_torch.stages import Stages

__all__ = [
    "CountFilter",
    "CountFilterEqClass",
    "CountFilterSet",
    "KmerSummarizer",
    "KmerTable",
    "PackedReadBlock",
    "assign_eq_classes",
    "canonicalize",
    "count_bytes_per_read",
    "count_kmer_pairs",
    "count_kmers",
    "eq_class_ids",
    "extract_kmers",
    "filter_kmers",
    "filter_kmers_eq_classes",
    "filter_kmers_set",
    "filter_kmers_set_arrays",
    "filter_kmers_streaming",
    "filter_kmers_with_summarizer",
    "merge_unique",
    "neighbor_bits",
    "obs_row_words",
    "pack_obs_rows",
    "pad_reads",
    "remove_censored_exts",
    "remove_censored_exts_device",
    "remove_censored_exts_sharded",
    "row_limbs",
    "unpack_2bit",
]

def canonicalize(spec: KmerSpec, kmers: torch.Tensor, exts: torch.Tensor, stranded: bool):
    """min_rc_flip + Exts::rc on flip (filter.rs:190-196) over (..., W)
    kmers; the identity with flip = False when stranded."""
    if stranded:
        return kmers, exts, torch.zeros(kmers.shape[:-1], dtype=torch.bool, device=kmers.device)
    shape = exts.shape
    ck, ce, flip = _canonicalize(spec, kmers.reshape(-1, spec.w), exts.reshape(-1))
    return ck.reshape(kmers.shape), ce.reshape(shape), flip.reshape(shape)


@dataclasses.dataclass
class KmerTable:
    """A filtered kmer table on one device: sorted unique kmers.

    ``kmers`` (n, W) int64 limbs; ``exts``, ``counts`` and ``data`` (n,)
    int32.  ``all_kmers`` is the census of every distinct kmer, filtered or
    not, when asked for.
    """

    spec: KmerSpec
    stranded: bool
    kmers: torch.Tensor
    exts: torch.Tensor
    counts: torch.Tensor
    data: torch.Tensor
    all_kmers: Optional[torch.Tensor] = None

    def __len__(self):
        return self.kmers.shape[0]

    def kmer_ints(self) -> List[int]:
        return [KM.to_int(self.spec, row) for row in KM.to_numpy(self.kmers)]

    # -- lookups (BoomHashMap2 surface: filter.rs:9,228; boomphf get) -----
    def get_key_id(self, kmer_limbs) -> Optional[int]:
        """Row of one (W,) kmer in the sorted table, or None
        (Mphf::try_hash): one binary search on the table's device, one read
        of its result."""
        q = torch.from_numpy(np.asarray(kmer_limbs, np.uint32).astype(np.int64).reshape(1, self.spec.w))
        idx, found = S.searchsorted_limbs(self.kmers, q.to(self.kmers.device))
        i, ok = torch.stack([idx[0], found[0].to(torch.int64)]).tolist()
        return i if ok else None

    def get(self, kmer_limbs):
        """(exts, data) of a kmer, or None (BoomHashMap2::get)."""
        i = self.get_key_id(kmer_limbs)
        if i is None:
            return None
        return tuple(torch.stack([self.exts[i], self.data[i]]).tolist())

    def get_key(self, i: int) -> np.ndarray:
        """(W,) uint32 limbs of row i (BoomHashMap2::get_key)."""
        return KM.to_numpy(self.kmers[i])

    def to_tuples(self):
        """[(kmer as an int, exts, count)] in table order."""
        exts, counts = self.exts.tolist(), self.counts.tolist()
        return [(v, exts[i], counts[i]) for i, v in enumerate(self.kmer_ints())]

    # -- checkpoint (kmers and exts derive Serialize, kmer.rs:231) --------
    def save(self, path) -> None:
        """The JAX package's npz: ``k``, ``stranded``, uint32 ``kmers``,
        int32 ``exts``/``counts``/``data``, and ``all_kmers`` when present."""
        extra = {} if self.all_kmers is None else {"all_kmers": KM.to_numpy(self.all_kmers)}
        col = lambda t: t.cpu().numpy().astype(np.int32)
        np.savez_compressed(path, k=self.spec.k, stranded=self.stranded,
                            kmers=KM.to_numpy(self.kmers), exts=col(self.exts),
                            counts=col(self.counts), data=col(self.data), **extra)

    @staticmethod
    def load(path, device="cuda") -> "KmerTable":
        """A table saved by :meth:`save` or by the JAX package, on ``device``."""
        z = np.load(path)
        spec = KmerSpec(int(z["k"]))
        col = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
        limbs = lambda a: KM.to_torch(a, device).reshape(-1, spec.w)
        return KmerTable(spec, bool(z["stranded"]), limbs(z["kmers"]), col(z["exts"]),
                         col(z["counts"]), col(z["data"]),
                         all_kmers=limbs(z["all_kmers"]) if "all_kmers" in z else None)


def obs_row_words(w: int) -> int:
    """Words of a packed observation row: W limbs, exts and a label,
    padded to one 16-byte (W <= 2) or 32-byte (W = 3, 4) load."""
    return 4 if w <= 2 else 8


def pack_obs_rows(kmers: torch.Tensor, exts: torch.Tensor, labels=None) -> torch.Tensor:
    """(..., W) int64 limbs in [0, 2^32), (...) exts and optional labels
    (int32, broadcast to (...)) -> (..., :func:`obs_row_words`) int32 rows.

    Word j < W is limb j's 32-bit pattern, word W the exts, word W + 1 the
    label when there is one; the rest is zero.  :func:`row_limbs` inverts
    the limbs."""
    w = kmers.shape[-1]
    rows = torch.empty(kmers.shape[:-1] + (obs_row_words(w),), dtype=torch.int32,
                       device=kmers.device)
    # the low word of each little-endian int64 limb
    rows[..., :w] = kmers.contiguous().view(torch.int32)[..., 0::2]
    rows[..., w] = exts
    pad = w + 1
    if labels is not None:
        rows[..., w + 1] = labels
        pad += 1
    rows[..., pad:] = 0
    return rows


def row_limbs(rows: torch.Tensor, w: int) -> torch.Tensor:
    """The (..., W) int64 limbs of packed observation rows."""
    return rows[..., :w].to(torch.int64) & M32


def _sorted_rows(spec: KmerSpec, bases, lengths, seq_exts, lab, stranded: bool,
                 by_label: bool = False) -> torch.Tensor:
    """The valid observations of a padded read batch as packed rows
    (:func:`pack_obs_rows` with ``lab``), stably sorted by kmer, or by
    (kmer, label as uint32) with ``by_label``."""
    w = spec.w
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts, stranded)
    rows = pack_obs_rows(kmers, exts, lab).reshape(-1, obs_row_words(w))
    del kmers, exts, lab
    # the valid slots in slot order, then stably sorted
    rows = gather_rows(rows, torch.nonzero(valid.reshape(-1)).flatten())
    del valid
    key = row_limbs(rows, w)
    if by_label:
        key = torch.cat([key, row_limbs(rows[:, w + 1 : w + 2], 1)], dim=1)
    perm = S.lex_argsort(key)
    del key
    return gather_rows(rows, perm)


def run_bounds(is_start: torch.Tensor):
    """(starts, ends) of the runs whose first rows ``is_start`` flags."""
    bounds = torch.nonzero(torch.cat([is_start, is_start.new_ones(1)])).flatten()
    return bounds[:-1], bounds[1:]


DATA_REDUCE = ("label_first", "min", "max", "sum", "obs_min", "none")
# what run_reduce_rows makes of a run's labels under each data_reduce: the
# stable sort keeps each run's observations in slot order, so its head holds
# the first label and the least slot index
_LABEL_OP = {"label_first": "first", "min": "min", "max": "max", "sum": "sum",
             "obs_min": "first", "none": "none"}


def count_kmers(
    spec: KmerSpec,
    bases: torch.Tensor,
    lengths: torch.Tensor,
    seq_exts: torch.Tensor,
    labels: torch.Tensor,
    *,
    stranded: bool,
    min_obs: int,
    data_reduce: str = "label_first",
    report_all: bool = True,
) -> KmerTable:
    """The filter_kmers pipeline on one padded read batch.

    data_reduce: 'label_first' keeps the label of each kmer's first
    observation in read order (the stable sort keeps it at the run start);
    'min' / 'max' keep the least / greatest label of its observations;
    'sum' their sum, wrapping in int32; 'obs_min' keeps its first
    observation's slot index over all R * (L - K + 1) slots of the padded
    batch, invalid slots counted (the order
    ``compress_kmer_table_device(first_pos=...)`` contracts chains by);
    'none' leaves ``data`` zero.
    report_all: also return the census of every distinct kmer.
    """
    if data_reduce not in DATA_REDUCE:
        raise ValueError(f"unknown data_reduce {data_reduce!r}")
    w = spec.w
    lab = None
    if data_reduce == "obs_min":
        lk = bases.shape[1] - spec.k + 1
        lab = torch.arange(bases.shape[0] * lk, dtype=torch.int32,
                           device=bases.device).reshape(-1, lk)
    elif data_reduce != "none":
        lab = labels.to(torch.int32)[:, None]
    srows = _sorted_rows(spec, bases, lengths, seq_exts, lab, stranded)
    del lab
    # one row a run, in place over the front of srows ("sum" wraps in int32,
    # as the JAX package's int32 scan does)
    urows = run_reduce_rows(srows, w, label_op=_LABEL_OP[data_reduce])
    ukmers = row_limbs(urows, w)
    counts, or_exts = urows[:, w] >> 8, urows[:, w] & 0xFF
    kept = (ukmers, or_exts, counts, urows[:, w + 1].contiguous())
    del srows, urows
    if min_obs > 1:  # every kmer was observed at least once
        keep = torch.nonzero(counts >= min_obs).flatten()
        kept = [gather_rows(t, keep) for t in kept]
    return KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=kept[0],
        exts=kept[1],
        counts=kept[2],
        data=kept[3],
        all_kmers=ukmers if report_all else None,
    )


def count_kmer_pairs(spec: KmerSpec, bases: torch.Tensor, lengths: torch.Tensor,
                     seq_exts: torch.Tensor, labels: torch.Tensor, *, stranded: bool):
    """The colored count of one padded read batch: one row per distinct
    (kmer, label) pair, sorted by kmer and then by label as a uint32, so
    negative labels sort last (the JAX package's ``count_kmers_blocks`` with
    ``labels``; filter.rs:68-101).  Returns (kmers (n, W) int64, labels,
    exts, counts), each (n,) int32, counts saturating at 65535."""
    w = spec.w
    srows = _sorted_rows(spec, bases, lengths, seq_exts, labels.to(torch.int32)[:, None],
                         stranded, by_label=True)
    urows = run_reduce_rows(srows, w, by_label=True)
    count_kmer_pairs.rows += urows.shape[0]
    return row_limbs(urows, w), urows[:, w + 1].contiguous(), urows[:, w] & 0xFF, urows[:, w] >> 8


count_kmer_pairs.rows = 0  # the (kmer, label) rows made, over every call


def _pair_keys(spec: KmerSpec, bases, lengths, seq_exts, labels, *, stranded: bool):
    """:func:`count_kmer_pairs` in the colored state's form: (n, W + 1)
    int64 keys, the label a uint32 limb below the kmer, with exts and
    counts."""
    km, lab, ex, cn = count_kmer_pairs(spec, bases, lengths, seq_exts, labels, stranded=stranded)
    return torch.cat([km, (lab.to(torch.int64) & M32)[:, None]], dim=1), ex, cn


def _empty_table(spec: KmerSpec, stranded: bool, device, report_all: bool = False) -> KmerTable:
    z = torch.zeros(0, dtype=torch.int32, device=device)
    zk = torch.zeros((0, spec.w), dtype=torch.int64, device=device)
    return KmerTable(spec, stranded, zk, z, z.clone(), z.clone(),
                     all_kmers=zk.clone() if report_all else None)


def pad_reads(
    seqs: Sequence[np.ndarray], min_len: int, pad_to: Optional[int] = None, *,
    items: bool = False, labels=None,
):
    """Stack variable-length base arrays into a padded (R, L) matrix.

    Returns (bases (R, L) uint8, lengths (R,) int32): L is the longest row,
    or ``min_len`` if more, rounded up to ``pad_to``, and every byte past a
    row's length is 0.  With ``items``, ``seqs`` are (bases, seq_exts, label)
    items and the call returns their seq_exts and labels besides, (R,) int32
    each: the items' labels unless ``labels`` is given.

    A list or tuple is padded by one native walk (:mod:`~tpu_debruijn_torch.host_pad`)
    from its first row up to the first it cannot take (bases that are no
    C-contiguous uint8 array, an exts or label that is no Python int); the
    Python loop pads the rows from there, and any other sequence, with the
    same bytes.  ``pad_reads.native_rows`` and ``pad_reads.python_rows``
    count the rows each padded, over every call.
    """
    if not seqs:
        raise ValueError("no sequences")
    r = len(seqs)
    lengths = np.empty(r, np.int32)
    exts = np.empty(r, np.int32) if items else None
    own = np.empty(r, np.int32) if items and labels is None else None
    lib = HP.library() if isinstance(seqs, (list, tuple)) else None
    m = 0 if lib is None else HP.measure(lib, seqs, items, lengths, exts, own)
    if m < r:  # the lengths, exts and labels the walk could not read
        rest = seqs[m:] if m else seqs
        lengths[m:] = [len(s[0] if items else s) for s in rest]
        if items:
            exts[m:] = np.array([s[1] for s in rest], dtype=np.int32)
        if own is not None:
            own[m:] = np.array([s[2] for s in rest], dtype=np.int32)
    l = max(int(lengths.max()), min_len)
    if pad_to:
        l = -(-l // pad_to) * pad_to
    out = np.empty((r, l), dtype=np.uint8)
    done = 0 if lib is None else HP.copy(lib, seqs, items, lengths, out)
    out[done:] = 0
    for i in range(done, r):
        s = seqs[i][0] if items else seqs[i]
        out[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    _PAD_COUNTS.native_rows += done
    _PAD_COUNTS.python_rows += r - done
    if not items:
        return out, lengths
    return out, lengths, exts, own if labels is None else np.asarray(labels, np.int32)


pad_reads.native_rows = 0  # rows the native walk padded, over every call
pad_reads.python_rows = 0  # rows the Python loop padded, over every call
_PAD_COUNTS = pad_reads  # where the counts go, should a caller rebind the module's name


def filter_kmers(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    report_all: bool = False,
    data_reduce: str = "label_first",
    device="cuda",
    stats: Optional[dict] = None,
) -> KmerTable:
    """Host wrapper: list of (bases, seq_exts, label) -> KmerTable on ``device``.

    Mirrors filter_kmers (filter.rs:139) with a CountFilter(min_obs)
    summarizer; counts are carried beside whatever ``data_reduce`` makes
    of the labels.  ``stats``, a dict, receives the seconds of two stages
    (:class:`~tpu_debruijn_torch.stages.Stages`): ``filter.pad_s`` (the
    reads K long picked out and padded, their exts and labels, on the host)
    and ``filter.upload_s`` (the four arrays to ``device``); the count
    itself is the rest of the call.
    """
    spec = KmerSpec(k)
    device = torch.device(device)
    stage = Stages(stats, device)
    with stage("filter.pad"):
        items = [s for s in seqs if len(s[0]) >= k]
        host = _read_batch(spec, items, "cpu") if items else None  # host tensors, no copy
    if host is None:
        return _empty_table(spec, stranded, device, report_all)
    with stage("filter.upload"):
        batch = tuple(t.to(device) for t in host)
    return count_kmers(spec, *batch, stranded=stranded, min_obs=min_obs,
                       data_reduce=data_reduce, report_all=report_all)


def as_tensor(a, dtype, device=None) -> torch.Tensor:
    """A tensor (on its device unless ``device`` is given) or an array-like
    (on the CPU unless given) as a ``dtype`` tensor."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
    return t.to(device=t.device if device is None else device, dtype=dtype)


def _read_batch(spec: KmerSpec, items, device, labels=None):
    """(bases, seq_exts, label) items, none shorter than K, as one padded
    batch on ``device``: (bases, lengths, seq_exts, labels) tensors; the
    items' labels unless ``labels`` is given."""
    batch = pad_reads(items, min_len=spec.k, pad_to=16, items=True, labels=labels)
    return tuple(torch.from_numpy(a).to(device) for a in batch)


# ---------------------------------------------------------------------------
# label sets, eq classes and summarizers: the policy layer
# ---------------------------------------------------------------------------


def filter_kmers_set_arrays(seqs, k: int, *, stranded: bool = False, min_obs: int = 1,
                            device="cuda", stats: Optional[dict] = None):
    """Array-native CountFilterSet (filter.rs:68-101): each kmer's data is
    the set of labels ("colors") it was observed with.

    Returns (KmerTable, pair_label (P,) int32, split (n + 1,) int64), all
    on ``device``: row i's labels, sorted as uint32 and distinct, are
    ``pair_label[split[i]:split[i + 1]]``; ``min_obs`` applies to each
    kmer's total count.  One :func:`count_kmer_pairs` batch rolled up per
    kmer, as the colored device merge of :func:`filter_kmers_streaming`
    does.  ``stats``, a dict, receives the seconds of four stages
    (:class:`~tpu_debruijn_torch.stages.Stages`): ``filter.pad_s`` and
    ``filter.upload_s`` as :func:`filter_kmers` has them,
    ``filter.pairs_s`` (:func:`count_kmer_pairs`) and
    ``filter.pair_table_s`` (the roll-up per kmer and ``min_obs``)."""
    spec = KmerSpec(k)
    device = torch.device(device)
    stage = Stages(stats, device)
    with stage("filter.pad"):
        items = [s for s in seqs if len(s[0]) >= k]
        host = _read_batch(spec, items, "cpu") if items else None  # host tensors, no copy
    if host is None:
        return (_empty_table(spec, stranded, device), torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int64, device=device))
    with stage("filter.upload"):
        batch = tuple(t.to(device) for t in host)
    with stage("filter.pairs"):
        keys, exts, counts = _pair_keys(spec, *batch, stranded=stranded)
    with stage("filter.pair_table"):
        return _pair_table(spec, stranded, min_obs, keys, exts, counts)


def filter_kmers_set(seqs, k: int, *, stranded: bool = False, min_obs: int = 1, device="cuda"):
    """CountFilterSet with Python data: (KmerTable on ``device``, a tuple of
    labels per table row), from :func:`filter_kmers_set_arrays`."""
    table, pair_label, split = filter_kmers_set_arrays(seqs, k, stranded=stranded,
                                                       min_obs=min_obs, device=device)
    labels, split = pair_label.tolist(), split.tolist()
    return table, [tuple(labels[split[i] : split[i + 1]]) for i in range(len(table))]


DENSE_LIMIT = 1 << 26  # signature-matrix elements above which eq classes hash their runs
_HASH_MULS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F)


def assign_eq_classes(pair_kmer, pair_label, n: int, *, dense_limit: int = DENSE_LIMIT,
                      device="cuda"):
    """Eq-class ids from sorted (kmer slot, label) pairs (the JAX package's
    function), grouped on ``device``.

    ``pair_kmer`` is ascending with each slot's labels sorted, so a slot's
    label set is a contiguous run.  Ids are numbered in first-appearance
    order over slots 0..n-1 (CountFilterEqClass's insertion order); see
    :func:`eq_class_ids` for the two forms of the grouping.

    Returns (ids (n,) int32, eq_classes: the label tuple of each id) as
    numpy and Python values.
    """
    if n == 0:
        return np.zeros(0, np.int32), []
    pk = as_tensor(pair_kmer, torch.int64, device)
    pl = as_tensor(pair_label, torch.int64, device)
    split = torch.searchsorted(pk, torch.arange(n + 1, device=pk.device))
    ids, first, dense = eq_class_ids(pl, split, dense_limit=dense_limit)
    return ids.cpu().numpy(), _class_tuples(pl, split, first, dense)


def eq_class_ids(pair_label: torch.Tensor, split: torch.Tensor, *,
                 dense_limit: int = DENSE_LIMIT):
    """Eq-class ids of the n = len(split) - 1 slots whose label runs are
    ``pair_label[split[i]:split[i + 1]]``, on their device, by one sort.

    Up to ``dense_limit`` elements of an (n, longest run) signature matrix
    (a slot's labels, then -1) the rows themselves are sorted, as the JAX
    package's row unique groups them: a label -1 equals the padding there.
    Above it each run is hashed (:func:`_run_digests`) and the digests are
    sorted.  The sort is stable, so a class's first sorted row is its first
    slot.

    Returns (ids (n,) int32, each class's first slot in id order, whether
    the dense form grouped them), as tensors and a bool.
    """
    dev = pair_label.device
    n = split.shape[0] - 1
    lens = torch.diff(split)
    slot = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    col = torch.arange(pair_label.shape[0], device=dev) - gather_rows(split, slot)
    maxlen = max(int(lens.max()), 1)
    dense = n * maxlen <= dense_limit
    if dense:
        rows = torch.full((n, maxlen), -1, dtype=torch.int64, device=dev)
        rows[slot, col] = pair_label.to(torch.int64)
        rows &= M32  # limbs for the sort; equal as int32 labels iff equal here
    else:
        rows = _run_digests(pair_label.to(torch.int64), slot, col, lens)
    perm = S.lex_argsort(rows)
    starts = S.run_starts(gather_rows(rows, perm))
    first = perm[starts]
    order = torch.argsort(first)
    remap = torch.empty_like(order)
    remap[order] = torch.arange(order.shape[0], device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    ids[perm] = remap[torch.cumsum(starts, 0) - 1].to(torch.int32)
    if dense:
        eq_class_ids.dense_calls += 1
    else:
        eq_class_ids.hashed_calls += 1
    return ids, first[order], dense


eq_class_ids.dense_calls = 0  # calls that grouped the signature rows themselves
eq_class_ids.hashed_calls = 0  # calls that grouped the runs' digests


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def _run_digests(labels, slot, col, lens) -> torch.Tensor:
    """Each slot's label run as the 32-bit limbs of two order-sensitive
    64-bit polynomial digests, then its length: digest j of a run is the sum
    of (label + 1) r_j^col over it, wrapping mod 2^64 (the JAX package's
    hashed form, in int64's two's complement; ``label + 1`` keeps a label 0
    from vanishing).  Runs are sorted and distinct, so equal sets give equal
    digests; a collision is about n^2 / 2^128 likely."""
    n = lens.shape[0]
    terms = labels + 1
    limbs = []
    for r in _HASH_MULS:
        # r^col by squaring
        pw = torch.ones_like(col)
        base, c = r, col.clone()
        while bool((c > 0).any()):
            pw = torch.where((c & 1) == 1, pw * _signed64(base), pw)
            base = base * base % (1 << 64)
            c >>= 1
        h = torch.zeros(n, dtype=torch.int64, device=labels.device).index_add_(0, slot, terms * pw)
        limbs += [(h >> 32) & M32, h & M32]
    return torch.stack(limbs + [lens], dim=1)


def _class_tuples(pair_label: torch.Tensor, split: torch.Tensor, first: torch.Tensor,
                 dense: bool) -> list:
    """The label tuple of each class, read from its first slot's run alone
    (only those labels cross to the host); the dense form leaves out
    negative labels, as the JAX package's padded rows do."""
    lo = gather_rows(split, first)
    ln = gather_rows(split, first + 1) - lo
    ends = torch.cumsum(ln, 0)
    idx = torch.repeat_interleave(lo - (ends - ln), ln) + torch.arange(int(ends[-1]),
                                                                       device=split.device)
    labels = gather_rows(pair_label, idx).tolist()
    bounds = [0] + ends.tolist()
    return [tuple(x for x in labels[a:b] if not dense or x >= 0)
            for a, b in zip(bounds, bounds[1:])]


def filter_kmers_eq_classes(seqs, k: int, *, stranded: bool = False, min_obs: int = 1,
                            device="cuda"):
    """CountFilterEqClass (the Cell Ranger pattern on the reference's
    KmerSummarizer trait, filter.rs:27-38): kmers with the same label set
    share an eq-class id.  Returns (KmerTable on ``device`` whose data is
    the id, eq_classes: the label tuple of each id)."""
    table, pair_label, split = filter_kmers_set_arrays(seqs, k, stranded=stranded,
                                                       min_obs=min_obs, device=device)
    if len(table) == 0:
        return table, []
    table.data, first, dense = eq_class_ids(pair_label, split)
    return table, _class_tuples(pair_label, split, first, dense)


def _sorted_obs(spec: KmerSpec, stranded: bool, bases, lengths, seq_exts, labels):
    """Every valid observation of a padded read batch, canonical and stably
    sorted by kmer (:func:`_sorted_rows`, so each run is in read order), on
    the host: (kmers (m, W) uint32, exts (m,) int32, labels (m,) int32, run
    starts, run ends)."""
    w = spec.w
    srows = _sorted_rows(spec, bases, lengths, seq_exts, labels.to(torch.int32)[:, None],
                         stranded)
    starts, ends = run_bounds(S.run_starts(srows[:, :w]))
    cpu = lambda t: t.cpu().numpy()
    return (KM.to_numpy(row_limbs(srows, w)), cpu(srows[:, w]), cpu(srows[:, w + 1]),
            cpu(starts), cpu(ends))


class KmerSummarizer:
    """The pluggable per-kmer reduction (KmerSummarizer trait,
    filter.rs:27-38).  ``summarize(kmer, exts, payloads)`` receives every
    observation of one kmer: its canonical ``kmer`` limbs (W,) uint32, the
    (m,) int32 ``exts`` and the list of m per-observation data objects, in
    read order; it returns ``(is_valid, folded_exts, summary_data)``."""

    def summarize(self, kmer: np.ndarray, exts: np.ndarray, payloads: list):
        raise NotImplementedError


class CountFilter(KmerSummarizer):
    """count >= min_obs; data = u16-saturated count (filter.rs:40-63)."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs

    def summarize(self, kmer, exts, payloads):
        count = min(len(exts), COUNT_MAX)
        return count >= self.min_obs, int(np.bitwise_or.reduce(exts)), count


class CountFilterSet(KmerSummarizer):
    """data = sorted distinct payload tuple (filter.rs:68-101)."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs

    def summarize(self, kmer, exts, payloads):
        return len(exts) >= self.min_obs, int(np.bitwise_or.reduce(exts)), tuple(sorted(set(payloads)))


class CountFilterEqClass(KmerSummarizer):
    """data = eq-class id of the payload set, numbered in first-appearance
    order; ``self.eq_classes`` maps payload tuple -> id."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs
        self.eq_classes: dict = {}

    def summarize(self, kmer, exts, payloads):
        key = tuple(sorted(set(payloads)))
        eq_id = self.eq_classes.setdefault(key, len(self.eq_classes))
        return len(exts) >= self.min_obs, int(np.bitwise_or.reduce(exts)), eq_id


def filter_kmers_with_summarizer(seqs, k: int, summarizer: KmerSummarizer, *,
                                 stranded: bool = False, report_all: bool = False, device="cuda"):
    """filter_kmers with any summarizer (filter.rs:139): ``seqs`` items are
    ``(bases, seq_exts, payload)`` with any payload object.

    The card extracts, canonicalizes and sorts the observations, each
    carrying its read's index; the host walks the runs of equal kmers and
    calls ``summarizer.summarize`` once a kmer.  Returns (KmerTable on
    ``device``, each kept kmer's summary object); the table's data is the
    summary where it is an int, else 0, and ``report_all`` fills
    ``all_kmers`` with every distinct kmer.
    """
    spec = KmerSpec(k)
    device = torch.device(device)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        return _empty_table(spec, stranded, device), []
    payloads = [s[2] for s in items]
    batch = _read_batch(spec, items, device, labels=np.arange(len(items), dtype=np.int32))
    kmers, exts, labs, starts, ends = _sorted_obs(spec, stranded, *batch)
    out_k, out_e, out_d, out_c = [], [], [], []
    for s, e in zip(starts.tolist(), ends.tolist()):
        ok, fexts, data = summarizer.summarize(kmers[s], exts[s:e], [payloads[j] for j in labs[s:e]])
        if ok:
            out_k.append(s)
            out_e.append(fexts)
            out_d.append(data)
            out_c.append(min(e - s, COUNT_MAX))
    col = lambda a: torch.from_numpy(np.array(a, np.int32)).to(device)
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=KM.to_torch(kmers[out_k].reshape(-1, spec.w), device),
        exts=col(out_e),
        counts=col(out_c),
        data=col([d if isinstance(d, (int, np.integer)) else 0 for d in out_d]),
        all_kmers=KM.to_torch(kmers[starts], device) if report_all else None,
    )
    return table, out_d


# ---------------------------------------------------------------------------
# neighbor searches: censored extensions
# ---------------------------------------------------------------------------


def neighbor_bits(spec: KmerSpec, stranded: bool, kmers: torch.Tensor, *tables) -> list:
    """For every kmer, which of its 8 (direction, base) neighbors are rows of
    each sorted unique table of ``tables``: one (n,) int32 mask a table, bit
    ``b + 4 d`` set iff the neighbor by base b in direction d, canonical
    unless stranded, is a row.  The 8n candidates are canonicalized by one
    canonical launch and found by one search a table."""
    n = kmers.shape[0]
    dev = kmers.device
    cands = torch.cat([(KM.extend_left if d == 0 else KM.extend_right)(spec, kmers, b)
                       for d in (0, 1) for b in range(4)])
    if not stranded:
        cands = _canonicalize(spec, cands, torch.zeros(8 * n, dtype=torch.int32, device=dev))[0]
    shifts = torch.arange(8, dtype=torch.int32, device=dev)[:, None]
    return [(S.searchsorted_limbs(t, cands)[1].reshape(8, n).to(torch.int32) << shifts).sum(0,
            dtype=torch.int32) for t in tables]


def remove_censored_exts_device(spec: KmerSpec, stranded: bool, kmers: torch.Tensor,
                                exts: torch.Tensor, all_kmers=None) -> torch.Tensor:
    """Drop the extensions that point at censored kmers (filter.rs:238-306).

    Without ``all_kmers``: keep only the extensions onto kmers of the table.
    With it (the sharded form): drop an extension only where its target is
    in the census ``all_kmers`` but not in the table."""
    if all_kmers is None:
        (found,) = neighbor_bits(spec, stranded, kmers, kmers)
        return exts & found
    found, census = neighbor_bits(spec, stranded, kmers, kmers, all_kmers)
    return exts & (found | ~census)


def remove_censored_exts(table: KmerTable, device="cuda") -> None:
    """Global censored-ext repair (filter.rs:280-306) on ``device``: keep
    only the extensions onto kmers of the table.  Sets ``table.exts``."""
    _remove_censored(table, None, device)


def remove_censored_exts_sharded(table: KmerTable, device="cuda") -> None:
    """Sharded repair (filter.rs:238-276) on ``device``: drop the extensions
    whose target is in the table's census but not in the table; keep
    targets the census does not know.  The table needs ``all_kmers``
    (``report_all=True``).  Sets ``table.exts``."""
    if table.all_kmers is None:
        raise ValueError("table has no census; build with report_all=True")
    _remove_censored(table, table.all_kmers.to(device), device)


def _remove_censored(table: KmerTable, all_kmers, device) -> None:
    if len(table):
        new = remove_censored_exts_device(table.spec, table.stranded, table.kmers.to(device),
                                          table.exts.to(device), all_kmers)
        table.exts = new.to(table.exts.device)


# ---------------------------------------------------------------------------
# streaming: the corpus path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedReadBlock:
    """A pre-batched read block packed 2 bits a base, for streaming
    ingestion (the JAX package's ``PackedReadBlock``).

    ``packed``: (m, width // 4) uint8 rows, 4 bases a byte, base 4j + i in
    bits 2i and 2i + 1 of byte j (:func:`unpack_2bit`; the native batch
    extractor writes this layout).  ``lengths``: (m,) read lengths.
    ``width``: the row width in bases, a multiple of 16.
    ``seq_exts``/``label``: scalars or (m,) arrays, as in a 2-D block.
    """

    packed: np.ndarray
    lengths: np.ndarray
    width: int
    seq_exts: object = 0
    label: object = 0


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """(R, C) uint8 rows packed 4 bases a byte -> (R, 4C) uint8 codes: one
    elementwise pass on the tensor's device (the JAX package's
    ``_unpack2bit``)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    return ((packed[:, :, None] >> shifts) & 3).reshape(packed.shape[0], -1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def count_bytes_per_read(spec: KmerSpec, read_len: int, colored: bool = False) -> int:
    """Device bytes that one read of ``read_len`` bases holds at the peak
    of :func:`count_kmers` (``colored``: :func:`count_kmer_pairs`, whose sort
    key has the label as one more limb), its sort: per slot the compacted
    packed row, its int64 key limbs, the packed sort keys, the sort's output
    keys, permutation and scratch (one key and one index per pass), and 16
    bytes for the per-run columns of a chunk whose kmers are all distinct;
    plus the read's bases.  An H100 measured up to 75, 82 and 130 bytes a
    slot at W = 1, 2 and 4 against 80, 88 and 144 here (PERF.md §6);
    ``chip_smoke.py`` holds both counts and a streaming run under
    ``memory_gb=1`` to it."""
    width = _round_up(max(_round_up(read_len, 32), spec.k), 16)
    limbs = spec.w + colored
    n_keys = (limbs + 1) // 2
    per_slot = 4 * obs_row_words(spec.w) + 8 * limbs + 8 * n_keys + 16 * (n_keys + 1) + 16
    return (width - spec.k + 1) * per_slot + width


def merge_unique(keys, exts, counts, c_keys, c_exts, c_counts):
    """Fold the sorted unique table (``c_keys``, ``c_exts``, ``c_counts``)
    into the sorted unique table (``keys``, ``exts``, ``counts``): a join,
    not a sort.  Keys are (n, W) int64 limbs in [0, 2^32).  A key appears at
    most once on each side, so a key found on both adds its counts,
    saturating at 65535, and ORs its exts into the table's row (in place);
    a new key's row goes to its lower bound in the table plus the count of
    new rows before it.  Returns the merged (keys, exts, counts).
    ``merge_unique.calls`` and ``merge_unique.rows`` count calls and the
    table rows written anew (n + n_new; none when no key is new), over
    every call."""
    _MERGE_COUNTS.calls += 1
    idx, found = S.searchsorted_limbs(keys, c_keys)
    hit = torch.nonzero(found).flatten()
    if hit.shape[0]:
        at = gather_rows(idx, hit)
        counts[at] = (gather_rows(counts, at) + gather_rows(c_counts, hit)).clamp_(max=COUNT_MAX)
        exts[at] = gather_rows(exts, at) | gather_rows(c_exts, hit)
    new = torch.nonzero(~found).flatten()
    n, n_new = keys.shape[0], new.shape[0]
    if n_new == 0:
        return keys, exts, counts
    _MERGE_COUNTS.rows += n + n_new
    dev = keys.device
    lower = gather_rows(idx, new)  # ascending: the chunk is sorted
    at = lower + torch.arange(n_new, device=dev)
    # table row i moves down by the new rows whose lower bound is <= i
    rows = torch.arange(n, device=dev)
    rest = rows + torch.searchsorted(lower, rows, right=True)
    out = []
    for t, c in ((keys, c_keys), (exts, c_exts), (counts, c_counts)):
        o = t.new_empty((n + n_new,) + t.shape[1:])
        o[at] = gather_rows(c, new)
        o[rest] = t
        out.append(o)
    return tuple(out)


merge_unique.calls = 0  # calls, over every call
merge_unique.rows = 0  # table rows written anew, over every call
_MERGE_COUNTS = merge_unique  # where the counts go, should a caller rebind the module's name


def _merge_sorted_parts(spec: KmerSpec, plist, data_reduce: str):
    """Merge sorted-unique partial kmer tables into one (host side); the
    JAX package's helper of the same name.

    Each part is ``(kmers (n, W) uint32 sorted unique, exts, counts,
    data)``; counts accumulate in int64 (u16 saturation is applied once, at
    the end of streaming).  ``label_first`` keeps the earliest part's label
    (np.lexsort is stable and parts are concatenated in arrival order).
    """
    kmers = np.concatenate([p[0] for p in plist])
    exts = np.concatenate([p[1] for p in plist])
    counts = np.concatenate([p[2] for p in plist]).astype(np.int64)
    data = np.concatenate([p[3] for p in plist])
    cols = tuple(kmers[:, i] for i in range(spec.w - 1, -1, -1))
    order = np.lexsort(cols)
    kmers, exts, counts, data = kmers[order], exts[order], counts[order], data[order]
    new = np.ones(len(kmers), bool)
    if len(kmers) > 1:
        new[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
    starts = np.nonzero(new)[0]
    ucounts = np.add.reduceat(counts, starts)
    uexts = np.bitwise_or.reduceat(exts, starts)
    if data_reduce in ("label_first", "none"):
        udata = data[starts]
    elif data_reduce == "min":
        udata = np.minimum.reduceat(data, starts)
    elif data_reduce == "max":
        udata = np.maximum.reduceat(data, starts)
    elif data_reduce == "sum":
        udata = np.add.reduceat(data, starts)
    else:
        raise ValueError(data_reduce)
    return kmers[starts], uexts, ucounts, udata


def _pair_table(spec: KmerSpec, stranded: bool, min_obs: int, keys, exts, counts):
    """The colored device state, sorted unique (kmer, label) pairs, rolled
    up per kmer: counts summed (saturating at 65535), exts OR'd, ``min_obs``
    on each kmer's total.  Returns (KmerTable, pair_label int32, split
    int64) as the JAX package does."""
    w = spec.w
    kmers = keys[:, :w]
    is_start = S.run_starts(kmers)
    starts, ends = run_bounds(is_start)
    kexts, kcounts = run_reduce(ends, exts, counts)
    kcounts = kcounts.clamp(max=COUNT_MAX).to(torch.int32)
    keep = kcounts >= min_obs
    kept = torch.nonzero(keep).flatten()
    pairs = torch.nonzero(keep[torch.cumsum(is_start, 0) - 1]).flatten()
    lens = gather_rows(ends - starts, kept)
    table = KmerTable(spec, stranded, gather_rows(kmers, gather_rows(starts, kept)),
                      gather_rows(kexts, kept), gather_rows(kcounts, kept),
                      torch.zeros(kept.shape[0], dtype=torch.int32, device=keys.device))
    pair_label = gather_rows(keys[:, w].contiguous(), pairs).to(torch.int32)
    return table, pair_label, torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])


def _per_read(v, lo: int, n: int) -> np.ndarray:
    """A block's scalar or per-read ``seq_exts``/``label``, rows lo..lo + n."""
    if np.ndim(v):
        return np.asarray(v, np.int32)[lo : lo + n]
    return np.full(n, v, np.int32)


def filter_kmers_streaming(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    data_reduce: str = "label_first",
    chunk_reads: int = 4096,
    read_len_cap: Optional[int] = None,
    memory_gb: Optional[float] = None,
    merge: str = "host",
    init_capacity: int = 1 << 20,
    unique_capacity: Optional[int] = None,
    colored: bool = False,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Memory-bounded streaming counting (filter.rs:151-183), the JAX
    package's ``filter_kmers_streaming`` on ``device``.

    The reads are counted in chunks of ``chunk_reads`` by
    :func:`count_kmers` and the chunk tables merged, so device memory is
    O(chunk), plus the table under ``merge="device"``.  Counts accumulate
    before ``min_obs`` applies, so the result equals one-batch
    :func:`filter_kmers`.  ``memory_gb`` with ``read_len_cap`` sizes
    ``chunk_reads`` so that the count stage's peak
    (:func:`count_bytes_per_read`) stays under that bound; the device
    merge's table comes on top of it.

    ``seqs`` is any iterable of per-read (bases, seq_exts, label) tuples
    (reads shorter than K are skipped); of 2-D pre-batched blocks ``(bases
    (m, L) uint8, seq_exts, label [, lengths])``, with scalar or (m,)
    seq_exts and label, which skip the per-read loop; and, under the device
    merge, of :class:`PackedReadBlock` s, uploaded packed and unpacked on
    the card.

    ``merge="host"``: each chunk's table is pulled to the host and
    LSM-merged in numpy (:func:`_merge_sorted_parts`), with every
    ``data_reduce`` that function takes; counts saturate at 65535 at the
    end.  ``merge="device"``: the table stays on ``device``, sorted unique
    kmers with exts and counts, and each chunk's table is joined into it
    (:func:`merge_unique`); counts saturate at every merge, which gives the
    same result.  It takes ``data_reduce='none'`` only.  ``init_capacity``
    and ``unique_capacity`` size the JAX package's static-shape device
    state: they are accepted and have no effect here.

    ``colored=True`` (device merge only) counts (kmer, label) pairs, the
    label a color id, and returns ``(KmerTable, pair_label, split)`` as the
    JAX package does: row i's sorted distinct colors (ordered as uint32)
    are ``pair_label[split[i]:split[i + 1]]``, and ``min_obs`` applies to
    each kmer's total count.

    Each chunk reads its table's size to the host (``torch.nonzero``) a few
    times; nothing else waits for the card.

    ``stats``, a dict, receives the seconds of four stages
    (:class:`~tpu_debruijn_torch.stages.Stages`): ``stream.read_s`` (the
    pull of each item from ``seqs``, one entry an item and one for the
    pull that ends it: for :func:`~tpu_debruijn_torch.io.stream_fastx_blocks`
    the decode of a block), ``stream.count_s`` (a chunk's upload, unpack
    and count), ``stream.merge_s`` (its merge into the table) and
    ``stream.finish_s`` (``min_obs`` or the colored roll-up, once a call);
    under the device merge ``stats["stream.merge_rows"]`` lists the table
    rows each merge wrote anew (:func:`merge_unique`).
    """
    spec = KmerSpec(k)
    device = torch.device(device)
    if memory_gb is not None and read_len_cap is not None:
        chunk_reads = max(256, int(memory_gb * 1e9 / count_bytes_per_read(spec, read_len_cap,
                                                                          colored)))
    if colored and merge != "device":
        raise ValueError("colored=True requires merge='device'")
    if merge == "device" and data_reduce != "none":
        raise ValueError(
            "merge='device' supports data_reduce='none' only (colored=True carries labels "
            "as pair keys; other label reductions need merge='host')"
        )
    # the JAX package's row width: the widest read so far rounded up to 32,
    # then over K to 16 (the slot indices of 'obs_min' count it)
    cap = None if read_len_cap is None else _round_up(read_len_cap, 32)
    stage = Stages(stats, device)
    parts = []
    table = (torch.zeros((0, spec.w + colored), dtype=torch.int64, device=device),
             torch.zeros(0, dtype=torch.int32, device=device),
             torch.zeros(0, dtype=torch.int32, device=device))

    def width_for(need: int) -> int:
        nonlocal cap
        cap = need if cap is None else max(cap, need)
        return _round_up(max(cap, k), 16)

    def count(bases: np.ndarray, lengths, seq_exts, labels, packed: bool = False) -> None:
        """Count one chunk of host rows (``packed``: 2 bits a base) and merge
        its table."""
        nonlocal table
        with stage("stream.count"):
            bases = torch.from_numpy(bases).to(device)
            if packed:
                bases = unpack_2bit(bases)
            lengths, seq_exts, labels = (torch.from_numpy(a).to(device)
                                         for a in (lengths, seq_exts, labels))
            if merge == "device" and colored:
                keys, ex, cn = _pair_keys(spec, bases, lengths, seq_exts, labels, stranded=stranded)
            else:
                t = count_kmers(spec, bases, lengths, seq_exts, labels, stranded=stranded,
                                min_obs=1, data_reduce=data_reduce, report_all=False)
                keys, ex, cn = t.kmers, t.exts, t.counts
        with stage("stream.merge"):
            if merge == "device":
                rows = _MERGE_COUNTS.rows
                table = merge_unique(*table, keys, ex, cn)
                if stats is not None:
                    stats.setdefault("stream.merge_rows", []).append(_MERGE_COUNTS.rows - rows)
                return
            parts.append((KM.to_numpy(keys), ex.cpu().numpy(), cn.cpu().numpy().astype(np.int64),
                          t.data.cpu().numpy()))
            # LSM-style merging keeps host memory O(unique kmers) with a log
            # factor (filter.rs:151-183)
            while len(parts) >= 2 and 2 * len(parts[-1][0]) >= len(parts[-2][0]):
                b = parts.pop()
                a = parts.pop()
                parts.append(_merge_sorted_parts(spec, [a, b], data_reduce))

    def flush(chunk) -> None:
        if not chunk:
            return
        width = width_for(_round_up(max(len(s[0]) for s in chunk), 32))
        arr = np.zeros((len(chunk), width), np.uint8)
        for i, (s, _, _) in enumerate(chunk):
            arr[i, : len(s)] = s
        count(arr, np.array([len(s[0]) for s in chunk], np.int32),
              np.array([s[1] for s in chunk], np.int32), np.array([s[2] for s in chunk], np.int32))

    def flush_block(item) -> None:
        block = np.ascontiguousarray(item[0], dtype=np.uint8)
        m, blen = block.shape
        blens = item[3] if len(item) > 3 else None
        width = width_for(_round_up(blen, 32))
        for lo in range(0, m, chunk_reads):
            sub = block[lo : lo + chunk_reads]
            n = sub.shape[0]
            arr = np.zeros((n, width), np.uint8)
            arr[:, :blen] = sub
            lengths = (np.full(n, blen, np.int32) if blens is None
                       else np.minimum(np.asarray(blens[lo : lo + n], np.int32), width))
            count(arr, lengths, _per_read(item[1], lo, n), _per_read(item[2], lo, n))

    def flush_packed(item: PackedReadBlock) -> None:
        if merge != "device":
            raise ValueError("PackedReadBlock items require merge='device'")
        if item.width % 16:
            raise ValueError("PackedReadBlock width must be a multiple of 16")
        for lo in range(0, item.packed.shape[0], chunk_reads):
            sub = np.ascontiguousarray(item.packed[lo : lo + chunk_reads], np.uint8)
            n = sub.shape[0]
            count(sub, np.asarray(item.lengths[lo : lo + n], np.int32),
                  _per_read(item.seq_exts, lo, n), _per_read(item.label, lo, n), packed=True)

    chunk: list = []
    items = iter(seqs)
    while True:
        with stage("stream.read"):
            item = next(items, None)
        if item is None:
            break
        if isinstance(item, PackedReadBlock) or np.ndim(item[0]) == 2:
            flush(chunk)
            chunk = []
            (flush_packed if isinstance(item, PackedReadBlock) else flush_block)(item)
            continue
        if len(item[0]) < k:
            continue
        chunk.append(item)
        if len(chunk) == chunk_reads:
            flush(chunk)
            chunk = []
    flush(chunk)

    with stage("stream.finish"):
        if merge == "device":
            if colored:
                return _pair_table(spec, stranded, min_obs, *table)
            keep = torch.nonzero(table[2] >= min_obs).flatten()
            kmers, exts, counts = (gather_rows(t, keep) for t in table)
            return KmerTable(spec, stranded, kmers, exts, counts, torch.zeros_like(counts))
        if not parts:
            return _empty_table(spec, stranded, device)
        while len(parts) > 1:
            b = parts.pop()
            a = parts.pop()
            parts.append(_merge_sorted_parts(spec, [a, b], data_reduce))
        kmers, uexts, counts, udata = parts[0]
        ucounts = np.minimum(counts, COUNT_MAX).astype(np.int32)
        keep = ucounts >= min_obs
        col = lambda a: torch.from_numpy(a[keep].astype(np.int32)).to(device)
        return KmerTable(spec, stranded, KM.to_torch(kmers[keep], device), col(uexts),
                         col(ucounts), col(udata))
