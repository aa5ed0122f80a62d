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
sort permutation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.kernels.canonical import canonicalize as _canonicalize
from tpu_debruijn_torch.kernels.extract_canonical import extract_canonical, extract_kmers
from tpu_debruijn_torch.kernels.gather import gather_rows
from tpu_debruijn_torch.kmer import M32, KmerSpec

__all__ = [
    "KmerTable",
    "canonicalize",
    "count_kmers",
    "extract_kmers",
    "filter_kmers",
    "obs_row_words",
    "pack_obs_rows",
    "pad_reads",
    "row_limbs",
]

COUNT_MAX = 65535  # counts saturate at u16, as in the reference


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


def _run_or8(vals: torch.Tensor, ends: torch.Tensor):
    """Bitwise OR of 8-bit ``vals`` over each run of a partition of [0, n)
    into runs that end (exclusive) at ``ends``: one cumulative count per
    bit, read at each run's last element and differenced."""
    out = torch.zeros(ends.shape[0], dtype=torch.int32, device=vals.device)
    vals = vals.contiguous()  # a column of the packed rows: read them once
    last = ends - 1
    for b in range(8):
        c = gather_rows(torch.cumsum((vals >> b) & 1, 0, dtype=torch.int32), last)
        out |= (torch.diff(c, prepend=c.new_zeros(1)) > 0).to(torch.int32) << b
    return out


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
    'min' keeps the least label of its observations; 'obs_min' keeps its
    first observation's slot index over all R * (L - K + 1) slots of the
    padded batch, invalid slots counted (the order
    ``compress_kmer_table_device(first_pos=...)`` contracts chains by);
    'none' leaves ``data`` zero.
    report_all: also return the census of every distinct kmer.
    """
    if data_reduce not in ("label_first", "min", "obs_min", "none"):
        raise ValueError(f"data_reduce {data_reduce!r} is not ported")
    w = spec.w
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts, stranded)
    lab = None
    if data_reduce == "obs_min":
        lab = torch.arange(valid.numel(), dtype=torch.int32, device=valid.device).reshape(valid.shape)
    elif data_reduce != "none":
        lab = labels.to(torch.int32)[:, None]
    rows = pack_obs_rows(kmers, exts, lab).reshape(-1, obs_row_words(w))
    del kmers, exts, lab
    # the valid slots in slot order, then stably sorted by kmer
    rows = gather_rows(rows, torch.nonzero(valid.reshape(-1)).flatten())
    del valid
    perm = S.lex_argsort(row_limbs(rows, w))
    srows = gather_rows(rows, perm)
    del rows, perm

    # run boundaries on the limbs' words: equal words, equal limbs
    is_start = S.run_starts(srows[:, :w])
    bounds = torch.nonzero(torch.cat([is_start, is_start.new_ones(1)])).flatten()
    starts, ends = bounds[:-1], bounds[1:]
    counts = (ends - starts).clamp(max=COUNT_MAX).to(torch.int32)
    or_exts = _run_or8(srows[:, w], ends)
    # the stable sort keeps each run's observations in slot order, so the
    # run start holds the first label and the least slot index
    urows = gather_rows(srows, starts)
    ukmers = row_limbs(urows, w)
    if data_reduce == "none":
        data = torch.zeros_like(counts)
    elif data_reduce == "min":
        run = torch.cumsum(is_start, 0) - 1
        data = S.segment_min(srows[:, w + 1], run, starts.shape[0])
    else:
        data = urows[:, w + 1]
    kept = (ukmers, or_exts, counts, data)
    if min_obs > 1:  # every kmer was observed at least once
        keep = torch.nonzero(counts >= min_obs).flatten()
        kept = [gather_rows(t, keep) for t in kept]
    return KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=kept[0],
        exts=kept[1],
        counts=kept[2],
        data=kept[3].contiguous(),
        all_kmers=ukmers if report_all else None,
    )


def pad_reads(
    seqs: Sequence[np.ndarray], min_len: int, pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length base arrays into a padded (R, L) matrix."""
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


def filter_kmers(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    report_all: bool = False,
    data_reduce: str = "label_first",
    device="cuda",
) -> KmerTable:
    """Host wrapper: list of (bases, seq_exts, label) -> KmerTable on ``device``.

    Mirrors filter_kmers (filter.rs:139) with a CountFilter(min_obs)
    summarizer; counts are carried beside whatever ``data_reduce`` makes
    of the labels.
    """
    spec = KmerSpec(k)
    device = torch.device(device)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        z = torch.zeros(0, dtype=torch.int32, device=device)
        zk = torch.zeros((0, spec.w), dtype=torch.int64, device=device)
        return KmerTable(spec, stranded, zk, z, z.clone(), z.clone(),
                         all_kmers=zk.clone() if report_all else None)
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    labels = np.array([s[2] for s in items], dtype=np.int32)
    return count_kmers(
        spec,
        torch.from_numpy(bases).to(device),
        torch.from_numpy(lengths).to(device),
        torch.from_numpy(seq_exts).to(device),
        torch.from_numpy(labels).to(device),
        stranded=stranded,
        min_obs=min_obs,
        data_reduce=data_reduce,
        report_all=report_all,
    )
