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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.kernels.canonical import canonicalize as _canonicalize
from tpu_debruijn_torch.kernels.extract_canonical import extract_canonical, extract_kmers
from tpu_debruijn_torch.kmer import KmerSpec

__all__ = [
    "KmerTable",
    "canonicalize",
    "count_kmers",
    "extract_kmers",
    "filter_kmers",
    "pad_reads",
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


def _run_or8(vals: torch.Tensor, starts_idx: torch.Tensor, ends_idx: torch.Tensor):
    """Bitwise OR of 8-bit ``vals`` over each run [start, end): one
    cumulative sum per bit, differenced at the run boundaries."""
    out = torch.zeros(starts_idx.shape[0], dtype=torch.int32, device=vals.device)
    zero = torch.zeros(1, dtype=torch.int32, device=vals.device)
    for b in range(8):
        c = torch.cat([zero, torch.cumsum((vals >> b) & 1, 0, dtype=torch.int32)])
        out |= ((c[ends_idx] - c[starts_idx]) > 0).to(torch.int32) << b
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
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts, stranded)
    vf = valid.reshape(-1)
    kf = kmers.reshape(-1, spec.w)[vf]
    ef = exts.reshape(-1)[vf]
    lab = None
    if data_reduce == "obs_min":
        lab = torch.nonzero(vf).flatten().to(torch.int32)
    elif data_reduce != "none":
        lab = labels.to(torch.int32)[:, None].expand(valid.shape).reshape(-1)[vf]
    del kmers, exts, valid, vf

    perm = S.lex_argsort(kf)
    skmers = kf[perm]
    del kf
    is_start = S.run_starts(skmers)
    starts = torch.nonzero(is_start).flatten()
    n_obs = skmers.shape[0]
    ends = torch.cat([starts[1:], torch.full((1,), n_obs, dtype=starts.dtype, device=starts.device)])
    counts = (ends - starts).clamp(max=COUNT_MAX).to(torch.int32)
    or_exts = _run_or8(ef[perm], starts, ends)
    ukmers = skmers[starts]
    if lab is None:
        data = torch.zeros_like(counts)
    elif data_reduce == "min":
        run = torch.cumsum(is_start, 0) - 1
        data = S.segment_min(lab[perm], run, starts.shape[0])
    else:
        # the stable sort keeps each run's observations in slot order, so
        # the run start holds the first label and the least slot index
        data = lab[perm[starts]]
    keep = counts >= min_obs
    return KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=ukmers[keep],
        exts=or_exts[keep],
        counts=counts[keep],
        data=data[keep],
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
