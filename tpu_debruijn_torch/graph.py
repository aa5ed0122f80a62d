"""Compressed De Bruijn graph: unitig store, link table, GFA export.

Counterpart of the slice of ``tpu_debruijn/graph.py`` that the README
quick start runs (rust-debruijn's graph.rs).  ``BaseGraph`` is the unitig
store, with an optional sidecar of per-node payload objects (``rich``);
``DebruijnGraph`` adds the sorted end-kmer indexes, and resolves every
candidate link of the graph (graph.rs:223-291) in one batched search on the
device.
"""

from __future__ import annotations

import io as _io
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_debruijn_torch import bases as B
from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.dna import PackedSeqSet
from tpu_debruijn_torch.kmer import KmerSpec

LEFT, RIGHT = E.LEFT, E.RIGHT


class BaseGraph:
    """SoA unitig store: sequences + per-node Exts + per-node int32 data
    (graph.rs:44-114)."""

    def __init__(self, k: int, stranded: bool):
        self.spec = KmerSpec(k)
        self.stranded = stranded
        self.sequences = PackedSeqSet()
        self._exts = np.zeros(0, np.int32)
        self._data = np.zeros(0, np.int32)
        self._exts_chunks: List[np.ndarray] = []
        self._data_chunks: List[np.ndarray] = []
        # one payload object a node beside the int32 data, once any node
        # has one: BaseGraph<K, D>'s data (graph.rs:44-50)
        self._rich: Optional[List] = None

    @property
    def rich(self) -> Optional[List]:
        """Per-node payload objects, aligned with the nodes, or None."""
        return self._rich

    def _rich_extend(self, n_before: int, rich, n_new: int) -> None:
        """Append ``rich``, a list of ``n_new`` payloads (None: as many
        Nones), once any node has a payload."""
        if rich is None and self._rich is None:
            return
        if self._rich is None:
            self._rich = [None] * n_before
        self._rich.extend([None] * n_new if rich is None else rich)

    def _consolidate(self) -> None:
        if self._exts_chunks:
            self._exts = np.concatenate([self._exts] + self._exts_chunks)
            self._data = np.concatenate([self._data] + self._data_chunks)
            self._exts_chunks = []
            self._data_chunks = []

    @property
    def exts(self) -> np.ndarray:
        self._consolidate()
        return self._exts

    @property
    def data(self) -> np.ndarray:
        self._consolidate()
        return self._data

    def __len__(self):
        return len(self.sequences)

    def add(self, bases, exts: int, data: int = 0, rich=None) -> None:
        n_before = len(self)
        self.sequences.add(np.asarray(bases, np.uint8))
        self._exts_chunks.append(np.array([exts], np.int32))
        self._data_chunks.append(np.array([data], np.int32))
        self._rich_extend(n_before, None if rich is None else [rich], 1)

    def add_flat(self, seq_flat, lengths, exts, data=None, rich=None) -> None:
        """Bulk-append many unitigs: concatenated bases + per-node arrays,
        and optionally a list of per-node payload objects."""
        n_before = len(self)
        lengths = np.asarray(lengths, np.int64)
        if rich is not None and len(rich) != len(lengths):
            raise ValueError("rich sidecar length != node count")
        self.sequences.add_flat(seq_flat, lengths)
        self._exts_chunks.append(np.asarray(exts, np.int32))
        self._data_chunks.append(
            np.zeros(len(lengths), np.int32) if data is None else np.asarray(data, np.int32)
        )
        self._rich_extend(n_before, rich, len(lengths))

    @staticmethod
    def combine(graphs: Sequence["BaseGraph"]) -> "BaseGraph":
        """Concatenate graphs (graph.rs:71-101); mixed strandedness is an
        error."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError("no graphs to combine")
        if len({g.stranded for g in graphs}) != 1:
            raise ValueError("attempted to combine stranded and unstranded graphs")
        out = BaseGraph(graphs[0].spec.k, graphs[0].stranded)
        for g in graphs:
            out.add_flat(g.sequences._flat(), g.sequences.length, g.exts, g.data, rich=g.rich)
        return out

    def finish(self, device="cuda") -> "DebruijnGraph":
        """Build the sorted end-kmer indexes (graph.rs:117-141); links are
        resolved on ``device``."""
        return DebruijnGraph(self, device=device)


def from_compress_output(k: int, stranded: bool, nodes) -> BaseGraph:
    """Wrap compress.compress_kmers output [(bases, exts, data)]; data that
    is not an int (compress_kmers_rich's payloads) goes to the ``rich``
    sidecar, with data 0."""
    g = BaseGraph(k, stranded)
    for seq, exts, data in nodes:
        if isinstance(data, (int, np.integer)):
            g.add(seq, exts, int(data))
        else:
            g.add(seq, exts, 0, rich=data)
    return g


def from_flat_output(k: int, stranded: bool, seq_flat, lengths, exts, data=None) -> BaseGraph:
    """Wrap flat unitig buffers (compress.assemble_unitigs_flat,
    compress.compress_kmers_flat_device): the bulk path."""
    g = BaseGraph(k, stranded)
    g.add_flat(seq_flat, lengths, exts, data)
    return g


def _find_link_device(spec, stranded, d, kmers, lk_sorted, lk_ids, rk_sorted, rk_ids):
    """Batched find_link (graph.rs:252-291): the same-strand probe first,
    then the rc probe in unstranded graphs."""
    if d == LEFT:
        prim_sorted, prim_ids, prim_side = rk_sorted, rk_ids, RIGHT
        sec_sorted, sec_ids, sec_side = lk_sorted, lk_ids, LEFT
    else:
        prim_sorted, prim_ids, prim_side = lk_sorted, lk_ids, LEFT
        sec_sorted, sec_ids, sec_side = rk_sorted, rk_ids, RIGHT
    last = prim_ids.shape[0] - 1
    i1, f1 = S.searchsorted_limbs(prim_sorted, kmers)
    t1 = prim_ids[i1.clamp(0, last)]
    if stranded:
        return t1, torch.full_like(t1, prim_side), torch.zeros_like(f1), f1
    i2, f2 = S.searchsorted_limbs(sec_sorted, KM.rc(spec, kmers))
    t2 = sec_ids[i2.clamp(0, last)]
    target = torch.where(f1, t1, t2)
    side = torch.where(f1, prim_side, sec_side)
    return target, side, (~f1) & f2, f1 | f2


def _link_and_edges(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids, first_k, last_k):
    """All candidate links of the graph in one batch per direction.

    For each node, dir and base: where term_kmer.extend lands
    (graph.rs:223-241).  Returns (target, in_side, flip, found), each
    (N, 2, 4).
    """
    n = first_k.shape[0]
    per_dir = []
    for d in (LEFT, RIGHT):
        term = first_k if d == LEFT else last_k
        ext = KM.extend_left if d == LEFT else KM.extend_right
        cand = torch.cat([ext(spec, term, b) for b in range(4)], dim=0)  # (4N, W)
        res = _find_link_device(spec, stranded, d, cand, lk_sorted, lk_ids, rk_sorted, rk_ids)
        per_dir.append([r.reshape(4, n) for r in res])
    return tuple(
        torch.stack([per_dir[LEFT][i], per_dir[RIGHT][i]]).permute(2, 0, 1)
        for i in range(4)
    )


class DebruijnGraph:
    """Walkable compressed graph: BaseGraph + sorted end-kmer indexes."""

    def __init__(self, base: BaseGraph, device="cuda"):
        self.base = base
        self.spec = base.spec
        self.stranded = base.stranded
        self.device = torch.device(device)
        n = len(base)
        k, w = self.spec.k, self.spec.w
        if n:
            flat = base.sequences._flat()
            starts = np.asarray(base.sequences.start, np.int64)
            lens = np.asarray(base.sequences.length, np.int64)
            ar = np.arange(k)[None, :]
            self.first_kmers = KM.from_bases_batch_np(self.spec, flat[starts[:, None] + ar])
            self.last_kmers = KM.from_bases_batch_np(self.spec, flat[(starts + lens - k)[:, None] + ar])
        else:
            self.first_kmers = np.zeros((0, w), np.uint32)
            self.last_kmers = np.zeros((0, w), np.uint32)
        self.exts = np.asarray(base.exts, np.int32)
        self.data = np.asarray(base.data, np.int32)
        self.rich = base.rich
        order_l = self._sort_ids(self.first_kmers)
        order_r = self._sort_ids(self.last_kmers)
        self._lk_sorted = self.first_kmers[order_l]
        self._lk_ids = order_l
        self._rk_sorted = self.last_kmers[order_r]
        self._rk_ids = order_r
        self._edges = None

    @staticmethod
    def _sort_ids(kmers: np.ndarray) -> np.ndarray:
        if len(kmers) == 0:
            return np.zeros(0, np.int64)
        return np.lexsort(tuple(kmers[:, i] for i in range(kmers.shape[1] - 1, -1, -1)))

    def __len__(self):
        return len(self.base)

    def _edge_table(self):
        """(target, in_side, flip, exists) per (node, dir, base), as numpy;
        ``exists`` also requires the node's extension bit."""
        if self._edges is None:
            if len(self) == 0:
                z = np.zeros((0, 2, 4), np.int64)
                self._edges = (z, z, z.astype(bool), z.astype(bool))
                return self._edges
            dev = self.device
            ids = lambda a: torch.from_numpy(a).to(dev)
            t, s, f, found = _link_and_edges(
                self.spec, self.stranded,
                KM.to_torch(self._lk_sorted, dev), ids(self._lk_ids),
                KM.to_torch(self._rk_sorted, dev), ids(self._rk_ids),
                KM.to_torch(self.first_kmers, dev), KM.to_torch(self.last_kmers, dev),
            )
            t, s, f, found = (x.cpu().numpy() for x in (t, s, f, found))
            has = np.zeros_like(found)
            for d in (LEFT, RIGHT):
                for b in range(4):
                    has[:, d, b] = (self.exts >> (b + 4 * d)) & 1
            self._edges = (t, s, f, found & has)
        return self._edges

    def to_gfa(self, path) -> None:
        """GFA export, byte-identical to the JAX package's."""
        n = len(self)
        flat_ascii = B.bases_to_ascii(self.base.sequences._flat())
        starts = np.asarray(self.base.sequences.start, np.int64)
        lens = np.asarray(self.base.sequences.length, np.int64)
        t, s, f, ex = self._edge_table()
        k1 = str(self.spec.k - 1).encode()
        buf = _io.BytesIO()
        buf.write(b"H\tVN:Z:tpu-debruijn\n")
        mv = memoryview(flat_ascii)
        for i in range(n):
            buf.write(b"S\t%d\t" % i)
            buf.write(mv[starts[i] : starts[i] + lens[i]])
            buf.write(b"\n")
            for b in range(4):
                if ex[i, LEFT, b]:
                    tgt = int(t[i, LEFT, b])
                    if tgt >= i:
                        d = b"+" if s[i, LEFT, b] == LEFT else b"-"
                        buf.write(b"L\t%d\t-\t%d\t%s\t%sM\n" % (i, tgt, d, k1))
            for b in range(4):
                if ex[i, RIGHT, b]:
                    tgt = int(t[i, RIGHT, b])
                    if tgt > i:
                        d = b"+" if s[i, RIGHT, b] == LEFT else b"-"
                        buf.write(b"L\t%d\t+\t%d\t%s\t%sM\n" % (i, tgt, d, k1))
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())
