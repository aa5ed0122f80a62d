"""Compressed De Bruijn graph: unitig store, link table, re-compression.

Counterpart of ``tpu_debruijn/graph.py`` (rust-debruijn's graph.rs) for the
quick start, the shard merge and tip cleaning.  ``BaseGraph`` is the unitig
store, with an optional sidecar of per-node payload objects (``rich``);
``DebruijnGraph`` adds the sorted end-kmer indexes, resolves every
candidate link of the graph (graph.rs:223-291) in one batched search on the
device, walks edges (``Node``, ``find_edges``) and repairs extensions
(``fix_exts``).  :func:`compress_graph` merges unbranched nodes
(compression.rs:291-349) with the kmer-level machinery: node partners by
searches on the device, then ``compress.link_chains`` (``rank_lists``).

Not ported yet: walks and exports beyond GFA (``max_path``,
``sequence_of_path``, dot/JSON), save/load, ``Node.sequence`` and
``iter_kmers`` (they wait for ``dna.DnaSeq``).
"""

from __future__ import annotations

import io as _io
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpu_debruijn_torch import bases as B
from tpu_debruijn_torch import compress as C
from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.dna import PackedSeqSet
from tpu_debruijn_torch.kernels.gather import gather_rows
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

    @exts.setter
    def exts(self, value) -> None:
        self._consolidate()
        self._exts = np.asarray(value, np.int32)

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


def sorted_ends(kmers: torch.Tensor):
    """The find_link index of (n, W) end kmers on their device: (sorted
    limbs, node ids), the node ids stably sorted by kmer."""
    ids = S.lex_argsort(kmers)
    return gather_rows(kmers, ids), ids


def _exts_of(mask: torch.Tensor) -> torch.Tensor:
    """(n, 2, 4) bool (node, dir, base) -> (n,) int32 Exts bytes."""
    bits = torch.arange(8, dtype=torch.int32, device=mask.device)
    return (mask.reshape(-1, 8).to(torch.int32) << bits).sum(1, dtype=torch.int32)


def _ext_bits(exts: torch.Tensor) -> torch.Tensor:
    """(n,) Exts bytes -> (n, 2, 4) bool: bit b + 4 d is (dir d, base b)."""
    bits = torch.arange(8, dtype=exts.dtype, device=exts.device).reshape(2, 4)
    return ((exts[:, None, None] >> bits) & 1).bool()


def _fix_exts_device(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids, first_k, last_k,
                     exts, valid=None):
    """Device fix_exts (graph.rs:337-377): keep only the extensions whose
    target kmer is an end kmer of a node, of a ``valid`` one when given;
    invalid nodes get 0.  The node tables are unpadded, so JAX's
    ``n_valid`` bound is gone."""
    if first_k.shape[0] == 0:
        return exts
    t, _, _, found = _link_and_edges(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids,
                                     first_k, last_k)
    keep = _ext_bits(exts) & found
    if valid is None:
        return _exts_of(keep)
    return torch.where(valid, _exts_of(keep & valid[t]), 0)


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
        self._links = None  # where each extension lands: independent of exts
        self._edges = None

    @staticmethod
    def _sort_ids(kmers: np.ndarray) -> np.ndarray:
        if len(kmers) == 0:
            return np.zeros(0, np.int64)
        return np.lexsort(tuple(kmers[:, i] for i in range(kmers.shape[1] - 1, -1, -1)))

    def __len__(self):
        return len(self.base)

    def get_node(self, node_id: int) -> "Node":
        return Node(node_id, self)

    def iter_nodes(self):
        for i in range(len(self)):
            yield Node(i, self)

    def _edge_table(self):
        """(target, in_side, flip, exists) per (node, dir, base), as numpy;
        ``exists`` also requires the node's extension bit.  Where each
        extension lands is searched on the device once; the extension bits
        are applied again whenever ``exts`` changes."""
        if self._edges is None:
            if self._links is None:
                if len(self) == 0:
                    z = np.zeros((0, 2, 4), np.int64)
                    self._links = (z, z, z.astype(bool), z.astype(bool))
                else:
                    dev = self.device
                    ids = lambda a: torch.from_numpy(a).to(dev)
                    links = _link_and_edges(
                        self.spec, self.stranded,
                        KM.to_torch(self._lk_sorted, dev), ids(self._lk_ids),
                        KM.to_torch(self._rk_sorted, dev), ids(self._rk_ids),
                        KM.to_torch(self.first_kmers, dev), KM.to_torch(self.last_kmers, dev),
                    )
                    self._links = tuple(x.cpu().numpy() for x in links)
            t, s, f, found = self._links
            has = ((self.exts[:, None, None] >> np.arange(8).reshape(2, 4)) & 1).astype(bool)
            self._edges = (t, s, f, found & has)
        return self._edges

    def find_edges(self, node_id: int, d: int) -> List[tuple]:
        """The edges leaving ``node_id`` in direction ``d`` (graph.rs:223-241)
        as (target, side entered, flipped); an extension to no node (out of
        the shard) is skipped."""
        t, s, f, ex = self._edge_table()
        return [(int(t[node_id, d, b]), int(s[node_id, d, b]), bool(f[node_id, d, b]))
                for b in range(4) if ex[node_id, d, b]]

    def get_valid_exts(self, node_id: int, valid: Optional[np.ndarray]) -> int:
        """The node's Exts byte keeping only edges onto ``valid`` nodes
        (graph.rs:344-377)."""
        t, _, _, ex = self._edge_table()
        new = 0
        for d in (LEFT, RIGHT):
            for b in range(4):
                if ex[node_id, d, b] and (valid is None or valid[int(t[node_id, d, b])]):
                    new = E.set_ext(new, d, b)
        return new

    def fix_exts(self, valid: Optional[np.ndarray] = None) -> None:
        """Drop the extensions with no target, or no ``valid`` target
        (graph.rs:337-342); sets ``exts`` here and in the base graph."""
        t, _, _, ex = self._edge_table()
        keep = ex if valid is None else ex & np.asarray(valid, bool)[t]
        new = (keep.reshape(-1, 8).astype(np.int32) << np.arange(8, dtype=np.int32)).sum(
            1, dtype=np.int32)
        self.exts = new
        self.base.exts = new
        self._edges = None

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


class Node:
    """View of one node (graph.rs:1009-1093).  ``exts()`` is the Exts byte
    as an int; ``sequence()`` and ``iter_kmers()`` wait for ``dna.DnaSeq``."""

    def __init__(self, node_id: int, graph: DebruijnGraph):
        self.node_id = node_id
        self.graph = graph

    def len(self) -> int:
        return int(self.graph.base.sequences.length[self.node_id])

    def data(self) -> int:
        return int(self.graph.data[self.node_id])

    def exts(self) -> int:
        return int(self.graph.exts[self.node_id])

    def l_edges(self):
        return self.graph.find_edges(self.node_id, LEFT)

    def r_edges(self):
        return self.graph.find_edges(self.node_id, RIGHT)

    def edges(self, d: int):
        return self.graph.find_edges(self.node_id, d)

    def __repr__(self):
        return (f"Node {{ id:{self.node_id}, Exts: {self.exts():#04x}, "
                f"L:{self.l_edges()} R:{self.r_edges()}, Seq: {self.len()} }}")


# ---------------------------------------------------------------------------
# node-level re-compression (compression.rs:100-349)
# ---------------------------------------------------------------------------


def _node_partner_body(spec, stranded, use_join, lk_sorted, lk_ids, rk_sorted, rk_ids,
                       first_k, last_k, exts, node_len, valid, labels):
    """try_extend_node (compression.rs:115-205) as vector masks over the
    nodes, then chain linking: (chains, unitig exts).  ``valid`` masks
    censored nodes; with ``use_join`` only nodes of equal ``labels`` join."""
    n = first_k.shape[0]
    dev = first_k.device
    idx_self = torch.arange(n, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    pal_self = no if stranded else (node_len == spec.k) & KM.is_palindrome(spec, first_k)
    partners, ins = {}, {}
    for d in (LEFT, RIGHT):
        uniq, base = E.unique_extension(exts, d)
        ext = KM.extend_left if d == LEFT else KM.extend_right
        cand = ext(spec, first_k if d == LEFT else last_k, base.to(torch.int64))
        pal_next = no if stranded else KM.is_palindrome(spec, cand)
        j, side, _, found = _find_link_device(spec, stranded, d, cand, lk_sorted, lk_ids,
                                              rk_sorted, rk_ids)
        jc = j.clamp(0, n - 1)
        ok = (valid & uniq & found & valid[jc] & (j != idx_self) & ~pal_self & ~pal_next
              & (E.num_ext_dir(gather_rows(exts, jc), side) == 1))
        if use_join:
            ok &= labels == gather_rows(labels, jc)
        partners[d] = torch.where(ok, j, -1)
        ins[d] = side.to(torch.int64)
    edges = C._enforce_mutual(partners, ins)
    chains = C.link_chains(edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"],
                           valid)
    return chains, C.unitig_end_exts(exts, chains)


def _union_or_first(a, b):
    """compress_graph's default ``rich_reduce``: the sorted set union of two
    int sequences; otherwise the first payload."""
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return tuple(sorted(set(a) | set(b)))
    return a


def compress_graph(graph: DebruijnGraph, censor_nodes: Optional[Sequence[int]] = None, *,
                   data_reduce="sum_sat_u16", join_on_data: bool = False,
                   spec: Optional[C.CompressionSpec] = None,
                   rich_reduce: Optional[Callable] = None, device="cuda") -> DebruijnGraph:
    """Merge adjacent unbranched nodes, after censoring ``censor_nodes``
    (compress_graph, compression.rs:291-349): fix_exts against the valid
    nodes, link the nodes into chains on ``device``, stitch their sequences
    (dropping K - 1 overlaps), rebuild, and fix_exts again.

    The policy comes from ``spec`` (a :class:`~tpu_debruijn_torch.compress.CompressionSpec`)
    or the ``data_reduce``/``join_on_data`` knobs.  A ``rich`` sidecar folds
    by ``rich_reduce`` (associative, commutative, returning a new object);
    by default int sequences merge as sorted set unions and any other
    payload keeps the first.  Sets ``graph``'s exts, as JAX does.
    """
    n = len(graph)
    valid = np.ones(n, bool)
    if censor_nodes is not None:
        valid[np.asarray(list(censor_nodes), int)] = False
    graph.fix_exts(valid)
    k = graph.spec.k
    if n == 0:
        return BaseGraph(k, graph.stranded).finish(device=device)
    labels = graph.data
    if spec is not None:
        data_reduce = spec.reduce
        la = spec.label_array(graph.data)
        join_on_data = la is not None
        if join_on_data:
            labels = la
    dev = torch.device(device)
    col = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
    chains, u_exts = _node_partner_body(
        graph.spec, graph.stranded, join_on_data,
        KM.to_torch(graph._lk_sorted, dev), col(graph._lk_ids, np.int64),
        KM.to_torch(graph._rk_sorted, dev), col(graph._rk_ids, np.int64),
        KM.to_torch(graph.first_kmers, dev), KM.to_torch(graph.last_kmers, dev),
        col(graph.exts, np.int32), col(graph.base.sequences.length, np.int64),
        col(valid, bool), col(labels, np.int32),
    )
    uid, pos, flip = (x.cpu().numpy() for x in (chains.uid, chains.pos, chains.flip))
    nutg = chains.n_unitigs
    live = uid >= 0
    lids = np.nonzero(live)[0]
    uid, pos, flip = uid[live], pos[live], flip[live]
    if callable(data_reduce):
        data_red = C._fold_closure(data_reduce, graph.data[lids], uid, pos, nutg)
    else:
        data_red = C._reduce_np(data_reduce, graph.data[lids], uid, nutg)
    seqs = graph.base.sequences
    seq_flat, out_lengths = C.stitch_flat(k, seqs._flat(), seqs.start, seqs.length, lids, uid,
                                          pos, flip, nutg)
    rich_out = None
    if graph.rich is not None:
        rich_out = C._fold_objects(rich_reduce or _union_or_first, graph.rich, lids, uid, pos, nutg)
    out = BaseGraph(k, graph.stranded)
    out.add_flat(seq_flat, out_lengths, u_exts.cpu().numpy(), data_red, rich=rich_out)
    dbg = out.finish(device=device)
    dbg.fix_exts(None)
    return dbg
