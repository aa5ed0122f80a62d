"""Compressed De Bruijn graph: unitig store, link table, walks, exports,
checkpoints and re-compression.

Counterpart of ``tpu_debruijn/graph.py`` (rust-debruijn's graph.rs).
``BaseGraph`` is the unitig store, with an optional sidecar of per-node
payload objects (``rich``); ``DebruijnGraph`` adds the find_link index
(its end kmers and their stable sort, built once on its ``device``),
resolves every candidate link of the graph (graph.rs:223-291) in one
batched search over it and keeps the result on the host: edges (``Node``,
``find_edges``), extension repair (``fix_exts``), the ``is_compressed``
check, walks (``max_path``, ``max_path_beam``, ``sequence_of_path``),
exports (GFA, dot, JSON) and ``save``/``load`` all read those numpy arrays,
with no device read a step.  :func:`compress_graph` merges unbranched nodes
(compression.rs:291-349) by the node merge the sharded stitch runs too:
node partners by searches of the index, then ``compress.link_chains``.
"""

from __future__ import annotations

import contextlib
import functools
import io as _io
import json
import pickle
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_debruijn_torch import bases as B
from tpu_debruijn_torch import compress as C
from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.dna import DnaSeq, PackedSeqSet
from tpu_debruijn_torch.exts import Exts
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

    @data.setter
    def data(self, value) -> None:
        self._consolidate()
        self._data = np.asarray(value, np.int32)

    def __len__(self):
        return len(self.sequences)

    def is_empty(self) -> bool:
        return len(self) == 0

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
    """Wrap compress.compress_kmers output [(bases, exts, data)] in one
    ``add_flat``; data that is not an int (compress_kmers_rich's payloads)
    goes to the ``rich`` sidecar, with data 0."""
    seqs, exts, data = tuple(zip(*nodes)) or ((), (), ())
    ints = [isinstance(d, (int, np.integer)) for d in data]
    rich = None if all(ints) else [None if i else d for i, d in zip(ints, data)]
    data = data if rich is None else [d if i else 0 for i, d in zip(ints, data)]
    return _flat_graph(k, stranded, np.concatenate([np.zeros(0, np.uint8), *seqs]),
                       np.fromiter(map(len, seqs), np.int64),
                       np.fromiter(exts, np.int32), np.fromiter(data, np.int32), rich)


def from_flat_output(k: int, stranded: bool, seq_flat, lengths, exts, data=None) -> BaseGraph:
    """Wrap flat unitig buffers (compress.assemble_unitigs_flat,
    compress.compress_kmers_flat_device): the bulk path."""
    return _flat_graph(k, stranded, seq_flat, lengths, exts, data)


def _flat_graph(k: int, stranded: bool, seq_flat, lengths, exts, data=None, rich=None) -> BaseGraph:
    g = BaseGraph(k, stranded)
    g.add_flat(seq_flat, lengths, exts, data, rich=rich)
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


def _store_words(seqs: PackedSeqSet, device) -> torch.Tensor:
    """The store's 2-bit words (first base highest) on ``device``, their
    uint32 bits held as int32: one upload."""
    return torch.from_numpy(seqs.packed_words().view(np.int32)).to(device)


def _end_kmers(spec: KmerSpec, words: torch.Tensor, seqs: PackedSeqSet):
    """Every node's first and last kmer, (n, W) int64 limbs each, read on
    the device of ``words``, the store's words (:func:`_store_words`): limb
    j of a kmer at base s is the 16 bases ending at s + K - 16 (W - 1 - j),
    from two words; zero words pad the stream at both ends."""
    k, w = spec.k, spec.w
    lens, starts = seqs.length, seqs.start
    z = torch.zeros(1, dtype=torch.int64, device=words.device)
    words = torch.cat([z, words.to(torch.int64) & KM.M32, z])
    at = torch.from_numpy(np.concatenate([starts, starts + lens - k])).to(words.device)
    pos = at[:, None] + (k + 16 - 16 * (w - torch.arange(w, device=words.device)))
    q, r2 = (pos >> 4).reshape(-1), 2 * (pos & 15)
    hi = gather_rows(words, q).reshape(pos.shape) << r2
    lo = gather_rows(words, q + 1).reshape(pos.shape) >> (32 - r2)
    limbs = (hi & KM.M32) | lo
    limbs[:, 0] &= int(spec.top_mask)
    return limbs[: len(lens)], limbs[len(lens) :]


def _exts_of(mask: torch.Tensor) -> torch.Tensor:
    """(n, 2, 4) bool (node, dir, base) -> (n,) int32 Exts bytes."""
    bits = torch.arange(8, dtype=torch.int32, device=mask.device)
    return (mask.reshape(-1, 8).to(torch.int32) << bits).sum(1, dtype=torch.int32)


def _ext_bits(exts: torch.Tensor) -> torch.Tensor:
    """(n,) Exts bytes -> (n, 2, 4) bool: bit b + 4 d is (dir d, base b)."""
    bits = torch.arange(8, dtype=exts.dtype, device=exts.device).reshape(2, 4)
    return ((exts[:, None, None] >> bits) & 1).bool()


def _fix_exts(links, exts: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fix_exts (graph.rs:337-377) over :func:`_link_and_edges`' table:
    keep the extensions whose target kmer is an end kmer of a node, of a
    ``valid`` one when given (a node's own validity is not read)."""
    t, _, _, found = links
    keep = _ext_bits(exts) & found
    if valid is not None:
        keep &= valid[t]
    return _exts_of(keep)


class DebruijnGraph:
    """Walkable compressed graph: BaseGraph + the store's 2-bit words on
    ``device`` (``_words``) + the find_link index there: end kmers
    (``_ends``) and :func:`sorted_ends` of each."""

    def __init__(self, base: BaseGraph, device="cuda"):
        self._build(base, torch.device(device), None)

    @classmethod
    def _on_words(cls, base: BaseGraph, device, words: torch.Tensor) -> "DebruijnGraph":
        """The graph of ``base`` whose store's words already lie on
        ``device`` as ``words``: nothing is uploaded again."""
        graph = cls.__new__(cls)
        graph._build(base, torch.device(device), words)
        return graph

    def _build(self, base: BaseGraph, device: torch.device, words: Optional[torch.Tensor]):
        self.base = base
        self.spec = base.spec
        self.stranded = base.stranded
        self.device = device
        self.exts = np.asarray(base.exts, np.int32)
        self.data = np.asarray(base.data, np.int32)
        self.rich = base.rich
        self._words = _store_words(base.sequences, device) if words is None else words
        first_k, last_k = self._ends = _end_kmers(self.spec, self._words, base.sequences)
        self._index = sorted_ends(first_k) + sorted_ends(last_k)
        self._links = None  # where each extension lands: independent of exts
        self._edges = None
        self._lists = None  # the edges as flat host lists, by (node, dir)

    # host copies, made on first read: the end kmers as (n, W) uint32 limbs,
    # and search_kmer's (byte keys, node ids) of each side's sorted index
    first_kmers = functools.cached_property(lambda self: KM.to_numpy(self._ends[0]))
    last_kmers = functools.cached_property(lambda self: KM.to_numpy(self._ends[1]))
    _search_keys = functools.cached_property(lambda self: [
        (self._byte_keys(KM.to_numpy(self._index[i])), self._index[i + 1].cpu().numpy())
        for i in (0, 2)])

    def __len__(self):
        return len(self.base)

    def is_empty(self) -> bool:
        return len(self) == 0

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
            t, s, f, found = self._link_table()
            self._edges = (t, s, f, found & _ext_bits(torch.from_numpy(self.exts)).numpy())
        return self._edges

    def _link_table(self):
        """Where each (node, dir, base) extension lands, whatever the exts:
        (target, in_side, flip, found), searched once over the index."""
        if self._links is None:
            if len(self) == 0:
                z = np.zeros((0, 2, 4), np.int64)
                self._links = (z, z, z.astype(bool), z.astype(bool))
            else:
                links = _link_and_edges(self.spec, self.stranded, *self._index, *self._ends)
                self._links = tuple(x.cpu().numpy() for x in links)
        return self._links

    def _set_exts(self, exts: np.ndarray) -> None:
        """New exts here and in the base graph; the edges follow them."""
        self.exts = exts
        self.base.exts = exts
        self._edges = None
        self._lists = None

    def _edge_lists(self):
        """The edge table as host lists for walks and exports: the edges
        leaving node v in direction d are entries ``off[2 v + d]`` to
        ``off[2 v + d + 1]`` of ``(target, side, flip)``, bases ascending.
        Built in one vectorized pass; rebuilt when ``exts`` changes."""
        if self._lists is None:
            t, s, f, ex = self._edge_table()
            off = np.zeros(2 * len(self) + 1, np.int64)
            np.cumsum(ex.reshape(-1, 4).sum(1), out=off[1:])
            self._lists = (off.tolist(), t[ex].tolist(), s[ex].tolist(), f[ex].tolist())
        return self._lists

    def find_edges(self, node_id: int, d: int) -> List[tuple]:
        """The edges leaving ``node_id`` in direction ``d`` (graph.rs:223-241)
        as (target, side entered, flipped); an extension to no node (out of
        the shard) is skipped."""
        off, t, s, f = self._edge_lists()
        lo, hi = off[2 * node_id + d], off[2 * node_id + d + 1]
        return list(zip(t[lo:hi], s[lo:hi], f[lo:hi]))

    @staticmethod
    def _byte_keys(arr: np.ndarray) -> np.ndarray:
        """(n, w) uint32 limbs -> (n,) fixed-width big-endian byte keys,
        whose order is the limbs' lexicographic order."""
        w = arr.shape[1]
        return np.ascontiguousarray(arr.astype(">u4")).view(f"S{4 * w}").ravel()

    def search_kmer(self, kmer_limbs, side: int) -> Optional[int]:
        """graph.rs:244-249: the node whose ``side`` end kmer is
        ``kmer_limbs`` ((W,) limbs), or None; a host binary search."""
        if len(self) == 0:
            return None
        keys, ids = self._search_keys[0 if side == LEFT else 1]
        # numpy's S dtype strips trailing NULs but compares NUL-padded, so
        # both sides through the same conversion keep limb order
        q = np.asarray(np.asarray(kmer_limbs, np.uint32).astype(">u4").tobytes(), dtype=keys.dtype)
        lo = int(np.searchsorted(keys, q))
        if lo < len(keys) and keys[lo] == q:
            return int(ids[lo])
        return None

    def find_link(self, kmer_limbs, d: int):
        """graph.rs:252-291 for one kmer, on the host: (node, side entered,
        flipped) of the node ``kmer_limbs`` reaches moving in direction
        ``d``, or None."""
        if not self.stranded:
            one = torch.from_numpy(np.asarray(kmer_limbs, np.uint32).astype(np.int64)[None])
            rck = KM.to_numpy(KM.rc(self.spec, one))[0]
        probe, other = (RIGHT, LEFT) if d == LEFT else (LEFT, RIGHT)
        idx = self.search_kmer(kmer_limbs, probe)
        if idx is not None:
            return idx, probe, False
        if not self.stranded:
            idx = self.search_kmer(rck, other)
            if idx is not None:
                return idx, other, True
        return None

    def get_valid_exts(self, node_id: int, valid: Optional[np.ndarray]) -> int:
        """The node's Exts byte keeping only edges onto ``valid`` nodes
        (graph.rs:344-377)."""
        return int(self._fixed_exts(valid, slice(node_id, node_id + 1))[0])

    def _fixed_exts(self, valid, rows=slice(None)) -> np.ndarray:
        """fix_exts of the nodes ``rows``, over the host link table."""
        links = tuple(torch.from_numpy(x[rows]) for x in self._link_table())
        valid = None if valid is None else torch.from_numpy(np.asarray(valid, bool))
        return _fix_exts(links, torch.from_numpy(self.exts[rows]), valid).numpy()

    def fix_exts(self, valid: Optional[np.ndarray] = None) -> None:
        """Drop the extensions with no target, or no ``valid`` target
        (graph.rs:337-342); sets ``exts`` here and in the base graph."""
        self._set_exts(self._fixed_exts(valid))

    # -- checks ----------------------------------------------------------
    def is_compressed(self, join_test: Optional[Callable[[int, int], bool]] = None):
        """graph.rs:296-334: a pair of nodes that could still merge, or
        None.  Vectorized over the edge table, with the palindrome test on
        the device; ``join_test`` runs only on the surviving pairs, in the
        reference's (node, dir) order."""
        n = len(self)
        if n == 0:
            return None
        k = self.spec.k
        t, s, _, ex = self._edge_table()
        deg = ex.sum(axis=2)
        b = np.argmax(ex, axis=2)
        tgt = np.take_along_axis(t, b[:, :, None], axis=2)[:, :, 0]
        rdir = np.take_along_axis(s, b[:, :, None], axis=2)[:, :, 0]
        tgt_c = np.clip(tgt, 0, n - 1)
        next_deg = deg[tgt_c, rdir]
        # K-length palindromic nodes never merge (graph.rs:311-318)
        node_len = np.asarray(self.base.sequences.length, np.int64)
        pal = np.zeros(n, bool)
        if k % 2 == 0 and (node_len == k).any():
            pal_all = KM.is_palindrome(self.spec, self._ends[0])
            pal = (node_len == k) & pal_all.cpu().numpy()
        cand = ((deg == 1) & (next_deg == 1) & ~pal[:, None] & ~pal[tgt_c]
                & (tgt != np.arange(n)[:, None]))
        if not cand.any():
            return None
        if join_test is None:
            i0 = int(np.nonzero(cand.reshape(-1))[0][0])
            return (i0 // 2, int(tgt.reshape(-1)[i0]))
        for i0 in np.nonzero(cand.any(axis=1))[0]:
            for d in (LEFT, RIGHT):
                if cand[i0, d] and join_test(int(self.data[i0]), int(self.data[tgt[i0, d]])):
                    return (int(i0), int(tgt[i0, d]))
        return None

    # -- paths -----------------------------------------------------------
    def sequence_of_path(self, path: Sequence[Tuple[int, int]]) -> DnaSeq:
        """graph.rs:471-491: the sequence of a node path, K - 1 overlaps
        dropped; a node entered on its right side is reverse-complemented."""
        k = self.spec.k
        out = []
        for idx, (node_id, d) in enumerate(path):
            seq = self.base.sequences.get_bases(node_id)
            if d == RIGHT:
                seq = (3 - seq[::-1]).astype(np.uint8)
            out.append(seq if idx == 0 else seq[k - 1 :])
        return DnaSeq.from_bases(np.concatenate(out) if out else np.zeros(0, np.uint8))

    def max_path(self, score: Callable, solid_path: Callable):
        """Greedy bidirectional best-score walk (graph.rs:382-468): from the
        best-scoring node, step to the best-scoring neighbour until a node
        repeats or more than one neighbour is solid."""
        if len(self) == 0:
            return []
        data = self.data.tolist()
        scores = [score(d) for d in data]
        best_node = int(np.argmax(scores))
        osc = lambda st: 0.0 if st is None else scores[st[0]]
        osolid = lambda st: False if st is None else solid_path(data[st[0]])
        used = {best_node}
        path = deque([(best_node, LEFT)])
        for d, do_flip in ((LEFT, False), (RIGHT, True)):
            current = (best_node, d)
            while True:
                nxt = None
                cur_id, incoming = current
                solid = 0
                for tid, tdir, _ in self.find_edges(cur_id, 1 - incoming):
                    cand = (tid, tdir)
                    if osolid(cand):
                        solid += 1
                    if osc(cand) > osc(nxt):
                        nxt = cand
                if solid > 1 or nxt is None or nxt[0] in used:
                    break
                if do_flip:
                    path.appendleft((nxt[0], 1 - nxt[1]))
                else:
                    path.append(nxt)
                used.add(nxt[0])
                current = nxt
        return list(path)

    def max_path_beam(self, beam: int, score: Callable, solid_path: Callable):
        """Beam search from the terminal nodes (graph.rs:712-841); returns
        the best path as [(node, side entered)].

        The JAX package's path and its order: states sorted stably by
        score, scores summed in the same order, and a graph with no
        terminal node seeded with (node 0, LEFT).  A state is one entry of
        a tree of path entries (node, side, parent, depth, jump pointer),
        not a copied list, so an extension costs the same at any path
        length: the cycle test asks whether one of the target's few entries
        is an ancestor of the state, a level-ancestor query over the jump
        pointers in O(log depth), and the path is read out once at the end.
        """
        n = len(self)
        if n == 0:
            return []
        ACTIVE, END, CYCLE = 0, 1, 2
        data = self.data.tolist()
        off, tgt, side, _ = self._edge_lists()
        node, dirn, par, dep, jmp = [], [], [], [], []
        entries = {}  # node id -> its tree entries

        def push(p: int, v: int, d: int) -> int:
            e = len(node)
            if p < 0:
                j, depth = e, 0
            else:
                # Myers' skew-binary jump pointers: O(log depth) level ancestors
                j1 = jmp[p]
                j = jmp[j1] if dep[p] - dep[j1] == dep[j1] - dep[jmp[j1]] else p
                depth = dep[p] + 1
            node.append(v)
            dirn.append(d)
            par.append(p)
            dep.append(depth)
            jmp.append(j)
            entries.setdefault(v, []).append(e)
            return e

        def on_path(x: int, e: int) -> bool:
            """Whether entry ``x`` is entry ``e`` or one of its ancestors."""
            dx = dep[x]
            if dep[e] < dx:
                return False
            while dep[e] > dx:
                e = jmp[e] if dep[jmp[e]] >= dx else par[e]
            return e == x

        states = []
        for i, e in enumerate(self.exts.tolist()):
            nl, nr = E.num_ext_dir(e, LEFT), E.num_ext_dir(e, RIGHT)
            if nl == 0 or nr == 0:
                d = RIGHT if nl > 0 else LEFT
                status = END if (nl == 0 and nr == 0) else ACTIVE
                states.append((push(-1, i, d), float(score(data[i])), status))
        if not states:
            # no terminal node (a fully cyclic graph): the reference seeds
            # the beam with (node 0, Left) too (graph.rs:752-762)
            states.append((push(-1, 0, LEFT), float(score(data[0])), ACTIVE))
        active = True
        while active:
            new_states = []
            active = False
            for st in states:
                e, sc, status = st
                if status != ACTIVE:
                    new_states.append(st)
                    continue
                active = True
                o = 2 * node[e] + 1 - dirn[e]
                for tid, tin in zip(tgt[off[o] : off[o + 1]], side[off[o] : off[o + 1]]):
                    nsc = sc + float(score(data[tid]))
                    if any(on_path(x, e) for x in entries.get(tid, ())):
                        to = CYCLE
                    elif off[2 * tid + 1 - tin] == off[2 * tid + 2 - tin]:
                        to = END
                    else:
                        to = ACTIVE
                    new_states.append((push(e, tid, tin), nsc, to))
            new_states.sort(key=lambda s: -s[1])
            states = new_states[:beam]
        path = []
        e = states[0][0]
        while e >= 0:
            path.append((node[e], dirn[e]))
            e = par[e]
        return path[::-1]

    # -- exports (graph.rs:493-710) --------------------------------------
    def _seq_strings(self) -> List[str]:
        """Every node's sequence as a string, from one pass over the store."""
        flat = B.bases_to_ascii(self.base.sequences._flat()).decode()
        starts = self.base.sequences.start.tolist()
        return [flat[s : s + ln] for s, ln in zip(starts, self.base.sequences.length.tolist())]

    def _write_gfa_text(self, w, tag_func) -> None:
        """GFA text, one S line a node (``tag_func(node)`` appended when
        given) and its L lines, as the JAX package's ``_node_to_gfa``."""
        off, tgt, side, _ = self._edge_lists()
        k1 = self.spec.k - 1
        w.write("H\tVN:Z:tpu-debruijn\n")
        for i, seq in enumerate(self._seq_strings()):
            if tag_func is not None:
                w.write(f"S\t{i}\t{seq}\t{tag_func(self.get_node(i))}\n")
            else:
                w.write(f"S\t{i}\t{seq}\n")
            # a link is written once: from its lower node, a self-link from the left side
            for d, mark, first in ((LEFT, "-", i), (RIGHT, "+", i + 1)):
                for j in range(off[2 * i + d], off[2 * i + d + 1]):
                    if tgt[j] >= first:
                        to_dir = "+" if side[j] == LEFT else "-"
                        w.write(f"L\t{i}\t{mark}\t{tgt[j]}\t{to_dir}\t{k1}M\n")

    def write_gfa(self, w) -> None:
        """GFA text to the writer ``w``; the same bytes as :meth:`to_gfa`."""
        self._write_gfa_text(w, None)

    def to_gfa_with_tags(self, path, tag_func) -> None:
        """GFA with ``tag_func(node)`` appended to each S line."""
        with open(path, "w") as f:
            self._write_gfa_text(f, tag_func)

    def to_gfa(self, path) -> None:
        """GFA export to ``path``, the JAX package's bytes."""
        w = _io.StringIO()
        self._write_gfa_text(w, None)
        with open(path, "wb") as fh:
            fh.write(w.getvalue().encode())

    def to_dot(self, path, node_label: Callable[[int], str]) -> None:
        """Graphviz dot: one node a unitig labelled by ``node_label(data)``,
        blue edges into left sides, red into right sides."""
        off, tgt, side, _ = self._edge_lists()
        lens = self.base.sequences.length.tolist()
        data = self.data.tolist()
        with open(path, "w") as f:
            f.write("digraph {\n")
            for i in range(len(self)):
                f.write(f'n{i} [label="id:{i} len:{lens[i]}  {node_label(data[i])}",style=filled]\n')
                for j in range(off[2 * i], off[2 * i + 1]):
                    color = "blue" if side[j] == LEFT else "red"
                    f.write(f"n{tgt[j]} -> n{i} [color={color}]\n")
                for j in range(off[2 * i + 1], off[2 * i + 2]):
                    color = "blue" if side[j] == LEFT else "red"
                    f.write(f"n{i} -> n{tgt[j]} [color={color}]\n")
            f.write("}\n")

    def to_json_rest(self, fmt_func, writer, rest: Optional[dict] = None) -> None:
        """Nodes (id, length, ``fmt_func(data)``, sequence) and right-side
        links as JSON to ``writer``, with the entries of ``rest`` after."""
        off, tgt, side, _ = self._edge_lists()
        lens = self.base.sequences.length.tolist()
        data = self.data.tolist()
        n = len(self)
        writer.write('{\n"nodes": [\n')
        for i, seq in enumerate(self._seq_strings()):
            writer.write('{"id":"%d","L":%d,"D":%s,"Se":"%s"}'
                         % (i, lens[i], json.dumps(fmt_func(data[i])), seq))
            writer.write("\n" if i == n - 1 else ",\n")
        writer.write('],\n"links": [\n')
        writer.write(",\n".join(
            '{"source":"%d","target":"%d","D":"%s"}' % (i, tgt[j], "L" if side[j] == LEFT else "R")
            for i in range(n) for j in range(off[2 * i + 1], off[2 * i + 2])))
        writer.write("\n]")
        if rest:
            for key, val in rest.items():
                writer.write(',\n"%s": %s\n' % (key, json.dumps(val)))
        else:
            writer.write("\n")
        writer.write("}\n")

    def to_json(self, fmt_func, writer) -> None:
        self.to_json_rest(fmt_func, writer, None)

    def print(self) -> None:
        print(f"DebruijnGraph {{ len: {len(self)}, K: {self.spec.k} }} :")
        for node in self.iter_nodes():
            print(node)

    def print_with_data(self) -> None:
        print(f"DebruijnGraph {{ len: {len(self)}, K: {self.spec.k} }} :")
        for node in self.iter_nodes():
            print(node, f"({int(self.data[node.node_id])})")

    # -- checkpoint (graph.rs:43,175 Serialize) --------------------------
    def save(self, path) -> None:
        """Checkpoint the graph as the JAX package's npz: ``k``,
        ``stranded``, ``lengths``, 2-bit ``bases_packed`` words, int32
        ``exts`` and ``data``.  A ``rich`` sidecar of int sequences is
        stored as ``rich_flat``/``rich_split`` arrays; any other payload is
        pickled into a uint8 ``rich_pickle`` array."""
        extra = {}
        if self.rich is not None:
            def _int_seq(r):
                try:
                    return all(isinstance(x, (int, np.integer)) for x in r)
                except TypeError:
                    return False

            if all(r is None or _int_seq(r) for r in self.rich):
                flats, split = [], np.zeros(len(self) + 1, np.int64)
                for i, r in enumerate(self.rich):
                    flats.append(np.asarray(list(() if r is None else r), np.int64))
                    split[i + 1] = split[i] + len(flats[-1])
                extra["rich_flat"] = np.concatenate(flats) if flats else np.zeros(0, np.int64)
                extra["rich_split"] = split
            else:
                extra["rich_pickle"] = np.frombuffer(pickle.dumps(list(self.rich), protocol=4),
                                                     dtype=np.uint8)
        np.savez_compressed(
            path,
            k=self.spec.k,
            stranded=self.stranded,
            lengths=np.asarray(self.base.sequences.length, np.int64),
            bases_packed=self.base.sequences.packed_words(),
            exts=np.asarray(self.exts, np.int32),
            data=np.asarray(self.data, np.int32),
            **extra,
        )

    @staticmethod
    def load(path, device="cuda") -> "DebruijnGraph":
        """A checkpoint of :meth:`save` or of the JAX package's, links
        resolved on ``device``; also the legacy unpacked ``bases`` form.
        A ``rich_pickle`` sidecar is unpickled: load only files this
        program wrote."""
        z = np.load(path)
        g = BaseGraph(int(z["k"]), bool(z["stranded"]))
        rich = None
        if "rich_pickle" in z:
            rich = pickle.loads(z["rich_pickle"].tobytes())
        elif "rich_flat" in z:
            flat, split = z["rich_flat"].tolist(), z["rich_split"].tolist()
            rich = [tuple(flat[split[i] : split[i + 1]]) for i in range(len(split) - 1)]
        if "bases_packed" in z:
            g.sequences = PackedSeqSet.from_packed(z["bases_packed"], z["lengths"])
            g._exts_chunks.append(np.asarray(z["exts"], np.int32))
            g._data_chunks.append(np.asarray(z["data"], np.int32))
            g._rich = rich
        else:
            g.add_flat(z["bases"], z["lengths"], z["exts"], z["data"], rich=rich)
        return g.finish(device=device)


class Node:
    """View of one node (graph.rs:1009-1093)."""

    def __init__(self, node_id: int, graph: DebruijnGraph):
        self.node_id = node_id
        self.graph = graph

    def len(self) -> int:
        return int(self.graph.base.sequences.length[self.node_id])

    def sequence(self) -> DnaSeq:
        return self.graph.base.sequences.get(self.node_id)

    def data(self) -> int:
        return int(self.graph.data[self.node_id])

    def exts(self) -> Exts:
        return Exts(int(self.graph.exts[self.node_id]))

    def l_edges(self):
        return self.graph.find_edges(self.node_id, LEFT)

    def r_edges(self):
        return self.graph.find_edges(self.node_id, RIGHT)

    def edges(self, d: int):
        return self.graph.find_edges(self.node_id, d)

    def iter_kmers(self):
        return self.sequence().iter_kmers(self.graph.spec.k)

    def __repr__(self):
        return (f"Node {{ id:{self.node_id}, Exts: {self.exts()}, "
                f"L:{self.l_edges()} R:{self.r_edges()}, Seq: {self.len()} }}")


# ---------------------------------------------------------------------------
# node-level re-compression (compression.rs:100-349)
# ---------------------------------------------------------------------------


def _node_partners(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids, first_k, last_k, exts,
                   node_len, valid, labels=None):
    """try_extend_node (compression.rs:115-205) as vector masks over the
    nodes, then chain linking: (chains, unitig exts).  ``valid`` masks
    censored nodes; with ``labels`` only nodes of equal labels join."""
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
        if labels is not None:
            ok &= labels == gather_rows(labels, jc)
        partners[d] = torch.where(ok, j, -1)
        ins[d] = side.to(torch.int64)
    edges = C._enforce_mutual(partners, ins)
    chains = C.link_chains(edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"],
                           valid)
    return chains, C.unitig_end_exts(exts, chains)


def _merge_nodes(spec, stranded, first_k, last_k, index, exts, node_len, valid, labels=None):
    """The node merge on the device (compression.rs:291-349) over nodes'
    end kmers and their ``index`` (:func:`sorted_ends` of each): fix_exts
    against the ``valid`` nodes, node partners (with ``labels``, only equal
    labels join) and ``link_chains``, then the merged nodes' end kmers from
    their chains and their fix_exts (compression.rs:332).  Returns (the
    nodes' fixed exts, chains, the merged nodes' exts)."""
    if first_k.shape[0] == 0:
        return exts, C._empty_chains(first_k.device), exts
    fixed = _fix_exts(_link_and_edges(spec, stranded, *index, first_k, last_k), exts, valid)
    chains, u_exts = _node_partners(spec, stranded, *index, first_k, last_k, fixed, node_len,
                                    valid, labels)
    fi, li = chains.first_item, chains.last_item
    out_fk = torch.where(chains.first_flip.bool()[:, None], KM.rc(spec, gather_rows(last_k, fi)),
                         gather_rows(first_k, fi))
    out_lk = torch.where(chains.last_flip.bool()[:, None], KM.rc(spec, gather_rows(first_k, li)),
                         gather_rows(last_k, li))
    out_index = sorted_ends(out_fk) + sorted_ends(out_lk)
    return fixed, chains, _fix_exts(_link_and_edges(spec, stranded, *out_index, out_fk, out_lk),
                                    u_exts)


def _merged_graph(spec: KmerSpec, stranded: bool, src: torch.Tensor, src_lens: torch.Tensor,
                  data, rich, chains, exts, *, data_reduce, rich_reduce, device,
                  stage=None) -> "DebruijnGraph":
    """The merge's second half: the node sequences ``src`` (on the chains'
    device, as 2-bit words or a byte a base; node i's ``src_lens[i]`` bases
    follow node i - 1's) stitched there by the chains
    (:func:`compress.stitch_device`, K - 1 overlaps dropped), ``data`` and
    ``rich`` folded on the host, then the merged graph with ``exts`` on
    ``device``, its store filled from the stitched words in one copy to the
    host and its index read from them where they lie.  ``stage(name)``,
    where given, wraps the stitch (``"stitch"``) and the build
    (``"finish"``)."""
    stage = stage or (lambda name: contextlib.nullcontext())
    with stage("stitch"):
        nutg = chains.n_unitigs
        live = torch.nonzero(chains.uid >= 0).flatten()
        words, lengths = C.stitch_device(spec.k, src, torch.cumsum(src_lens, 0) - src_lens,
                                         src_lens, live, chains.uid[live], chains.pos[live],
                                         chains.flip[live], nutg)
        lids = live.cpu().numpy()
        uid, pos = chains.uid.cpu().numpy()[lids], chains.pos.cpu().numpy()[lids]
        data = C._fold_host(data_reduce, np.asarray(data)[lids], uid, pos, nutg)
        if rich is not None:
            rich = C._fold_objects(rich_reduce, rich, lids, uid, pos, nutg)
        seqs = PackedSeqSet.from_packed(words.cpu().numpy().view(np.uint32),
                                        lengths.cpu().numpy())
    with stage("finish"):
        out = BaseGraph(spec.k, stranded)
        out.sequences = seqs
        out.exts, out.data = exts.cpu().numpy(), data
        out._rich_extend(0, rich, nutg)
        return DebruijnGraph._on_words(out, device, words.to(device))


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
    nodes, link the nodes into chains on ``device`` and fix_exts the merged
    nodes (:func:`_merge_nodes`), stitch their sequences (dropping K - 1
    overlaps) and rebuild (:func:`_merged_graph`).

    The policy comes from ``spec`` (a :class:`~tpu_debruijn_torch.compress.CompressionSpec`)
    or the ``data_reduce``/``join_on_data`` knobs.  A ``rich`` sidecar folds
    by ``rich_reduce`` (associative, commutative, returning a new object);
    by default int sequences merge as sorted set unions and any other
    payload keeps the first.  Sets ``graph``'s exts, as JAX does.
    """
    valid = np.ones(len(graph), bool)
    if censor_nodes is not None:
        valid[np.asarray(list(censor_nodes), int)] = False
    labels = graph.data if join_on_data else None
    if spec is not None:
        data_reduce = spec.reduce
        labels = spec.label_array(graph.data)
    dev = torch.device(device)
    col = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
    node_len = col(graph.base.sequences.length, np.int64)
    fixed, chains, exts = _merge_nodes(
        graph.spec, graph.stranded, *(x.to(dev) for x in graph._ends),
        tuple(x.to(dev) for x in graph._index), col(graph.exts, np.int32), node_len,
        col(valid, bool), None if labels is None else col(labels, np.int32))
    graph._set_exts(fixed.cpu().numpy())
    return _merged_graph(graph.spec, graph.stranded, graph._words.to(dev), node_len, graph.data,
                         graph.rich, chains, exts, data_reduce=data_reduce,
                         rich_reduce=rich_reduce or _union_or_first, device=device)
