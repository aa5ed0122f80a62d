"""What the program produced, in :mod:`portbench.reference_wide`'s terms, and how far apart.

:mod:`portbench.compare` on multi-word codes: a kmer is a row of words, a
side its row with ``d`` appended, a join two sides side by side, the lesser
first.  The program's table arrives as 32-bit limbs, its unitigs as
sequences or a GFA file; every difference is a count of rows that one side
has and the other lacks (:func:`compare.row_diff`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare as CP
from portbench import reference as R
from portbench import reference_wide as RW

_I64 = torch.int64


def limb_rows(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """(n, W) int64 32-bit limbs, most significant first, the kmer's 2k bits
    right-aligned -> (n, words) rows."""
    w = limbs.shape[1]
    bits = [2 * (k - 1 - i) for i in range(k)]  # base i's lowest bit
    bases = [((limbs[:, w - 1 - b // 32].to(_I64) >> (b % 32)) & 3).to(torch.uint8) for b in bits]
    return RW.pack(torch.stack(bases, 1), k)


def node_rows(flat, starts, lengths, k: int):
    """Every kmer of every node: (node, offset, forward rows, reverse
    complement rows), and each node's kmer count."""
    dev = flat.device
    nk = (lengths - k + 1).clamp(min=0)
    node = torch.repeat_interleave(torch.arange(nk.shape[0], device=dev), nk)
    off = torch.arange(node.shape[0], device=dev) - (torch.cumsum(nk, 0) - nk)[node]
    pos = starts[node] + off
    fwd, rc = [], []
    for lo, hi in RW.spans(k):
        f = torch.zeros(node.shape[0], dtype=_I64, device=dev)
        r = torch.zeros_like(f)
        for j in range(lo, hi):
            f = (f << 2) | flat[pos + j].to(_I64)
            r = (r << 2) | (3 - flat[pos + k - 1 - j].to(_I64))
        fwd.append(f)
        rc.append(r)
    return node, off, torch.stack(fwd, 1), torch.stack(rc, 1), nk


def _side(rows: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, d.to(_I64)[:, None]], 1)


def seq_repr(flat, starts, lengths, exts, k: int, device) -> dict:
    """:func:`compare.seq_repr` on rows: the unitig sets of a node store
    (numpy or tensor ``flat`` bases, ``starts``, ``lengths``, (n,) exts
    bytes or None for ends without masks), each node's ``left`` and
    ``right`` side, and the nodes shorter than k."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(device)
    flat, starts, lengths = t(flat, torch.uint8), t(starts, _I64), t(lengths, _I64)
    node, off, fwd, rc, nk = node_rows(flat, starts, lengths, k)
    is_fwd = (~RW.lex_lt(rc, fwd)).to(_I64)
    canon = torch.where(is_fwd[:, None] == 1, fwd, rc)
    del fwd, rc
    # consecutive kmers: the one leaves by its right side read forward, the
    # next is entered by its left side read forward
    nxt = torch.nonzero(off < (nk[node] - 1)).flatten()
    links = RW.min_max(_side(canon[nxt], is_fwd[nxt]), _side(canon[nxt + 1], 1 - is_fwd[nxt + 1]))
    head = torch.nonzero(off == 0).flatten()
    tail = torch.nonzero(off == nk[node] - 1).flatten()
    left = _side(canon[head], 1 - is_fwd[head])
    right = _side(canon[tail], is_fwd[tail])
    ends = torch.cat([left, right])
    if exts is not None:
        e = t(exts, _I64)[node[head]]  # nodes in order: head and tail rows align
        r4 = R.rev4(device)
        lm, rm = e & 15, (e >> 4) & 15
        masks = torch.cat([torch.where(is_fwd[head] == 1, lm, r4[lm]),
                           torch.where(is_fwd[tail] == 1, rm, r4[rm])])
        ends = torch.cat([ends, masks[:, None]], 1)
    return {"kmers": canon, "links": links, "ends": ends, "left": left, "right": right,
            "short": int((nk == 0).sum()), "nodes": int(lengths.shape[0])}


def graph_repr(graph, k: int, device) -> dict:
    """:func:`seq_repr` of a graph object (``base.sequences`` and ``exts``)."""
    seqs = graph.base.sequences
    return seq_repr(seqs._flat(), seqs.start, seqs.length, graph.exts, k, device)


def nodes_repr(nodes, k: int, device) -> dict:
    """:func:`seq_repr` of a list of (bases, exts, data) unitigs."""
    lengths = np.array([len(s) for s, _, _ in nodes], np.int64)
    flat = np.concatenate([np.asarray(s, np.uint8) for s, _, _ in nodes]) if nodes else \
        np.zeros(0, np.uint8)
    return seq_repr(flat, np.cumsum(lengths) - lengths, lengths,
                    np.array([e for _, e, _ in nodes], np.int64), k, device)


def unitig_diff(got: dict, want: dict) -> int:
    """Rows of kmers, joins and ends that one set has and the other lacks,
    plus the nodes too short to hold a kmer (ends without masks compare
    with the reference's ends less their masks)."""
    ends = want["ends"] if got["ends"].shape[1] == want["ends"].shape[1] else want["ends"][:, :-1]
    return (CP.row_diff(got["kmers"], want["kmers"]) + CP.row_diff(got["links"], want["links"])
            + CP.row_diff(got["ends"], ends) + got["short"])


def gfa_diff(path: str, want: dict, want_edges: torch.Tensor, k: int, device) -> int:
    """:func:`compare.gfa_diff` on rows: the GFA's segments against the
    cleaned unitigs and its links against the edges between unitig ends;
    segment ids must run 0, 1, ...; unreadable lines and bases count."""
    (ids, flat, lengths), links, bad = CP.parse_gfa(path)
    got = seq_repr(np.where(flat == 255, 0, flat), np.cumsum(lengths) - lengths, lengths, None, k,
                   device)
    out = unitig_diff(got, want) + bad + int((ids != np.arange(len(ids))).sum())
    n = got["nodes"]
    if links.shape[0] and (links[:, [0, 2]].min() < 0 or links[:, [0, 2]].max() >= n
                           or got["short"]):
        return out + links.shape[0] + want_edges.shape[0]
    lk = torch.as_tensor(links, device=device)
    fr = torch.where(lk[:, 1:2] == 1, got["right"][lk[:, 0]], got["left"][lk[:, 0]])
    to = torch.where(lk[:, 3:4] == 1, got["left"][lk[:, 2]], got["right"][lk[:, 2]])
    return out + CP.row_diff(RW.min_max(fr, to), want_edges)


def table_diff(codes, counts, exts, want: dict) -> dict:
    """A table of rows against the reference's: kmers one side lacks, and
    counts and exts that differ where both have the kmer."""
    kd = CP.row_diff(codes, want["codes"])
    if kd:
        return {"kmers": kd, "counts": 0, "exts": 0}
    order = RW.lex_order(codes)
    counts, exts = counts[order], exts[order]
    return {"kmers": 0, "counts": int((counts.to(_I64) != want["counts"]).sum()),
            "exts": int((exts.to(_I64) != want["exts"]).sum())}
