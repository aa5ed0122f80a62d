"""What the program produced, in the reference's terms, and how far apart.

The program's unitigs arrive as sequences (a flat base buffer, each node's
start and length) with each node's exts byte, or as a GFA file.
:func:`seq_repr` reads the kmers, the joins between consecutive kmers and
the free ends out of them as :func:`reference.unitig_repr` states them, so
that two unitig sets compare equal exactly when they hold the same unitigs,
whatever the orientation or order of each.  Every difference is a count of
rows that one side has and the other lacks.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as R

_I64 = torch.int64
_ACGT = np.full(256, 255, np.uint8)
_ACGT[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def limb_codes(limbs: torch.Tensor) -> torch.Tensor:
    """(n, W) int64 32-bit limbs, most significant first -> 2k-bit codes."""
    code = limbs[:, 0].to(_I64)
    for j in range(1, limbs.shape[1]):
        code = (code << 32) | limbs[:, j].to(_I64)
    return code


def row_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many rows the multisets ``a`` and ``b`` do not share: the sum over
    distinct rows of the difference of their counts."""
    if a.dim() == 1:
        a, b = a[:, None], b[:, None]
    b = b.to(a.device)
    x = torch.cat([a, b])
    if x.shape[0] == 0:
        return 0
    tag = torch.cat([torch.ones(a.shape[0], dtype=_I64, device=a.device),
                     -torch.ones(b.shape[0], dtype=_I64, device=a.device)])
    _, inv = torch.unique(x, dim=0, return_inverse=True)
    net = torch.zeros(int(inv.max()) + 1, dtype=_I64, device=a.device).index_add_(0, inv, tag)
    return int(net.abs().sum())


def node_kmers(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, k: int):
    """Every kmer of every node: (node, offset, forward code), and each
    node's kmer count."""
    dev = flat.device
    nk = (lengths - k + 1).clamp(min=0)
    node = torch.repeat_interleave(torch.arange(nk.shape[0], device=dev), nk)
    first = torch.cumsum(nk, 0) - nk
    off = torch.arange(node.shape[0], device=dev) - first[node]
    pos = starts[node] + off
    code = torch.zeros(node.shape[0], dtype=_I64, device=dev)
    for j in range(k):
        code = (code << 2) | flat[pos + j].to(_I64)
    return node, off, code, nk


def seq_repr(flat, starts, lengths, exts, k: int, device) -> dict:
    """Unitig sets of a node store, as :func:`reference.unitig_repr`: numpy
    or tensor ``flat`` bases, ``starts``, ``lengths`` and (n,) exts bytes
    (None: ends without masks, as a GFA has them).  Also each node's left
    and right side (``left``, ``right``) and the nodes shorter than k."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(device)
    flat, starts, lengths = t(flat, torch.uint8), t(starts, _I64), t(lengths, _I64)
    node, off, fwd, nk = node_kmers(flat, starts, lengths, k)
    rc = R.rc_codes(fwd, k)
    canon = torch.minimum(fwd, rc)
    is_fwd = (fwd <= rc).to(_I64)
    # consecutive kmers: the one leaves by its right side read forward, the
    # next is entered by its left side read forward
    nxt = torch.nonzero(off < (nk[node] - 1)).flatten()
    a = 2 * canon[nxt] + is_fwd[nxt]
    b = 2 * canon[nxt + 1] + 1 - is_fwd[nxt + 1]
    links = torch.stack([torch.minimum(a, b), torch.maximum(a, b)], 1)
    head = torch.nonzero(off == 0).flatten()
    tail = torch.nonzero(off == nk[node] - 1).flatten()
    left = 2 * canon[head] + 1 - is_fwd[head]
    right = 2 * canon[tail] + is_fwd[tail]
    if exts is None:
        ends = torch.cat([left, right])[:, None]
    else:
        e = t(exts, _I64)[node[head]]  # nodes in order: head and tail rows align
        r4 = R.rev4(device)
        lm, rm = e & 15, (e >> 4) & 15
        ends = torch.stack([torch.cat([left, right]), torch.cat([
            torch.where(is_fwd[head] == 1, lm, r4[lm]), torch.where(is_fwd[tail] == 1, rm, r4[rm])])],
            1)
    short = int((nk == 0).sum())
    return {"kmers": canon, "links": links, "ends": ends, "left": left, "right": right,
            "short": short, "nodes": int(lengths.shape[0])}


def graph_repr(graph, k: int, device) -> dict:
    """:func:`seq_repr` of a graph object (``base.sequences`` and ``exts``)."""
    seqs = graph.base.sequences
    return seq_repr(seqs._flat(), seqs.start, seqs.length, graph.exts, k, device)


def nodes_repr(nodes, k: int, device) -> dict:
    """:func:`seq_repr` of a list of (bases, exts, data) unitigs."""
    lengths = np.array([len(s) for s, _, _ in nodes], np.int64)
    flat = np.concatenate([np.asarray(s, np.uint8) for s, _, _ in nodes]) if nodes else \
        np.zeros(0, np.uint8)
    starts = np.cumsum(lengths) - lengths
    return seq_repr(flat, starts, lengths, np.array([e for _, e, _ in nodes], np.int64), k,
                    device)


def unitig_diff(got: dict, want: dict) -> int:
    """Rows of kmers, joins and ends that one set has and the other lacks,
    plus the nodes too short to hold a kmer."""
    ends = want["ends"] if got["ends"].shape[1] == want["ends"].shape[1] else want["ends"][:, :1]
    return (row_diff(got["kmers"], want["kmers"]) + row_diff(got["links"], want["links"])
            + row_diff(got["ends"], ends) + got["short"])


def parse_gfa(path: str):
    """(S lines as (ids, flat bases, lengths), L lines as (n, 4) int64 rows
    of from node, from '+', to node, to '+'), and the lines it could not
    read."""
    ids, seqs, links, bad = [], [], [], 0
    with open(path, "rb") as f:
        for line in f:
            p = line.rstrip(b"\n").split(b"\t")
            if p[0] == b"S" and len(p) >= 3:
                ids.append(int(p[1]))
                seqs.append(p[2])
            elif p[0] == b"L" and len(p) == 6:
                links.append((int(p[1]), p[2] == b"+", int(p[3]), p[4] == b"+"))
            elif p[0] != b"H":
                bad += 1
    flat = _ACGT[np.frombuffer(b"".join(seqs), np.uint8)]
    bad += int((flat == 255).sum())
    lengths = np.array([len(s) for s in seqs], np.int64)
    return (np.array(ids, np.int64), flat, lengths), np.array(links, np.int64).reshape(-1, 4), bad


def gfa_diff(path: str, want: dict, want_edges: torch.Tensor, k: int, device) -> int:
    """The GFA's segments against the cleaned unitigs (kmers, joins, ends
    without masks) and its links against the edges between unitig ends;
    segment ids must run 0, 1, ...; unreadable lines and bases count."""
    (ids, flat, lengths), links, bad = parse_gfa(path)
    starts = np.cumsum(lengths) - lengths
    got = seq_repr(np.where(flat == 255, 0, flat), starts, lengths, None, k, device)
    out = unitig_diff(got, want) + bad + int((ids != np.arange(len(ids))).sum())
    n = got["nodes"]
    if links.shape[0] and (links[:, [0, 2]].min() < 0 or links[:, [0, 2]].max() >= n
                           or got["short"]):
        return out + links.shape[0] + want_edges.shape[0]
    lk = torch.as_tensor(links, device=device)
    fr = torch.where(lk[:, 1] == 1, got["right"][lk[:, 0]], got["left"][lk[:, 0]])
    to = torch.where(lk[:, 3] == 1, got["left"][lk[:, 2]], got["right"][lk[:, 2]])
    rows = torch.stack([torch.minimum(fr, to), torch.maximum(fr, to)], 1)
    return out + row_diff(rows, want_edges)


def table_diff(codes, counts, exts, want: dict) -> dict:
    """A table against the reference's: kmers one side lacks, and counts
    and exts that differ where both have the kmer."""
    kd = row_diff(codes, want["codes"])
    if kd:
        return {"kmers": kd, "counts": 0, "exts": 0}
    codes, order = torch.sort(codes.to(_I64))
    counts, exts = counts[order], exts[order]
    return {"kmers": 0, "counts": int((counts.to(_I64) != want["counts"]).sum()),
            "exts": int((exts.to(_I64) != want["exts"]).sum())}
