"""The plain reference: rust-debruijn's error-handling workflow in plain PyTorch.

Independent of the program under test: it imports nothing of it and reads
nothing it made.  From the reads alone it works out, for k <= 31 (codes in
non-negative int64) and unstranded kmers (canonical = the lesser of a
kmer's 2k-bit code and its reverse complement's):

- the kmer table after ``min_obs``: each canonical kmer's count (saturating
  at 65535) and exts, the OR of the neighbour bases of its observations
  (filter.rs:139-231);
- the exts after the censor: only those onto kmers of the table
  (filter.rs:280-306);
- the unitigs: maximal paths of kmers joined where one kmer's only
  extension on a side meets a kmer whose only extension on the entered side
  is it (compression.rs:382-541);
- the tips of that graph: unitigs with one side free of extensions and the
  other with at most one, shorter than ``tip_max_bases`` (clean_graph.rs);
- the graph after cleaning them: the unitigs of the kmers left, with exts
  onto those kmers only (compression.rs:291-349);
- its GFA links: one a pair of unitig ends that an extension joins.

Unitigs are compared as three sets that fix them whatever their orientation
or order (:func:`unitig_repr`): the kmers, the joins between consecutive
kmers, and the free ends with their extension masks.  A join or an end is a
*side* of a canonical kmer: ``2 * code + d``, ``d`` 0 for its left and 1 for
its right.  Everything runs on the reads' device, in bulk.
"""

from __future__ import annotations

import torch

COUNT_MAX = 65535
_I64 = torch.int64


def _lut(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=_I64, device=device)


def popcount4(device) -> torch.Tensor:
    return _lut([bin(i).count("1") for i in range(16)], device)


def base_of4(device) -> torch.Tensor:
    """The base of a one-bit mask (0 for any other)."""
    return _lut([{1: 0, 2: 1, 4: 2, 8: 3}.get(i, 0) for i in range(16)], device)


def rev4(device) -> torch.Tensor:
    """A 4-bit base mask complemented: bit b to bit 3 - b."""
    return _lut([sum(((i >> b) & 1) << (3 - b) for b in range(4)) for i in range(16)], device)


def fwd_codes(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L) 2-bit codes -> (n, L - k + 1) int64 codes of every kmer."""
    lk = reads.shape[1] - k + 1
    r = reads.to(_I64)
    v = torch.zeros((reads.shape[0], lk), dtype=_I64, device=reads.device)
    for j in range(k):
        v = (v << 2) | r[:, j : j + lk]
    return v


def rc_codes(v: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complements of 2k-bit kmer codes (k <= 31: non-negative int64)."""
    mask = (1 << (2 * k)) - 1
    x = v ^ mask
    for width, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                     (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF), (32, 0xFFFFFFFF)):
        x = ((x & m) << width) | ((x >> width) & m)
    return (x >> (64 - 2 * k)) & mask


def exts_rc(e: torch.Tensor) -> torch.Tensor:
    """Exts of the reverse complement: sides swapped, bases complemented."""
    r4 = rev4(e.device)
    return (r4[e & 15] << 4) | r4[(e >> 4) & 15]


def observations(reads: torch.Tensor, k: int, block: int = 1 << 18):
    """Every kmer of every read, canonical, with its exts: (codes, exts),
    flat int64, in read order."""
    codes, exts = [], []
    n, l = reads.shape
    lk = l - k + 1
    one = torch.ones((), dtype=_I64, device=reads.device)
    for lo in range(0, n, block):
        r = reads[lo : lo + block]
        fwd = fwd_codes(r, k)
        rc = fwd_codes(3 - r.flip(1), k).flip(1)
        rb = r.to(_I64)
        e = torch.zeros_like(fwd)
        e[:, 1:] |= one << rb[:, : lk - 1]  # the base before each kmer
        e[:, : lk - 1] |= (one << rb[:, k:]) << 4  # the base after it
        flip = rc < fwd
        codes.append(torch.where(flip, rc, fwd).reshape(-1))
        exts.append(torch.where(flip, exts_rc(e), e).reshape(-1))
    return torch.cat(codes), torch.cat(exts)


def count_table(reads: torch.Tensor, k: int, min_obs: int, exts_reduce: str = "or") -> dict:
    """The kmer table: sorted canonical codes, counts and exts of the kmers
    seen ``min_obs`` times or more, and the number of distinct kmers.
    ``exts_reduce`` "first" keeps the exts of each kmer's first observation
    instead of their OR: the control, which breaks the table's guarantee."""
    codes, exts = observations(reads, k)
    n_obs = codes.shape[0]
    codes, order = torch.sort(codes, stable=True)
    exts = exts[order]
    del order
    head = torch.ones(n_obs, dtype=torch.bool, device=codes.device)
    head[1:] = codes[1:] != codes[:-1]
    starts = torch.nonzero(head).flatten()
    counts = torch.diff(starts, append=torch.tensor([n_obs], device=codes.device))
    if exts_reduce == "first":
        ored = exts[starts]
    else:
        run = torch.cumsum(head, 0) - 1
        ored = torch.zeros(starts.shape[0], dtype=_I64, device=codes.device)
        for b in range(8):
            plane = torch.zeros_like(ored).scatter_reduce_(0, run, (exts >> b) & 1, "amax")
            ored |= plane << b
        del run
    keep = counts >= min_obs
    return {"codes": codes[starts][keep], "counts": counts[keep].clamp(max=COUNT_MAX),
            "exts": ored[keep], "distinct": int(starts.shape[0])}


def neighbors(codes: torch.Tensor, k: int):
    """For each kmer and each (side d, base b), slot 4 d + b: the neighbour's
    index in ``codes`` (sorted), whether it is there, and the side of the
    neighbour that the step enters; each (8, n)."""
    mask = (1 << (2 * k)) - 1
    n = codes.shape[0]
    idx, found, side = [], [], []
    for d in (0, 1):
        for b in range(4):
            raw = (codes >> 2) | (b << (2 * (k - 1))) if d == 0 else ((codes << 2) | b) & mask
            rc = rc_codes(raw, k)
            cand = torch.minimum(raw, rc)
            i = torch.searchsorted(codes, cand).clamp(max=max(n - 1, 0))
            idx.append(i)
            found.append(codes[i] == cand if n else torch.zeros_like(cand, dtype=torch.bool))
            side.append(torch.where(rc < raw, d, 1 - d))
    return torch.stack(idx), torch.stack(found), torch.stack(side)


def restrict_exts(exts: torch.Tensor, nbr, keep: torch.Tensor) -> torch.Tensor:
    """``exts`` with only the extensions onto kmers that ``keep`` holds."""
    idx, found, _ = nbr
    out = torch.zeros_like(exts)
    for slot in range(8):
        on = ((exts >> slot) & 1).bool() & found[slot] & keep[idx[slot]]
        out |= on.to(_I64) << slot
    return out


def partners(exts: torch.Tensor, nbr, valid: torch.Tensor):
    """The joins: (n, 2) int64, entry (i, d) the side ``2 j + s`` joined to
    side d of kmer i, or -1; and the number of one-sided joins dropped (0
    for exts from reads)."""
    idx, found, side = nbr
    n = exts.shape[0]
    dev = exts.device
    pc, bo = popcount4(dev), base_of4(dev)
    ar = torch.arange(n, device=dev)
    out = []
    for d in (0, 1):
        nib = (exts >> (4 * d)) & 15
        slot = 4 * d + bo[nib]
        j = idx.gather(0, slot[None]).flatten()
        s = side.gather(0, slot[None]).flatten()
        f = found.gather(0, slot[None]).flatten()
        incoming = pc[(exts[j] >> (4 * s)) & 15]
        ok = (pc[nib] == 1) & f & valid & valid[j] & (j != ar) & (incoming == 1)
        out.append(torch.where(ok, 2 * j + s, -1))
    p = torch.stack(out, dim=1).reshape(-1)
    linked = p >= 0
    back = p[p.clamp(min=0)] == torch.arange(2 * n, device=dev)
    one_sided = int((linked & ~back).sum())
    return torch.where(linked & back, p, -1).reshape(n, 2), one_sided


def chain_ends(partner: torch.Tensor):
    """Pointer doubling along the joins.  State ``2 i + o`` walks kmer i
    forward (o = 0, leaving by its right side) or backward (o = 1); a join
    into side s of kmer j continues as state ``2 j + s``.  Returns for each
    kmer the free side at the end of its walk to the right and to the left
    (as side indices ``2 j + d``), its unitig's kmer count, and whether it
    lies on a cycle."""
    succ = partner.flip(1).reshape(-1)
    m = succ.shape[0]
    jump = torch.where(succ >= 0, succ, torch.arange(m, device=succ.device))
    dist = (succ >= 0).to(_I64)
    for _ in range(64):
        if not bool((succ[jump] >= 0).any()):
            break
        dist, jump = dist + dist[jump], jump[jump]
    cyc = (succ[jump] >= 0).reshape(-1, 2).any(1)
    end = (jump ^ 1).reshape(-1, 2)
    dist = dist.reshape(-1, 2)
    return end[:, 0], end[:, 1], dist[:, 0] + dist[:, 1] + 1, cyc


def side_code(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Side index ``2 i + d`` -> ``2 * code_i + d``."""
    return 2 * codes[s >> 1] + (s & 1)


def side_mask(exts: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (exts[s >> 1] >> (4 * (s & 1))) & 15


def _sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of an (n, c) int64 tensor in lexicographic order."""
    for c in range(x.shape[1] - 1, -1, -1):
        x = x[torch.sort(x[:, c], stable=True)[1]]
    return x


def unitig_repr(codes, exts, partner, valid) -> dict:
    """The unitigs of the ``valid`` kmers as three sets: ``kmers`` (codes),
    ``links`` (rows of two joined sides, the lesser first) and ``ends``
    (rows of a free side and its extension mask)."""
    n = codes.shape[0]
    dev = codes.device
    sides = torch.arange(2 * n, device=dev)
    p = partner.reshape(-1)
    live = valid.repeat_interleave(2)
    me = side_code(codes, sides)
    joined = live & (p >= 0)
    other = side_code(codes, p.clamp(min=0))
    links = torch.stack([me, other], 1)[joined & (me < other)]
    free = live & (p < 0)
    ends = torch.stack([me[free], side_mask(exts, sides[free])], 1)
    return {"kmers": codes[valid], "links": _sorted_rows(links), "ends": _sorted_rows(ends)}


def edges(codes, exts, partner, valid, nbr) -> torch.Tensor:
    """The links between unitig ends: one row a pair of sides that an
    extension of a free side joins, the lesser first, unique."""
    idx, _, side = nbr
    n = codes.shape[0]
    rows = []
    for slot in range(8):
        d = slot // 4
        on = valid & (partner[:, d] < 0) & ((exts >> slot) & 1).bool()
        i = torch.nonzero(on).flatten()
        a = 2 * codes[i] + d
        b = 2 * codes[idx[slot, i]] + side[slot, i]
        rows.append(torch.stack([torch.minimum(a, b), torch.maximum(a, b)], 1))
    rows = torch.cat(rows) if n else torch.zeros((0, 2), dtype=_I64, device=codes.device)
    return torch.unique(rows, dim=0)


def assemble(reads: torch.Tensor, cfg: dict, censor: bool, exts_reduce: str = "or") -> dict:
    """Everything the comparison holds the program to, from the reads."""
    k, min_obs = cfg["k"], cfg["min_obs"]
    if cfg.get("stranded") or k > 31:
        raise ValueError("the reference covers unstranded kmers of k <= 31")
    table = count_table(reads, k, min_obs, exts_reduce)
    codes, exts = table["codes"], table["exts"]
    n = codes.shape[0]
    nbr = neighbors(codes, k)
    every = torch.ones(n, dtype=torch.bool, device=codes.device)
    censored = restrict_exts(exts, nbr, every)
    graph_exts = censored if censor else exts
    partner, one_sided = partners(graph_exts, nbr, every)
    unitigs = unitig_repr(codes, graph_exts, partner, every)
    e_right, e_left, nk, cyc = chain_ends(partner)
    pc = popcount4(codes.device)
    a, b = pc[side_mask(graph_exts, e_right)], pc[side_mask(graph_exts, e_left)]
    max_kmers = cfg["tip_max_bases"] - k  # len = kmers + k - 1 < tip_max_bases
    tip = (((a == 0) & (b <= 1)) | ((b == 0) & (a <= 1))) & (nk <= max_kmers) & ~cyc
    kept = ~tip
    clean_exts = restrict_exts(graph_exts, nbr, kept)
    partner2, one_sided2 = partners(clean_exts, nbr, kept)
    cleaned = unitig_repr(codes, clean_exts, partner2, kept)
    n_unitigs = int((partner < 0).sum()) // 2
    return {
        "table": table, "censored_exts": censored, "unitigs": unitigs, "cleaned": cleaned,
        "edges": edges(codes, clean_exts, partner2, kept, nbr),
        "n_unitigs": n_unitigs, "n_tip_unitigs": int((partner[tip] < 0).sum()) // 2,
        "n_cleaned": int((partner2[kept] < 0).sum()) // 2,
        "cycle_kmers": int(cyc.sum()), "one_sided_joins": one_sided + one_sided2,
    }
