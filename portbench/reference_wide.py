"""The plain reference at any k: rust-debruijn's workflow on multi-word kmer codes.

:mod:`portbench.reference` holds a kmer's code in one non-negative int64, so
it stops at k = 31.  Here a code is a row of int64 words, each of at most 31
bases (word j holds bases 31 j to 31 j + 30, the first base highest), so
every word is non-negative and rows in lexicographic order are the kmers in
order: ``ceil(k / 31)`` words, 3 at k 63.  A *side* of a kmer is its row
with ``d`` (0 its left, 1 its right) as one more column.

It works out what :func:`reference.assemble` works out, with the same
semantics and the same edge rule: the table after ``min_obs``, the censored
exts, the unitigs, the tips, the cleaned graph and its GFA links.  The steps
on kmer indices (the joins, the walks to the chain ends, the exts kept) are
``reference.py``'s own functions; what touches a code is done here:

- reverse complements from bases: the reads flipped and complemented, as
  :func:`reference.observations` does, and a kmer's bases unpacked and its
  neighbour's packed again;
- every search a sort and a join of rows (:func:`join`), a table slot at a
  time, so that a block is two table-sized sets of rows.

It imports nothing of the program.  Everything runs on the reads' device.
"""

from __future__ import annotations

import torch

from portbench import reference as R

WORD = 31  # bases a word: 62 bits, so a word is a non-negative int64
_I64 = torch.int64


def spans(k: int) -> list:
    """The bases each word holds: [(first, end)], word by word."""
    return [(lo, min(lo + WORD, k)) for lo in range(0, k, WORD)]


def pack(bases: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) 2-bit bases -> (n, words) int64 rows."""
    b = bases.to(_I64)
    out = []
    for lo, hi in spans(k):
        v = torch.zeros(b.shape[0], dtype=_I64, device=b.device)
        for j in range(lo, hi):
            v = (v << 2) | b[:, j]
        out.append(v)
    return torch.stack(out, 1)


def unpack(rows: torch.Tensor, k: int) -> torch.Tensor:
    """(n, words) int64 rows -> (n, k) uint8 bases."""
    cols = [((rows[:, w] >> (2 * (hi - 1 - j))) & 3).to(torch.uint8)
            for w, (lo, hi) in enumerate(spans(k)) for j in range(lo, hi)]
    return torch.stack(cols, 1) if cols else rows.new_zeros((rows.shape[0], 0), dtype=torch.uint8)


def window_rows(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L) 2-bit codes -> (n, L - k + 1, words) rows of every kmer."""
    lk = reads.shape[1] - k + 1
    return torch.stack([R.fwd_codes(reads[:, lo : hi + lk - 1], hi - lo) for lo, hi in spans(k)],
                       -1)


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row a < row b, lexicographically over the last dimension."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for c in range(a.shape[-1] - 1, -1, -1):
        lt = torch.where(a[..., c] != b[..., c], a[..., c] < b[..., c], lt)
    return lt


def min_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows of a and b side by side, the lesser first."""
    swap = lex_lt(b, a)[:, None]
    return torch.cat([torch.where(swap, b, a), torch.where(swap, a, b)], 1)


def lex_order(x: torch.Tensor) -> torch.Tensor:
    """The stable permutation that sorts the rows of ``x`` lexicographically."""
    perm = torch.arange(x.shape[0], device=x.device)
    for c in range(x.shape[1] - 1, -1, -1):
        perm = perm[torch.sort(x[perm, c], stable=True)[1]]
    return perm


def sorted_rows(x: torch.Tensor) -> torch.Tensor:
    return x[lex_order(x)]


def join(table: torch.Tensor, queries: torch.Tensor):
    """(idx, found) of each query row in the sorted unique rows ``table``:
    the two sets sorted together, stably, so that a table row comes before
    the queries equal to it; a query's idx is the last table row at or
    before it (0 where there is none)."""
    n, m = table.shape[0], queries.shape[0]
    dev = queries.device
    if n == 0:
        return (torch.zeros(m, dtype=_I64, device=dev), torch.zeros(m, dtype=torch.bool, device=dev))
    order = lex_order(torch.cat([table, queries]))
    before = torch.cumsum(order < n, 0) - 1  # table rows so far, less one: the last one's index
    at = torch.empty_like(order)
    at[order] = torch.arange(n + m, device=dev)
    idx = before[at[n:]].clamp(min=0)
    return idx, (table[idx] == queries).all(1)


def observations(reads: torch.Tensor, k: int, block: int = 1 << 18):
    """Every kmer of every read, canonical, with its exts: ((m, words)
    rows, (m,) exts), in read order."""
    codes, exts = [], []
    n, l = reads.shape
    lk = l - k + 1
    one = torch.ones((), dtype=_I64, device=reads.device)
    for lo in range(0, n, block):
        r = reads[lo : lo + block]
        fwd = window_rows(r, k)
        rc = window_rows(3 - r.flip(1), k).flip(1)
        rb = r.to(_I64)
        e = torch.zeros(fwd.shape[:2], dtype=_I64, device=reads.device)
        e[:, 1:] |= one << rb[:, : lk - 1]  # the base before each kmer
        e[:, : lk - 1] |= (one << rb[:, k:]) << 4  # the base after it
        flip = lex_lt(rc, fwd)
        codes.append(torch.where(flip[..., None], rc, fwd).reshape(-1, fwd.shape[2]))
        exts.append(torch.where(flip, R.exts_rc(e), e).reshape(-1))
        del fwd, rc, e, flip
    return torch.cat(codes), torch.cat(exts)


def count_table(reads: torch.Tensor, k: int, min_obs: int, exts_reduce: str = "or") -> dict:
    """:func:`reference.count_table` on rows: the sorted canonical rows,
    counts and exts of the kmers seen ``min_obs`` times or more, and the
    number of distinct kmers (``exts_reduce`` "first": the control)."""
    codes, exts = observations(reads, k)
    n_obs = codes.shape[0]
    order = lex_order(codes)
    codes, exts = codes[order], exts[order]
    del order
    head = torch.ones(n_obs, dtype=torch.bool, device=codes.device)
    head[1:] = (codes[1:] != codes[:-1]).any(1)
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
    return {"codes": codes[starts][keep], "counts": counts[keep].clamp(max=R.COUNT_MAX),
            "exts": ored[keep], "distinct": int(starts.shape[0])}


def neighbors(codes: torch.Tensor, k: int):
    """:func:`reference.neighbors` on rows: for each kmer and slot
    ``4 d + b``, the neighbour's index in ``codes`` (sorted), whether it is
    there, and the side of it that the step enters; each (8, n)."""
    n = codes.shape[0]
    bases = unpack(codes, k)
    idx, found, side = [], [], []
    for d in (0, 1):
        for b in range(4):
            new = torch.full((n, 1), b, dtype=torch.uint8, device=codes.device)
            nb = torch.cat([new, bases[:, : k - 1]] if d == 0 else [bases[:, 1:], new], 1)
            raw, rc = pack(nb, k), pack(3 - nb.flip(1), k)
            flip = lex_lt(rc, raw)
            i, f = join(codes, torch.where(flip[:, None], rc, raw))
            idx.append(i)
            found.append(f)
            side.append(torch.where(flip, d, 1 - d))
            del nb, raw, rc
    return torch.stack(idx), torch.stack(found), torch.stack(side)


def side_rows(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Side index ``2 i + d`` -> the row of kmer i with d."""
    return torch.cat([codes[s >> 1], (s & 1)[:, None]], 1)


def unitig_repr(codes, exts, partner, valid) -> dict:
    """:func:`reference.unitig_repr` on rows: ``kmers``, ``links`` (two
    joined sides a row, the lesser first) and ``ends`` (a free side and its
    extension mask)."""
    n = codes.shape[0]
    sides = torch.arange(2 * n, device=codes.device)
    p = partner.reshape(-1)
    live = valid.repeat_interleave(2)
    me, other = side_rows(codes, sides), side_rows(codes, p.clamp(min=0))
    links = torch.cat([me, other], 1)[live & (p >= 0) & lex_lt(me, other)]
    free = live & (p < 0)
    ends = torch.cat([me[free], R.side_mask(exts, sides[free])[:, None]], 1)
    return {"kmers": codes[valid], "links": sorted_rows(links), "ends": sorted_rows(ends)}


def edges(codes, exts, partner, valid, nbr) -> torch.Tensor:
    """:func:`reference.edges` on rows: one row a pair of sides that an
    extension of a free side joins, the lesser first, unique."""
    idx, _, side = nbr
    rows = [torch.zeros((0, 2 * codes.shape[1] + 2), dtype=_I64, device=codes.device)]
    for slot in range(8):
        d = slot // 4
        on = valid & (partner[:, d] < 0) & ((exts >> slot) & 1).bool()
        i = torch.nonzero(on).flatten()
        a = side_rows(codes, 2 * i + d)
        b = side_rows(codes, 2 * idx[slot, i] + side[slot, i])
        rows.append(min_max(a, b))
    return torch.unique(torch.cat(rows), dim=0)


def assemble(reads: torch.Tensor, cfg: dict, censor: bool, exts_reduce: str = "or") -> dict:
    """Everything the comparison holds the program to, from the reads:
    :func:`reference.assemble`'s outputs, with codes as rows."""
    k, min_obs = cfg["k"], cfg["min_obs"]
    if cfg.get("stranded"):
        raise ValueError("the reference covers unstranded kmers")
    table = count_table(reads, k, min_obs, exts_reduce)
    codes, exts = table["codes"], table["exts"]
    n = codes.shape[0]
    nbr = neighbors(codes, k)
    every = torch.ones(n, dtype=torch.bool, device=codes.device)
    censored = R.restrict_exts(exts, nbr, every)
    graph_exts = censored if censor else exts
    partner, one_sided = R.partners(graph_exts, nbr, every)
    unitigs = unitig_repr(codes, graph_exts, partner, every)
    e_right, e_left, nk, cyc = R.chain_ends(partner)
    pc = R.popcount4(codes.device)
    a, b = pc[R.side_mask(graph_exts, e_right)], pc[R.side_mask(graph_exts, e_left)]
    max_kmers = cfg["tip_max_bases"] - k  # len = kmers + k - 1 < tip_max_bases
    tip = (((a == 0) & (b <= 1)) | ((b == 0) & (a <= 1))) & (nk <= max_kmers) & ~cyc
    kept = ~tip
    clean_exts = R.restrict_exts(graph_exts, nbr, kept)
    partner2, one_sided2 = R.partners(clean_exts, nbr, kept)
    cleaned = unitig_repr(codes, clean_exts, partner2, kept)
    return {
        "table": table, "censored_exts": censored, "unitigs": unitigs, "cleaned": cleaned,
        "edges": edges(codes, clean_exts, partner2, kept, nbr),
        "n_unitigs": int((partner < 0).sum()) // 2,
        "n_tip_unitigs": int((partner[tip] < 0).sum()) // 2,
        "n_cleaned": int((partner2[kept] < 0).sum()) // 2,
        "cycle_kmers": int(cyc.sum()), "one_sided_joins": one_sided + one_sided2,
    }
