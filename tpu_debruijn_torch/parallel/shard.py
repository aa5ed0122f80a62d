"""MSP-sharded assembly on a logical shard mesh.

Counterpart of ``tpu_debruijn/parallel/shard.py``, the reference's sharded
workflow (test.rs:418-504): msp_sequence per read -> bucket -> a count and
compression per bucket -> BaseGraph::combine -> compress_graph.

1. **Scan** (:func:`_scan_source`): each source block of ceil(R / n) reads
   (JAX's row block per device) is split into MSP intervals; an interval
   goes to shard ``bucket mod n``, taken on the int32 view of the bucket,
   as JAX takes it.
2. **Exchange** (:func:`exchange`, JAX's ``all_to_all``): one stable
   partition of every interval by destination, so a shard's intervals
   arrive in source order and then interval order.  Over several processes
   (a distributed mesh) the intervals first cross by ``all_to_all_single``.
3. **Count and compress** each shard in turn (:func:`_shard_step`): the
   count, with ``min_obs > 1`` the censored-extension repair against the
   shard's own census (cross-shard unknowns survive), and the kmer-level
   compression.
4. **Stitch**: compress_graph's node merge (``graph._merge_nodes``: fix_exts
   against every node, node-level partners and ``link_chains``, and the
   closing fix_exts), over the shards' unitig ends gathered by
   :func:`gather_ends` (JAX's ``all_gather``; :func:`_global_stitch_device`),
   then its second half (``graph._merged_graph``), which stitches the shard
   unitigs' bases on the device where :func:`_shard_unitigs` assembled
   them; or, with ``collective=False``, ``graph.compress_graph`` over the
   combined shard graphs, the same merge over their own index.  Over several processes
   every process gathers every shard's ends and unitigs
   (:func:`gather_ends`, :func:`gather_unitigs`, ``all_gather``) and runs
   the stitch itself, so all of them return the same graph.

The JAX package sizes static buffers for ``shard_map``; none of that is
ported: no ``cap_per_dest`` or ``slack`` (accepted and unused), no padded
exchange buffers and no overflow, no padded rows, and per-shard lists in
place of padded per-shard stacks with their ``n_valid``/``n_unitigs``
masks.  With ``data_reduce="obs_min"`` a shard's slot index runs over its
own unpadded (n_intervals, 2k - p) batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_debruijn_torch import compress as C
from tpu_debruijn_torch import filter as F
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import msp as M
from tpu_debruijn_torch.graph import (
    BaseGraph,
    _merge_nodes,
    _merged_graph,
    compress_graph,
    sorted_ends,
)
from tpu_debruijn_torch.kernels.gather import gather_rows
from tpu_debruijn_torch.kmer import KmerSpec
from tpu_debruijn_torch.parallel.mesh import LogicalMesh, make_mesh
from tpu_debruijn_torch.stages import Stages


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The parameters of one sharded run.  ``cap_per_dest`` sizes JAX's
    exchange buffers; it is kept for the signature and unused."""

    k: int
    p: int
    stranded: bool
    min_obs: int
    n_shards: int
    cap_per_dest: Optional[int] = None

    @property
    def spec(self) -> KmerSpec:
        return KmerSpec(self.k)

    @property
    def interval_len(self) -> int:
        return 2 * self.k - self.p  # msp.rs:292 bound


def source_blocks(n_reads: int, n_shards: int) -> List[tuple]:
    """(lo, hi) of each shard's source block: contiguous rows, ceil(R / n)
    a block, as JAX splits a batch padded to a multiple of n."""
    b = -(-n_reads // n_shards)
    return [(s * b, min((s + 1) * b, n_reads)) for s in range(n_shards)]


def _dest(bucket: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard of each bucket: the floor mod of its int32 view, JAX's
    ``bucket % n_shards`` on the int32 lanes it keeps buckets in.  At
    p = 16 a bucket may be 2^31 or more, and the view differs."""
    return torch.where(bucket >= 2**31, bucket - 2**32, bucket) % n_shards


def _scan_source(plan: ShardPlan, bases, lengths, labels, permutation):
    """MSP scan of one source block: (interval bases (n, 2k - p) uint8,
    lengths, exts, labels, destinations)."""
    iv = M.msp_intervals_device(plan.k, plan.p, bases, lengths, permutation,
                                rc=not plan.stranded)
    sub = M.gather_interval_bases(plan.k, plan.p, bases, iv)
    return (sub, iv["length"], iv["exts"], labels[iv["read"].to(torch.int64)],
            _dest(iv["bucket"], plan.n_shards))


def exchange(dest: torch.Tensor, n_shards: int, columns: Sequence[torch.Tensor],
             mesh: Optional[LogicalMesh] = None, stats: Optional[dict] = None) -> list:
    """The exchange (JAX's ``all_to_all``): rows of ``columns`` by
    destination shard, by one stable partition over the batch in read
    order.  Returns one list of columns a shard.

    On a distributed ``mesh`` the rows first cross processes: the (world,)
    row counts by one ``all_to_all_single``, then every column packed into
    one byte row an interval by a second, split by destination process; the
    rows that arrive (in source process order, each in its own read order)
    are partitioned over this process's shards (``mesh.local``).  ``stats``
    then receives ``exchange_bytes``, the bytes sent to other processes."""
    if mesh is not None and mesh.distributed:
        return _exchange_across(dest, columns, mesh, stats)
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n_shards).tolist()
    moved = [torch.split(c[order], counts) for c in columns]
    return [[m[s] for m in moved] for s in range(n_shards)]


def _comm_device(mesh: LogicalMesh) -> torch.device:
    """Where a collective's tensors lie: the host under gloo (which stages a
    card's tensors through the host in any case), else the mesh's device."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.device


def _byte_rows(columns: Sequence[torch.Tensor]) -> torch.Tensor:
    """Columns of n rows each as one (n, bytes a row) uint8 matrix."""
    n = columns[0].shape[0]
    return torch.cat([c.contiguous().view(torch.uint8).reshape(n, _row_bytes(c))
                      for c in columns], 1)


def _row_bytes(c: torch.Tensor) -> int:
    return c.element_size() * math.prod(c.shape[1:])


def _from_byte_rows(rows: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """Inverse of :func:`_byte_rows`: columns of the dtypes and row shapes
    of ``like``."""
    out, at = [], 0
    for c in like:
        w = _row_bytes(c)
        out.append(rows[:, at : at + w].contiguous().view(c.dtype)
                   .reshape(rows.shape[0], *c.shape[1:]))
        at += w
    return out


def _exchange_across(dest, columns, mesh: LogicalMesh, stats) -> list:
    per = len(mesh.local)
    proc = torch.div(dest, per, rounding_mode="floor")
    order = torch.argsort(proc, stable=True)
    rows = _byte_rows([c[order] for c in columns] + [(dest[order] % per).to(torch.int32)])
    comm = _comm_device(mesh)
    send = torch.bincount(proc, minlength=mesh.world).to(comm)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    send_n, recv_n = send.tolist(), recv.tolist()
    got = torch.empty((sum(recv_n), rows.shape[1]), dtype=torch.uint8, device=comm)
    dist.all_to_all_single(got, rows.to(comm), recv_n, send_n)
    if stats is not None:
        stats["exchange_bytes"] = (sum(send_n) - send_n[mesh.rank]) * rows.shape[1]
    *cols, local = _from_byte_rows(got.to(mesh.device), [*columns, dest[:0].to(torch.int32)])
    return exchange(local, per, cols)


def all_gather_bytes(buf: torch.Tensor, mesh: LogicalMesh, stats: Optional[dict] = None) -> list:
    """Every process's 1-D uint8 ``buf``, in rank order, on the collective's
    device: the sizes by one ``all_gather``, then the buffers padded to the
    largest by a second.  ``stats`` receives this process's bytes in
    ``gather_bytes`` (one entry a call)."""
    comm = _comm_device(mesh)
    size = torch.tensor([buf.numel()], dtype=torch.int64, device=comm)
    sizes = [torch.empty_like(size) for _ in range(mesh.world)]
    dist.all_gather(sizes, size)
    sizes = torch.cat(sizes).tolist()
    if stats is not None:
        stats.setdefault("gather_bytes", []).append(buf.numel())
    cap = max(sizes)
    padded = torch.zeros(cap, dtype=torch.uint8, device=comm)
    padded[: buf.numel()] = buf
    if cap:  # every process skips together: each knows every size
        bufs = [torch.empty_like(padded) for _ in range(mesh.world)]
        dist.all_gather(bufs, padded)
    else:
        bufs = [padded] * mesh.world
    return [b[:n] for b, n in zip(bufs, sizes)]


def gather_ends(parts: Sequence[tuple], mesh: Optional[LogicalMesh] = None,
                stats: Optional[dict] = None) -> tuple:
    """The stitch's gather (JAX's ``all_gather``): each shard's unitig end
    columns, concatenated in shard order.  On a distributed ``mesh`` each
    process's shards cross by :func:`all_gather_bytes`, so every process
    holds every shard's ends."""
    local = tuple(torch.cat(cols) for cols in zip(*parts))
    if mesh is None or not mesh.distributed:
        return local
    rows = _byte_rows(local)
    got = [_from_byte_rows(b.to(mesh.device).reshape(-1, rows.shape[1]), local)
           for b in all_gather_bytes(rows.reshape(-1), mesh, stats)]
    return tuple(torch.cat(cols) for cols in zip(*got))


def gather_unitigs(flat: tuple, mesh: LogicalMesh, stats: Optional[dict] = None) -> tuple:
    """Every process's shard unitigs ((bases, lengths, exts, data) numpy,
    host copies of what :func:`_shard_unitigs` gives) on every process, concatenated in
    rank order, so in shard order: one byte buffer a process, its unitig
    count, its (lengths, exts, data) rows and its bases, by
    :func:`all_gather_bytes`."""
    bases, lengths, exts, data = (torch.from_numpy(np.ascontiguousarray(x)) for x in flat)
    like = [lengths, exts, data]
    buf = torch.cat([torch.tensor([len(lengths)], dtype=torch.int64).view(torch.uint8),
                     _byte_rows(like).reshape(-1), bases])
    width = sum(_row_bytes(c) for c in like)
    out = [[] for _ in range(4)]
    for b in all_gather_bytes(buf, mesh, stats):
        b = b.cpu()
        n = int(b[:8].view(torch.int64))
        cols = _from_byte_rows(b[8 : 8 + n * width].reshape(n, width), like)
        for lst, x in zip(out, [b[8 + n * width :], *cols]):
            lst.append(x.numpy())
    return tuple(np.concatenate(x) for x in out)


def dest_histogram(k: int, p: int, n_shards: int, bases, lengths, *, stranded: bool = False,
                   permutation=None, device="cuda") -> np.ndarray:
    """(n_shards, n_shards) interval counts of a padded read batch by source
    block (row) and destination shard (column): the shard balance."""
    plan = ShardPlan(k, p, stranded, 1, n_shards)
    bases = F.as_tensor(bases, torch.uint8, device)
    lengths = F.as_tensor(lengths, torch.int32, device)
    perm = None if permutation is None else F.as_tensor(permutation, torch.int32, device)
    labels = torch.zeros(bases.shape[0], dtype=torch.int32, device=bases.device)
    hist = np.zeros((n_shards, n_shards), np.int64)
    for s, (lo, hi) in enumerate(source_blocks(bases.shape[0], n_shards)):
        if hi > lo:
            dest = _scan_source(plan, bases[lo:hi], lengths[lo:hi], labels[lo:hi], perm)[-1]
            hist[s] = torch.bincount(dest, minlength=n_shards).cpu().numpy()
    return hist


def _shard_step(plan: ShardPlan, sub, slen, sexts, slab, data_reduce, stages: Stages):
    """One shard's count (with ``min_obs > 1``, the repair of extensions onto
    kmers censored in this shard's own census) and compression: (table,
    chains, unitig exts, contributed bases).  A shard with no interval or no
    kept kmer gives an empty table and no chain."""
    spec, dev = plan.spec, sub.device
    report_all = plan.min_obs > 1
    with stages("count"):
        if sub.shape[0] == 0:
            table = F._empty_table(spec, plan.stranded, dev, report_all)
        else:
            table = F.count_kmers(spec, sub, slen, sexts, slab, stranded=plan.stranded,
                                  min_obs=plan.min_obs, data_reduce=data_reduce,
                                  report_all=report_all)
    with stages("compress"):
        if len(table) == 0:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            return table, C._empty_chains(dev), z.to(torch.int32), z
        if report_all:
            table.exts = F.remove_censored_exts_device(spec, plan.stranded, table.kmers,
                                                       table.exts, table.all_kmers)
        chains, u_exts, contrib = C.compress_kmer_table_device(spec, plan.stranded, table.kmers,
                                                               table.exts)
    return table, chains, u_exts, contrib


def _oriented(spec: KmerSpec, kmers, flip) -> torch.Tensor:
    return torch.where(flip.bool()[:, None], KM.rc(spec, kmers), kmers)


def _global_stitch_device(plan: ShardPlan, tables, chains, u_exts, mesh: LogicalMesh,
                          stages: Stages):
    """The boundary stitch on the device, over every shard's unitigs (on a
    distributed mesh, this process's shards' ends gathered with every other
    process's, ``gather_s``): (node chains, final unitig exts).  Global node
    ids are the shard's offset plus the local unitig index (JAX's ``shard *
    cap + slot`` without the padding); chain ids follow the least node id,
    so the final graph comes out node for node as JAX's.

    The merge is compress_graph's (``graph._merge_nodes``) over every node:
    fix_exts against the global node set (cross-shard extensions resolve
    onto another shard's unitig end, or drop), node-level partners and
    ``link_chains``, and fix_exts of the final unitigs.
    """
    spec, stranded = plan.spec, plan.stranded
    parts = []
    for table, ch, ue in zip(tables, chains, u_exts):
        parts.append((_oriented(spec, gather_rows(table.kmers, ch.first_item), ch.first_flip),
                      _oriented(spec, gather_rows(table.kmers, ch.last_item), ch.last_flip),
                      ue, ch.length))
    with stages("gather"):
        g_fk, g_lk, g_exts, g_len = gather_ends(parts, mesh, stages.stats)
    valid = torch.ones(g_fk.shape[0], dtype=torch.bool, device=g_fk.device)
    _, gchains, final_exts = _merge_nodes(spec, stranded, g_fk, g_lk,
                                          sorted_ends(g_fk) + sorted_ends(g_lk), g_exts,
                                          g_len + spec.k - 1, valid)
    return gchains, final_exts


def _mesh(mesh: Optional[LogicalMesh], device) -> LogicalMesh:
    if mesh is None:
        return make_mesh(device=device)
    if mesh.device != torch.device(device):
        raise ValueError(f"the mesh lies on {mesh.device}, not on {device}")
    return mesh


def sharded_tables(
    reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh: Optional[LogicalMesh] = None,
    labels: Optional[np.ndarray] = None,
    slack: Optional[float] = None,
    cap_per_dest: Optional[int] = None,
    data_reduce: str = "label_first",
    stitch: bool = False,
    permutation=None,
    device="cuda",
    stats: Optional[dict] = None,
):
    """The sharded scan, exchange, count and compression on ``device``.

    ``mesh`` (default ``make_mesh(8, device)``) gives the shard count and
    must lie on ``device``.  ``labels`` label the reads of length >= k, in
    order.  ``permutation``: an optional (4^p,) minimizer score table
    (``msp.inverse_frequency_score_table``), the reference's
    load-balancing permutation (msp.rs:57-59, :298-311).  ``slack`` and
    ``cap_per_dest`` size JAX's exchange buffers and are unused: nothing
    overflows here.

    Returns (plan, tables, chains, u_exts, contrib), each after the plan a
    list with one entry a shard; with ``stitch`` also the device stitch's
    node chains and final unitig exts.  ``stats``, a dict, receives the
    seconds of each stage (``select_reads_s``, the list of the reads K
    long; ``pad_reads_s``, ``msp_s``, ``exchange_s``, ``count_s`` and
    ``compress_s`` a shard, ``stitch_s``, ``gather_s`` within it), the
    intervals a shard (``intervals``) and the unitigs a shard
    (``shard_unitigs``).  Each stage is also a profiler mark
    (:mod:`tpu_debruijn_torch.stages`).

    On a distributed mesh (:func:`parallel.global_mesh`) ``reads`` are this
    process's own; it scans them in source blocks of its own, trades
    intervals with the other processes and counts and compresses its own
    shards (``mesh.local``), so the lists hold those shards only, while the
    stitch's chains and exts cover every shard on every process.  A process
    with no read of length >= k still takes part in every collective;
    ``stats`` also receives ``exchange_bytes`` and ``gather_bytes``.
    """
    mesh = _mesh(mesh, device)
    dev, n_shards = mesh.device, mesh.n_shards
    stages = Stages(stats, dev)
    with stages("select_reads"):
        items = [np.asarray(s, np.uint8) for s in reads if len(s) >= k]
    if _count_reads(len(items), mesh) == 0:
        raise ValueError("no reads of length >= k")
    plan = ShardPlan(k, p, stranded, min_obs, n_shards, cap_per_dest)
    scanned = []
    if items:
        with stages("pad_reads"):
            bases, lengths = F.pad_reads(items, min_len=k, pad_to=16)
        labels = np.zeros(len(items), np.int32) if labels is None else labels
        bases, lengths = torch.from_numpy(bases).to(dev), torch.from_numpy(lengths).to(dev)
        labels = F.as_tensor(labels, torch.int32, dev)
        perm = None if permutation is None else F.as_tensor(permutation, torch.int32, dev)
        with stages("msp"):
            scanned = [_scan_source(plan, bases[lo:hi], lengths[lo:hi], labels[lo:hi], perm)
                       for lo, hi in source_blocks(bases.shape[0], len(mesh.local)) if hi > lo]
        del bases, lengths
    with stages("exchange"):
        cols = [torch.cat(c) for c in zip(*scanned)] if scanned else _no_intervals(plan, dev)
        del scanned
        shards = exchange(cols[-1], n_shards, cols[:-1], mesh, stats)
        del cols
    if stats is not None:
        stats["intervals"] = [sh[0].shape[0] for sh in shards]
    tables, chains, u_exts, contrib = [], [], [], []
    for s in range(len(shards)):
        out = _shard_step(plan, *shards[s], data_reduce, stages)
        shards[s] = None  # a shard's intervals are done with once counted
        for lst, x in zip((tables, chains, u_exts, contrib), out):
            lst.append(x)
    if stats is not None:
        stats["shard_unitigs"] = [ch.n_unitigs for ch in chains]
    if not stitch:
        return plan, tables, chains, u_exts, contrib
    with stages("stitch"):
        gchains, final_exts = _global_stitch_device(plan, tables, chains, u_exts, mesh, stages)
    return plan, tables, chains, u_exts, contrib, gchains, final_exts


def _count_reads(n: int, mesh: LogicalMesh) -> int:
    """The reads of length >= k over every process of the mesh."""
    if not mesh.distributed:
        return n
    total = torch.tensor([n], dtype=torch.int64, device=_comm_device(mesh))
    dist.all_reduce(total)
    return int(total)


def _no_intervals(plan: ShardPlan, dev) -> list:
    """The scan's columns for a process with no read: (bases, lengths,
    exts, labels, destinations) of no interval."""
    i32 = torch.zeros(0, dtype=torch.int32, device=dev)
    return [torch.zeros((0, plan.interval_len), dtype=torch.uint8, device=dev), i32, i32, i32,
            torch.zeros(0, dtype=torch.int64, device=dev)]


def _shard_unitigs(spec: KmerSpec, tables, chains, u_exts, contrib, data_reduce, dev) -> tuple:
    """The shards' unitigs, assembled on ``dev`` and concatenated in shard
    order: bases (uint8) and lengths (int64) on ``dev``, exts and data
    (int32) numpy, the data each shard's counts folded by ``data_reduce``."""
    seqs = [torch.zeros(0, dtype=torch.uint8, device=dev)]
    lens = [torch.zeros(0, dtype=torch.int64, device=dev)]
    exts, data = [np.zeros(0, np.int32)], [np.zeros(0, np.int32)]
    for table, ch, ue, cb in zip(tables, chains, u_exts, contrib):
        if ch.n_unitigs:
            seq, out_len = C.assemble_unitigs_device(spec, table.kmers, ch, cb)
            seqs.append(seq)
            lens.append(out_len)
            exts.append(ue.to(torch.int32).cpu().numpy())
            data.append(C._fold_data(data_reduce, table.counts, ch))
    return torch.cat(seqs), torch.cat(lens), np.concatenate(exts), np.concatenate(data)


def assemble_sharded(
    reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh: Optional[LogicalMesh] = None,
    labels: Optional[np.ndarray] = None,
    slack: Optional[float] = None,
    cap_per_dest: Optional[int] = None,
    data_reduce_compress="sum_sat_u16",
    collective: bool = True,
    permutation=None,
    device="cuda",
    stats: Optional[dict] = None,
):
    """The whole sharded assembly (test.rs:418-504) in one call: reads ->
    sharded count and compression -> boundary stitch -> the final
    ``DebruijnGraph`` (links on ``device``).  It equals the unsharded
    assembly of the same reads, the reference's N-shard == 1-shard oracle.

    Each shard's unitigs assemble on the device; unitig data is the shard's
    counts folded by ``data_reduce_compress``.  With ``collective`` (the
    default) the node merge runs on the shards' gathered ends, and the node
    sequences are stitched by the returned chain labels on the device where
    the shards' bases lie (``graph._merged_graph``); ``collective=False``
    combines the shard graphs on the host and re-compresses them with
    ``graph.compress_graph``, the same merge over the combined graph's
    index.  Both give the same graph.  ``stats``: see
    :func:`sharded_tables`; it also receives ``assemble_s`` (the shard
    unitigs) and ``final_s`` (the stitch's second half and the final
    graph), and within ``final_s`` with ``collective`` ``final.stitch_s``
    (the device stitch, its words and the chain labels to the host and the
    data reduce) and ``final.finish_s`` (the final graph's store and
    ``finish``).

    On a distributed mesh each process assembles its own shards' unitigs
    and :func:`gather_unitigs` brings every shard's to every process (one
    more ``gather_s``), which then uploads the bases once and stitches them
    as one process would: every process returns the same graph
    (``parallel.assemble_multiprocess``).
    """
    mesh = _mesh(mesh, device)
    dev = mesh.device
    stages = Stages(stats, dev)
    out = sharded_tables(reads, k, p, stranded=stranded, min_obs=min_obs, mesh=mesh,
                         labels=labels, slack=slack, cap_per_dest=cap_per_dest,
                         stitch=collective, permutation=permutation, device=device, stats=stats)
    plan, tables, chains, u_exts, contrib = out[:5]
    spec = plan.spec
    with stages("assemble"):
        bases, lengths, exts, data = _shard_unitigs(spec, tables, chains, u_exts, contrib,
                                                    data_reduce_compress, dev)
    if mesh.distributed or not collective:  # the host takes the bases
        bases, lengths = bases.cpu().numpy(), lengths.cpu().numpy()
    if mesh.distributed:
        with stages("gather"):
            bases, lengths, exts, data = gather_unitigs((bases, lengths, exts, data), mesh, stats)
    with stages("final"):
        if not collective:
            combined = BaseGraph(k, stranded)
            combined.add_flat(bases, lengths, exts, data)
            return compress_graph(combined.finish(device=dev), data_reduce=data_reduce_compress,
                                  device=dev)
        return _merged_graph(spec, stranded, torch.as_tensor(bases, device=dev),
                             torch.as_tensor(lengths, device=dev), data, None, out[5], out[6],
                             data_reduce=data_reduce_compress, rich_reduce=None, device=dev,
                             stage=lambda name: stages("final." + name))
