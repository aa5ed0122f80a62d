"""End-to-end assembly: FASTA/FASTQ -> unitig GFA (counterpart of ``scripts/assemble.py``).

    python -m tpu_debruijn_torch.assemble reads.fq[.gz] -o out.gfa \\
        [-k 31] [--min-obs 2] [--stranded] [--clean-tips] [--json out.json] \\
        [--max-records N] [--sharded [-p 8]] [--streaming [--memory-gb 4]] \\
        [--device cuda]

The canonical workflow (lib.rs:9-14): read the sequences, filter_kmers,
compress to unitigs, optionally clean tips, export.  It takes the JAX
script's flags and prints its summary lines to stderr; ``--device``
(default ``cuda``) says where the tables and the kernels run.
``--sharded`` runs ``parallel.assemble_sharded`` on ``make_mesh()``: 8
logical shards of the device, where the JAX script's mesh has one shard a
device (8 in its tests).  :func:`run` is the entry point for callers in the
same process.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from tpu_debruijn_torch import compress as C
from tpu_debruijn_torch import filter as F
from tpu_debruijn_torch.clean import clean_tips
from tpu_debruijn_torch.graph import DebruijnGraph, from_flat_output
from tpu_debruijn_torch.io import read_fastx
from tpu_debruijn_torch.parallel import assemble_sharded, make_mesh
from tpu_debruijn_torch.stages import Stages


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads", help="FASTA/FASTQ path (.gz ok)")
    ap.add_argument("-o", "--gfa", required=True, help="output GFA path")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("--min-obs", type=int, default=2)
    ap.add_argument("--stranded", action="store_true")
    ap.add_argument("--clean-tips", action="store_true",
                    help="remove tips shorter than 2K and re-compress")
    ap.add_argument("--json", help="also write node/link JSON here")
    ap.add_argument("--max-records", type=int, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="MSP-shard over 8 logical shards of the device "
                         "(exchange + on-device boundary stitch)")
    ap.add_argument("-p", type=int, default=8,
                    help="minimizer length for --sharded (default 8)")
    ap.add_argument("--streaming", action="store_true",
                    help="memory-bounded streaming counting (filter.rs:151-183)")
    ap.add_argument("--memory-gb", type=float, default=4.0,
                    help="device working-set bound for --streaming")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def run(argv=None, stats: Optional[dict] = None) -> Optional[DebruijnGraph]:
    """Assemble as the command line ``argv`` says and write its outputs;
    returns the graph, or None when no read is K long.  ``stats``, a dict,
    receives the seconds of each stage (``read_s``, ``count_s``,
    ``compress_s``, ``clean_tips_s``, ``export_s``; with ``--sharded``
    ``assemble_sharded_s`` and that call's own stages), each a list of one,
    every stage ending in a device synchronize
    (:class:`~tpu_debruijn_torch.stages.Stages`).  Within ``count``
    (not with ``--streaming``): ``filter.pad_s`` and ``filter.upload_s``;
    within ``compress``: ``compress.nodes_s`` (the unitigs' flat buffers
    copied to the host), ``graph.add_s`` (their one ``from_flat_output``)
    and ``graph.finish_s``; within ``clean_tips``:
    ``clean.compress_graph_s``."""
    args = parser().parse_args(argv)
    dev = torch.device(args.device)
    stage = Stages(stats, dev)
    with stage("read"):
        reads = read_fastx(args.reads, max_records=args.max_records)
        reads = [r for r in reads if len(r) >= args.k]
    if not reads:
        print("no reads of length >= K", file=sys.stderr)
        return None
    n_bases = sum(len(r) for r in reads)
    print(f"{len(reads)} reads, {n_bases} bases", file=sys.stderr)

    if args.sharded:
        mesh = make_mesh(device=dev)
        print(f"sharding over {mesh.n_shards} devices", file=sys.stderr)
        with stage("assemble_sharded"):
            graph = assemble_sharded(reads, args.k, args.p, stranded=args.stranded,
                                     min_obs=args.min_obs, mesh=mesh, device=dev, stats=stats)
    else:
        with stage("count"):
            if args.streaming:
                table = F.filter_kmers_streaming(
                    ((r, 0, 0) for r in reads), args.k, stranded=args.stranded,
                    min_obs=args.min_obs, read_len_cap=max(len(r) for r in reads),
                    memory_gb=args.memory_gb, device=dev)
            else:
                table = F.filter_kmers([(r, 0, 0) for r in reads], args.k,
                                       stranded=args.stranded, min_obs=args.min_obs, device=dev,
                                       stats=stats)
        print(f"{len(table)} filtered kmers", file=sys.stderr)
        with stage("compress"):
            flat = C.compress_kmers_flat_device(table, device=dev, stats=stats)
            del table
            with stage("graph.add"):
                base = from_flat_output(args.k, args.stranded, *flat)
            with stage("graph.finish"):
                graph = base.finish(device=dev)
    if args.clean_tips:
        with stage("clean_tips"):
            graph = clean_tips(graph, lambda node: node.len() < 2 * args.k, device=dev,
                               stats=stats)
    print(f"{len(graph)} unitigs", file=sys.stderr)

    with stage("export"):
        graph.to_gfa(args.gfa)
        if args.json:
            with open(args.json, "w") as f:
                graph.to_json(lambda d: d, f)
    lens = np.asarray(graph.base.sequences.length, np.int64)
    if len(lens):
        srt = np.sort(lens)[::-1]
        n50 = int(srt[np.cumsum(srt) >= lens.sum() / 2][0])
        print(f"total {int(lens.sum())}bp, max {int(lens.max())}bp, N50 {n50}bp", file=sys.stderr)
    return graph


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
