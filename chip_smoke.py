"""Drive the PyTorch port (tpu_debruijn_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --stages [--root DIR] [--seed N]

Phases; any failure raises and the script exits non-zero:

0. A CUDA device must be present; print its name and power limit.
1. Build the CUDA kernels from ``tpu_debruijn_torch/csrc`` with nvcc.
2. Each kernel against its plain PyTorch version on the card, bit-exact;
   kernel, plain and (where one PyTorch call computes the same function)
   library times from CUDA events, and each kernel's bound: the bytes it
   must move over the card's 3.35 TB/s.  The two kmer kernels for K in
   {4, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64}, stranded both ways, at
   the main path's shapes with ragged read lengths and non-zero read exts.
   The gather and pointer-jump kernels at the Pallas probes' shapes (2^18
   entries, (2048, 128) tables, 18 hops over successors with about 1%
   terminal), each with the one PyTorch call that computes the same
   function where there is one; the host time per call of take_along_axis
   and torch.gather.  gather_rows also at the main path's shapes: the (2n,
   4) ranking carry for the genome's 4,641,622 kmers and the count stage's
   (111.4M, 4) observation rows by a random permutation and by a sorted
   index, and 32-byte rows by the permutation, each beside its bytes-once
   bound and the random-gather floor (a 32-byte sector per row).
   successor_walk at the probe's shape and rank_loop at the ruler level of
   that carry (the shape rank_lists launches it at, with the count of rounds
   the card ran), each also with its device time under torch.profiler and
   its latency floor (dependent loads and, for rank_loop, grid barriers,
   measured on the card).  The whole ranking (rank_lists, the ruling set) against the plain
   doubling loop on that carry, a list forest and an input with cycles:
   exact where a path ends, the cycle contract on cycles; the round path on
   an in-tree of that carry, exact, in one rank_loop launch; timed against
   the one-launch doubling loop.  The two scan kernels: msp_scan at one
   phase 9 source block (116,042 reads' p-mer scores, k = 31, p = 8), on
   all-equal scores (poly-A reads) and on rising ones (a rescan a step);
   run_reduce at the count's (111.4M, 4) rows in ~4.64M runs (the exts
   column read in place, alone and with a sum column) and with one run of
   10^7 rows, beside the sector floor and torch.segment_reduce's sum.  The
   one-pass forms: run_reduce_rows on (111.4M, 4) sorted rows in ~4.64M
   runs (labels "first", "min" and "sum", into a separate output and in
   place) beside torch.unique_consecutive on the key, and on one run of
   10^7 rows, all rows distinct, runs of a tile +- 1 and a run past 65535
   rows; msp_scan_reads at one phase 9 source block of bases and on poly-A
   reads, rising scores, p = 16 and the inverse-frequency table; both with
   their device time under torch.profiler.
3. The main path, the README quick start on device="cuda", at bacterial
   genome scale: a random genome of E. coli K-12 MG1655's length
   (4,641,652 bp), 150 bp reads at 30x coverage, half reverse-complemented,
   written to a FASTQ file.  Checks: the kmer kernels, gather_rows,
   run_reduce_rows, rank_lists and rank_loop launched (one rank_loop per
   ranking; its rounds are read from the device count; every path is held
   to its own list, ON_PATH_BY: msp_scan_reads on the sharded paths and
   phase 12's only), gather_rows in the count and
   compress stages and in resolve_edges (called once more on the table
   after the counts are read), rank_lists never took its round path, the
   table lies on the card, every table kmer is in exactly one unitig, every
   unitig is a substring of the genome or of its reverse complement, and
   the GFA has one S line per node.  Then compress_kmers' default policy on
   that table in its two forms, in turns: chain labels assembled on the
   host, and sequences assembled on the card (compress_kmers_flat_device):
   equal unitigs; host seconds, device busy and device-to-host copy ms
   under torch.profiler, and the bytes each copies to the host.
4. The read-ordered path on phase 3's reads, held in memory:
   filter_kmers(data_reduce="obs_min") -> compress_kmer_table_device(
   first_pos=...) -> assemble_unitigs.  Checks: no overflow, chains equal
   to the plain linker's on the same table and to link_chains_ordered
   called in the JAX package's positional form (valid None and a mask), unitigs equal to phase 3's,
   the same kernels launched as in phase 3; prints the interval count, the
   rounds of each linker's rank_loop and the compress seconds of both
   linkers.
5. A repeat-rich 1 Mb genome tiled from 12 chunks of 300 bp, 30x: the same
   checks as phase 3 but the substring one.
6. The CUDA path against the CPU path on a small input: identical tables,
   unitig lists and GFA bytes; and the colored streaming count
   (filter_kmers_streaming(colored=True), four colors, one negative):
   identical tables, pair labels and splits; and every entry point of the
   colored / policy path on labeled reads (set, eq-class and summarizer
   filters, color-set, rich, ScmapCompress and no-exts compression,
   inferred and censored exts, the GFA bytes of from_flat_output):
   identical outputs (policy_outputs, which the card tests also run); and
   the error-handling path on a 20 kb genome's reads with sequencing
   errors (error_outputs: compress, compress_graph, remove_censored_exts
   and clean_tips at min_obs 1 and 2): identical GFA bytes.
7. The corpus path on phase 3's FASTQ file: stream_fastx_blocks ->
   filter_kmers_streaming(merge="device") in bench.py's 64 batches, the
   table equal to phase 3's bit for bit; the same reads as per-read tuples
   through the host merge with memory_gb=1, the table equal and the peak
   device memory under 1e9 bytes; compress_kmers on the streamed table,
   the unitigs equal to phase 3's; the device merge at K = 63 on phase 5's
   reads against one-batch filter_kmers.  Launches are counted from the
   first streaming run through the compress ("corpus" in the kernels'
   line); prints decode and count + merge seconds, chunks, seconds per
   chunk, observations per second, table kmers and peak device bytes, the
   host merge's seconds by function under cProfile, the device busy time
   of the streamed count under torch.profiler, the join merge against a
   concatenate-and-sort merge at the last merge's shape, and a pinned
   against a pageable upload of one packed chunk.  count_kmers' peak bytes
   a read on random reads, and count_kmer_pairs' with four labels, must stay
   under filter.count_bytes_per_read.
8. The colored path at full width: four strains of phase 3's genome, each
   with its own substitutions (one per 1,000 bp, positions and bases from
   --seed), 150 bp reads at 15x a strain, half reverse-complemented,
   labelled by strain; k = 31, min_obs = 2.  filter_kmers_set_arrays in
   one batch equals filter_kmers_streaming(colored=True) in 64 chunks;
   filter_kmers_eq_classes gives equal ids exactly where the sets are
   equal, and assign_eq_classes on the same pairs gives the same ids and
   classes in its dense and its hashed form (each timed);
   compress_kmers_color_sets with and without the set join puts
   every table kmer in one unitig, every unitig in a strain or its reverse
   complement, every color set sorted and distinct, and with the join
   equals compress_kmers(ScmapCompress) of the eq-class table; device and
   host assembly agree (timed as in phase 3); compress_kmers_no_exts
   meets the same invariants; remove_censored_exts leaves no extension
   onto a missing kmer.  Launches are counted from the count through both
   color-set compressions ("colored").  On 20,000 of phase 5's reads with
   four labels, compress_kmers_rich and the three summarizers are held
   against the array forms.
9. The MSP-sharded path at full width: phase 3's reads through
   parallel.assemble_sharded (k = 31, p = 8, min_obs = 2) on 8 logical
   shards of the card.  Checks: the union of the shard tables equals phase
   3's table (kmers and counts bit for bit, no kmer in two shards, exts but
   for extensions a shard dropped onto kmers censored in its own census),
   the device stitch and the host stitch (compress_graph) give the same
   node rows, the unitigs equal phase 3's as canonical sequences, the
   balancing permutation (inverse_frequency_score_table of 20,000 reads)
   leaves the graph unchanged; the same on phase 5's reads at min_obs = 1
   (tables exact), where clean_tips leaves a graph compress_graph does not
   change.  Launches are counted over one assemble_sharded call
   ("sharded"); prints the intervals a shard with and without the
   permutation, the seconds of each stage (scan, exchange, per-shard counts
   and compressions, each stitch, pad_reads apart), the peak device memory
   beside phase 3's, and the card's busy time under torch.profiler.
   Phase 6 also holds the sharded path CUDA == CPU (sharded_outputs: both
   stitches, compress_graph, clean_tips; GFA bytes).
10. The command line and the graph API at full size: phase 8's 1,856,664
   reads written to a FASTQ file and assembled by assemble.run (python -m
   tpu_debruijn_torch.assemble; k = 31, min_obs = 2, unstranded, with
   --json), launches counted over that run ("cli"); its GFA must equal
   filter_kmers -> compress_kmers -> from_compress_output -> to_gfa on the
   reads in memory, its JSON parse to one node a unitig.  On its graph:
   max_path and max_path_beam(4) with the counts as scores (node ids
   unique, each step an edge of find_edges, every kmer of the path's
   sequence a table kmer; seconds, nodes, bases and the Hamming distance
   to the base genome's stretch); is_compressed (a pair only through an
   extension onto a kmer min_obs dropped, none after compress_graph; on a
   one-node-per-kmer graph of phase 5's table a pair, and compress_graph
   gives phase 5's unitigs); write_gfa == to_gfa, to_json == the CLI's
   file, to_dot and to_gfa_with_tags timed; save/load of the graph (GFA
   bytes), of compress_kmers_rich's graph with int-tuple and pickled
   sidecars, and of the 5.2M-kmer table (bit for bit, back on the card);
   get_key_id / get / get_key of 10,000 table kmers, at_count + gc_count ==
   K and hamming_dist(a, a) == 0 on every kmer, hamming_neighbors in
   chunks (3K candidates a kmer, one_hamming_iter's order on 1,000) and
   the count of table kmers with an HD-1 neighbour in the table.  Phase 6
   also holds the command line CUDA == CPU (cli_outputs: GFA and JSON
   bytes, both walks, both checkpoints' arrays).
11. The sharded path over several processes: phase 3's reads written to 4
   FASTQ files and assembled by parallel.assemble_multihost in two worker
   processes on the card (fresh interpreters importing only the port;
   gloo, since NCCL refuses two processes on one card; an 8-shard
   global_mesh, so each process reads 2 files and counts 4 shards), and by
   assemble_multiprocess in one worker under NCCL (a group of one, which
   still runs the all_to_all_single exchange and the all_gathers).  Checks:
   both ranks' GFA bytes equal, equal to phase 9's assemble_sharded and to
   the NCCL run's; each rank read files r, r + 2; the union of the ranks'
   shard tables equals phase 3's table as in phase 9.  Launches are
   counted in each worker over its assemble_multihost call and summed over
   the ranks ("multiprocess"); prints each rank's stage seconds, peak
   device memory, bytes exchanged and gathered, shard unitigs and wall
   time, beside phase 9's one-process call.
12. The error-handling path at full width: phase 3's genome, 150 bp reads
   at 30x (928,331, half reverse-complemented) with sequencing errors
   (sample_error_reads: substitutions rising along the read from 0.1% to
   0.9%, one-base insertions and deletions at 0.01% a base), written to a
   FASTQ file; k = 31, unstranded, at min_obs 1 and 2.  Checks: the table
   equals a plain numpy count of canonical kmer codes (kmers and counts);
   the streamed count of the FASTQ file in 64 chunks equals it bit for bit,
   and so does the union of assemble_sharded's shard tables (at min_obs =
   2 but for the exts a shard drops onto kmers censored in its own census);
   every table kmer lies in exactly one unitig with and without
   remove_censored_exts; compress_graph of the one-batch graph, the graph
   after remove_censored_exts, assemble_sharded (p = 8, 8 shards) and
   compress_graph of it are compressed and equal as canonical sequence
   sets; every node find_bad_nodes returns is a tip shorter than 2K,
   clean_tips leaves a smaller compressed graph with one GFA S line a node,
   the same set from the sharded graph; the min_obs = 2 table holds at
   least 99.9% of the genome's kmers.  Launches are counted over all of
   that ("errors", which must also launch msp_scan_reads); prints the
   errors injected, table kmers and singletons, nodes before and after
   the censor and clean_tips, tips, the seconds of every stage, the peaks
   of the count and the compress, the card's busy time of the min_obs = 1
   count and compress, and run_reduce_rows, rank_lists (with its
   rank_loop rounds), rank_loop on a random ruler level of the same rows
   and lists, and gather_rows at the phase's own shapes, each exact
   against its plain version beside its bound.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``--stages`` runs none of that: it times the quick start's count (and its
peak) and compress stages and both linkers on E. coli-length reads held in
memory, the count's tail pass by pass, phase 9's assemble_sharded (its
"msp" stage), phase 7's streamed count of a FASTQ file (a chunk's median and
its gather_rows launches) and phase 8's colored count (and its peak), with
the card's busy time under torch.profiler, and the extraction kernel, the
whole ranking and the count stage's row gathers at the main path's shapes,
with the package found in ``--root`` (default: beside this script), and
prints one JSON line.  Run it
on two checkouts in turns to compare them on one card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ECOLI_LEN = 4_641_652  # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 30
K = 31
KS = [4, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64]
N_STRAINS = 4  # phase 8: strains of phase 3's genome
SNP_EVERY = 1000  # one private substitution a strain per this many bases
STRAIN_COVERAGE = 15
SMALL_READS = 20_000  # phase 8's per-kmer and per-edge Python forms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
# phase 12's sequencing errors (Illumina-like): substitutions a base, rising
# along the read from the first rate to the second; one-base insertions and
# deletions, each at INDEL_RATE a base, in an ERR_WINDOW-base stretch
SUB_RATE = (0.001, 0.009)
INDEL_RATE = 1e-4
ERR_WINDOW = 160
_LUT = np.frombuffer(b"ACGT", np.uint8)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_genome(rng, length: int, repeat_rich: bool) -> np.ndarray:
    if not repeat_rich:
        return rng.integers(0, 4, length, dtype=np.uint8)
    # a genome tiled from a small chunk pool: a branchy, repeat-heavy graph
    pool = [rng.integers(0, 4, 300, dtype=np.uint8) for _ in range(12)]
    parts = [pool[int(i)] for i in rng.integers(0, len(pool), length // 300 + 1)]
    return np.concatenate(parts)[:length]


def sample_reads(rng, genome: np.ndarray, coverage: int, read_len: int) -> np.ndarray:
    """(n, read_len) reads at ``coverage``, half reverse-complemented."""
    n = -(-coverage * len(genome) // read_len)
    starts = rng.integers(0, len(genome) - read_len + 1, n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return reads


def sample_error_reads(rng, genome: np.ndarray, coverage: int, read_len: int):
    """(n, read_len) reads at ``coverage`` with sequencing errors, half
    reverse-complemented, and the errors injected (a dict of counts).

    Each read starts as an ERR_WINDOW-base stretch of ``genome``.  One-base
    deletions and insertions each hit a window base at INDEL_RATE (a
    deletion drops the base, an insertion puts a uniform base after it);
    the result is cut to ``read_len``.  After the strand flip, each base
    is substituted at a rate rising linearly along the read from
    SUB_RATE[0] to SUB_RATE[1], by one of the other three bases, uniform.
    The draws, in this order: starts, deletions, insertions, inserted bases,
    flips, substitutions, their shifts (tests/test_torch_errors.py's
    per-read twin makes the same reads from them)."""
    n = -(-coverage * len(genome) // read_len)
    win = ERR_WINDOW
    starts = rng.integers(0, len(genome) - win + 1, n)
    stretch = genome[starts[:, None] + np.arange(win)[None, :]]
    dele = rng.random((n, win), dtype=np.float32) < INDEL_RATE
    ins = rng.random((n, win), dtype=np.float32) < INDEL_RATE
    ins_base = rng.integers(0, 4, (n, win), dtype=np.uint8)
    reads = stretch[:, :read_len].copy()
    n_del = n_ins = 0
    for i in np.nonzero((dele | ins).any(axis=1))[0]:
        # window base j, then its inserted base: slots 2j and 2j + 1
        slots = np.stack([stretch[i], ins_base[i]], axis=1).reshape(-1)
        keep = np.stack([~dele[i], ins[i]], axis=1).reshape(-1)
        kept = np.nonzero(keep)[0][:read_len]
        check(kept.shape[0] == read_len, "a read lost more bases than its window holds")
        reads[i] = slots[kept]
        used = kept[-1] // 2 + 1  # window bases the read reached
        n_del += int(dele[i, :used].sum())
        n_ins += int(ins[i, : (kept[-1] + 1) // 2].sum())
    del stretch, dele, ins, ins_base
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random((n, read_len), dtype=np.float32) < np.linspace(
        *SUB_RATE, read_len, dtype=np.float32)
    shift = rng.integers(1, 4, (n, read_len), dtype=np.uint8)
    reads = np.where(sub, (reads + shift) & 3, reads).astype(np.uint8)
    errors = {"reads": n, "substitutions": int(sub.sum()), "insertions": n_ins,
              "deletions": n_del, "reads_without_error": int(n - (sub.any(axis=1).sum()))}
    return reads, errors


def numpy_rc(v: np.ndarray, k: int) -> np.ndarray:
    """Reverse complements of 2-bit packed uint64 kmers (k <= 32)."""
    m = np.uint64
    x = ~v
    x = ((x & m(0x3333333333333333)) << m(2)) | ((x >> m(2)) & m(0x3333333333333333))
    x = ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4)) | ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F))
    x = ((x & m(0x00FF00FF00FF00FF)) << m(8)) | ((x >> m(8)) & m(0x00FF00FF00FF00FF))
    x = ((x & m(0x0000FFFF0000FFFF)) << m(16)) | ((x >> m(16)) & m(0x0000FFFF0000FFFF))
    x = (x << m(32)) | (x >> m(32))
    return x >> m(64 - 2 * k)


def plain_count(reads: np.ndarray, k: int):
    """A count of canonical kmer codes in numpy, independent of the port:
    every kmer of every (n, l) read as a 2k-bit code, the lesser of it and
    its reverse complement; returns (sorted unique codes, counts) as uint64
    and int64 (k <= 32)."""
    n, l = reads.shape
    lk = l - k + 1
    v = np.zeros((n, lk), np.uint64)
    for j in range(k):
        v <<= np.uint64(2)
        v |= reads[:, j : j + lk]
    v = v.reshape(-1)
    v = np.minimum(v, numpy_rc(v, k))
    v.sort()
    head = np.ones(v.shape[0], bool)
    head[1:] = v[1:] != v[:-1]
    starts = np.nonzero(head)[0]
    return v[starts], np.diff(np.append(starts, v.shape[0]))


def write_fastq(path: str, reads: np.ndarray) -> None:
    """One record per row: '@r', the bases, '+', a constant quality."""
    n, l = reads.shape
    rec = np.empty((n, 3 + l + 3 + l + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + l] = _LUT[reads]
    rec[:, 3 + l : 6 + l] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + l : 6 + 2 * l] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(fn, plain):
    """Kernel and plain times in the order plain, kernel, kernel, plain:
    (best kernel ms, best plain ms, all four)."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(fn), time_ms(fn), time_ms(plain)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def kernel_row(name, source, replaces, fn, plain, err, shape, nbytes: int, library=None) -> dict:
    """Time a kernel against its plain version (and the one PyTorch call
    that computes the same function, where there is one); its record for
    the JSON line.  ``nbytes``: each input byte read once, each output byte
    written once, which over the device memory rate is the bound."""
    ms, plain_ms, all4 = time_pair(fn, plain)
    library_ms = None if library is None else min(time_ms(library), time_ms(library))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: {name} at {shape}: kernel {all4[0]:.4f} / {all4[1]:.4f} ms, "
        f"plain {all4[2]:.4f} / {all4[3]:.4f} ms, library {library_ms}, "
        f"bound {bound_ms:.4f} ms ({nbytes} bytes, {bound_ms / ms:.1%} of it)")
    return {
        "name": name, "route": "cuda", "source": f"tpu_debruijn_torch/csrc/{source}",
        "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
        "library_ms": library_ms, "shape": shape,
    }


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_diff(got, want, mask=None) -> int:
    err = 0
    for g, w in zip(got, want):
        if mask is not None:
            g, w = g[mask], w[mask]
        check(g.shape == w.shape, "kernel and plain shapes differ")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def random_kmers(gen, spec, n: int, device) -> torch.Tensor:
    limbs = torch.randint(0, 1 << 32, (n, spec.w), generator=gen, dtype=torch.int64, device=device)
    limbs[:, 0] &= int(spec.top_mask)
    return limbs


def phase_kernels(gen, n_reads: int, canon_rows: int, device) -> list:
    from tpu_debruijn_torch.kernels import (
        canonicalize, canonicalize_plain, extract_canonical, extract_canonical_plain,
    )
    from tpu_debruijn_torch.kmer import KmerSpec

    l = -(-READ_LEN // 16) * 16  # filter_kmers pads rows to a multiple of 16
    bases = torch.randint(0, 4, (n_reads, l), generator=gen, dtype=torch.uint8, device=device)
    seq_exts = torch.randint(0, 256, (n_reads,), generator=gen, dtype=torch.int32, device=device)
    err_c = err_x = 0
    for k in KS:
        spec = KmerSpec(k)
        km = random_kmers(gen, spec, canon_rows, device)
        ex = torch.randint(0, 256, (canon_rows,), generator=gen, dtype=torch.int32, device=device)
        e = max_abs_diff(canonicalize(spec, km, ex), canonicalize_plain(spec, km, ex))
        check(e == 0, f"canonical kernel != plain at K={k} (max abs err {e})")
        err_c = max(err_c, e)
        del km, ex
        lengths = torch.randint(k, l + 1, (n_reads,), generator=gen, dtype=torch.int32, device=device)
        for stranded in (False, True):
            got = extract_canonical(spec, bases, lengths, seq_exts, stranded)
            want = extract_canonical_plain(spec, bases, lengths, seq_exts, stranded)
            check(torch.equal(got[2], want[2]), f"extract valid mask differs at K={k}")
            e = max_abs_diff(got[:2], want[:2], mask=want[2])
            check(e == 0, f"extract kernel != plain at K={k} stranded={stranded} (max abs err {e})")
            err_x = max(err_x, e)
            del got, want
        torch.cuda.synchronize()
        log(f"phase 2: K={k} canonical and extract_canonical bit-exact against plain")

    # times at the main path's shapes: K=31, unstranded
    spec = KmerSpec(K)
    km = random_kmers(gen, spec, canon_rows, device)
    ex = torch.zeros(canon_rows, dtype=torch.int32, device=device)
    lengths = torch.full((n_reads,), READ_LEN, dtype=torch.int32, device=device)
    canon_out = canonicalize(spec, km, ex)
    extract_out = extract_canonical(spec, bases, lengths, seq_exts, False)
    rows = [
        kernel_row("canonical", "canonical.cu", "tpu_debruijn/kernels/canonical.py:57",
                   lambda: canonicalize(spec, km, ex), lambda: canonicalize_plain(spec, km, ex),
                   err_c, f"({canon_rows}, {spec.w}) int64", nbytes(km, ex, *canon_out)),
        kernel_row("extract_canonical", "extract_canonical.cu",
                   "tpu_debruijn/kernels/extract_canonical.py:66",
                   lambda: extract_canonical(spec, bases, lengths, seq_exts, False),
                   lambda: extract_canonical_plain(spec, bases, lengths, seq_exts, False),
                   err_x, f"({n_reads}, {l}) uint8",
                   nbytes(bases, lengths, seq_exts, *extract_out)),
    ]
    del canon_out, extract_out
    # the extraction's tile size, in turns around the wrapper's
    ec = sys.modules["tpu_debruijn_torch.kernels.extract_canonical"]
    chosen, tiles = ec.TILE_SLOTS, {}
    for ec.TILE_SLOTS in (1024, 2048, 4096, 4096, 2048, 1024):
        t = time_ms(lambda: extract_canonical(spec, bases, lengths, seq_exts, False))
        tiles[ec.TILE_SLOTS] = min(t, tiles.get(ec.TILE_SLOTS, t))
    ec.TILE_SLOTS = chosen
    log(f"phase 2: extract_canonical ms by TILE_SLOTS (wrapper: {chosen}): " + json.dumps(tiles))
    # what the card takes to write as many bytes, with nothing to compute
    sink = torch.empty(nbytes(*extract_canonical(spec, bases, lengths, seq_exts, False)) // 8,
                       dtype=torch.int64, device=device)
    log(f"phase 2: writing the extraction's {8 * sink.numel()} output bytes with fill_: "
        f"{min(time_ms(lambda: sink.fill_(1)) for _ in range(2)):.4f} ms")
    del sink
    log(f"phase 2 shapes: extract (R={n_reads}, L={l}) uint8, canonical ({canon_rows}, {spec.w}) int64")
    return rows


def successor_forest(gen, m: int, mean_len: float, device, cyclic: bool = False) -> torch.Tensor:
    """(m,) int64 successors: random lists of about ``mean_len`` states;
    with ``cyclic``, half the states lie on random cycles instead."""
    perm = torch.randperm(m, generator=gen, device=device)
    succ = torch.full((m,), -1, dtype=torch.int64, device=device)
    lists = perm[: m // 2] if cyclic else perm
    cut = torch.rand(lists.shape[0], generator=gen, device=device) < 1.0 / mean_len
    cut[-1] = True
    succ[lists] = torch.where(cut, -1, torch.roll(lists, -1))
    if cyclic:
        loop = perm[m // 2 :]
        succ[loop] = loop[torch.randperm(loop.shape[0], generator=gen, device=device)]
    return succ


def phase_pointer_kernels(gen, n_states: int, device) -> list:
    """The gather and pointer-jump kernels against their plain versions: at
    the Pallas probes' shapes, and gather_rows, rank_loop and rank_lists
    also at the main path's (n_states, 4) carry."""
    from tpu_debruijn_torch.kernels import (
        gather_rows, gather_rows_plain, rank_lists, rank_lists_plain, rank_loop, rank_round_plain,
        successor_walk, successor_walk_plain, take_along_axis, take_along_axis_plain,
    )

    def ri(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32, device=device)

    def exact(what, got, want):
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        e = max_abs_diff(got, want)
        check(e == 0, f"{what}: kernel != plain (max abs err {e})")
        return e

    m, r, l = 1 << 18, 2048, 128  # probe_pallas_gather.py:40, probe_pallas_gather2.py:34
    idx, tab, tab4, tab2 = ri(m, (m,)), ri(2**31, (m,)), ri(2**31, (m, 4)), ri(2**31, (r, l))
    idx_rows, idx_lanes, idx_flat, idx_r = ri(r, (r, l)), ri(l, (r, l)), ri(r * l, (r, l)), ri(r, (r,))
    # torch.gather, torch.take and advanced indexing take int64 indices
    rows64, lanes64 = idx_rows.long(), idx_lanes.long()
    # probe_pallas_gather.py:102-104: about 1% terminal
    succ = torch.where(torch.rand(m, generator=gen, device=device) < 0.99, ri(m, (m,)), -1).to(torch.int32)
    err = {"gather_rows": 0, "take_along_axis": 0, "successor_walk": 0, "rank_loop": 0,
           "rank_lists": 0}
    # each probe's form: (probe, kernel, kernel call, plain call, the one
    # PyTorch call computing the same function, or why there is none)
    for what, family, fn, plain, library in (
        ("P1/P2 (2^18,) int32", "gather_rows",
         lambda: gather_rows(tab, idx), lambda: gather_rows_plain(tab, idx),
         lambda: torch.index_select(tab, 0, idx)),
        ("P3 (2^18, 4) int32", "gather_rows",
         lambda: gather_rows(tab4, idx), lambda: gather_rows_plain(tab4, idx),
         lambda: torch.index_select(tab4, 0, idx)),
        ("V1 (2048, 128) axis 0", "take_along_axis",
         lambda: take_along_axis(tab2, idx_rows, 0), lambda: take_along_axis_plain(tab2, idx_rows, 0),
         lambda: torch.gather(tab2, 0, rows64)),
        ("V2 (2048, 128) axis 1", "take_along_axis",
         lambda: take_along_axis(tab2, idx_lanes, 1), lambda: take_along_axis_plain(tab2, idx_lanes, 1),
         lambda: torch.gather(tab2, 1, lanes64)),
        ("V3 (2^18, 128) int32", "gather_rows",
         lambda: gather_rows(tab2, idx_rows.reshape(-1)),
         lambda: gather_rows_plain(tab2, idx_rows.reshape(-1)),
         lambda: torch.index_select(tab2, 0, idx_rows.reshape(-1))),
        ("V4 (2048, 128) two takes", "take_along_axis",
         lambda: take_along_axis(take_along_axis(tab2, idx_flat // l, 0), idx_flat % l, 1),
         lambda: take_along_axis_plain(take_along_axis_plain(tab2, idx_flat // l, 0), idx_flat % l, 1),
         "none: the second take reads the first's output at another lane, so the "
         "pair is not torch.take of the flat index, and no one call composes them"),
        ("W1 (2048,) rows of 128", "gather_rows",
         lambda: gather_rows(tab2, idx_r), lambda: gather_rows_plain(tab2, idx_r),
         lambda: torch.index_select(tab2, 0, idx_r)),
        ("W2 (2048, 128) row + lane take", "gather_rows",
         lambda: take_along_axis(gather_rows(tab2, idx_rows[:, 0]), idx_lanes, 1),
         lambda: take_along_axis_plain(gather_rows_plain(tab2, idx_rows[:, 0]), idx_lanes, 1),
         lambda: tab2[rows64[:, :1], lanes64]),
    ):
        got = fn()
        err[family] = max(err[family], exact(what, got, plain()))
        ms, plain_ms, _ = time_pair(fn, plain)
        if isinstance(library, str):
            lib = library
        else:
            check(torch.equal(library(), got), f"{what}: the library call differs")
            lib = f"{min(time_ms(library), time_ms(library)):.4f} ms"
        log(f"phase 2: {what}: bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}")
    host_launch_costs(tab2, idx_rows, rows64)

    # the main path's shape: the (2n, 4) int32 carry of chain linking on the
    # E. coli table, two lists of n states as the genome's one unitig gives,
    # in its first round (every pointer live)
    s0 = successor_forest(gen, n_states, n_states // 2, device)
    x = torch.stack([
        s0, s0 >= 0, torch.randint(0, 1 << 30, (n_states,), generator=gen, device=device),
        torch.where(s0 < 0, torch.arange(n_states, device=device), -1),
    ], dim=1).to(torch.int32)
    gidx = torch.randint(0, n_states, (n_states,), generator=gen, device=device)
    gather_line("gather_rows, chain-linking carry", x, gidx)
    one_round = lambda: rank_loop(x, 1, early_exit=False)[0]
    err["rank_loop"] = exact("one rank_loop round, main shape", one_round(), rank_round_plain(x)[0])
    err["rank_lists"] = phase_ranking(gen, x, device)
    shape_main = f"({n_states}, 4) int32"
    carry_bytes = 2 * nbytes(x)
    ms, plain_ms, _ = time_pair(one_round, lambda: rank_round_plain(x))
    log(f"phase 2: one rank_loop round on the whole carry {shape_main}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {carry_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    rank_row = rank_loop_ruler_level(gen, x, device)
    rank_list_row = kernel_row("rank_lists", "list_rank.cu", "tpu_debruijn/compress.py:277",
                               lambda: rank_lists(x), lambda: rank_lists_plain(x),
                               err["rank_lists"], shape_main + ", two lists", carry_bytes)
    del x, gidx, s0
    torch.cuda.empty_cache()

    # the count stage's gathers: one packed 16-byte row per observation of
    # the E. coli reads, by the sort permutation (random) and by a sorted
    # index (the valid-slot compaction's kind)
    n_obs = -(-COVERAGE * ECOLI_LEN // READ_LEN) * (READ_LEN - K + 1)
    obs = ri(2**31, (n_obs, 4))
    perm = torch.randperm(n_obs, generator=gen, device=device)
    count_row = gather_line("gather_rows, count stage by the sort permutation", obs, perm)
    err["gather_rows"] = max(err["gather_rows"], count_row["max_abs_err"])
    gather_line("gather_rows, count stage by a sorted index",
                obs, torch.arange(n_obs, device=device))
    del obs
    # 32-byte rows, the packed observation rows of W = 3 and 4
    gather_line("gather_rows, 32-byte rows by the sort permutation", ri(2**31, (n_obs, 8)), perm)
    del perm
    torch.cuda.empty_cache()

    rows = [
        count_row,
        kernel_row("take_along_axis", "gather.cu", "scripts/probe_pallas_gather2.py:60",
                   lambda: take_along_axis(tab2, idx_rows, 0),
                   lambda: take_along_axis_plain(tab2, idx_rows, 0),
                   err["take_along_axis"], f"({r}, {l}) int32, axis 0", nbytes(tab2, idx_rows, tab2),
                   library=lambda: torch.gather(tab2, 0, rows64)),
        walk_row(succ),
        {**rank_row, "max_abs_err": max(rank_row["max_abs_err"], err["rank_loop"])},
        rank_list_row,
    ]
    return rows


def exact_err(what, fn, plain) -> int:
    """A kernel's outputs against its plain version's: the max abs error,
    which must be 0."""
    got, want = fn(), plain()
    e = max_abs_diff([g for g in got if g is not None], [w for w in want if w is not None])
    check(e == 0, f"{what}: kernel != plain (max abs err {e})")
    return e


def timed_exact(what, fn, plain) -> tuple:
    """:func:`exact_err`, then both timed in turns: (max abs err, best
    kernel ms, best plain ms)."""
    e = exact_err(what, fn, plain)
    ms, plain_ms, _ = time_pair(fn, plain)
    return e, ms, plain_ms


def phase_scan_kernels(gen, n_reads: int, n_obs: int, device) -> list:
    """msp_scan at one phase 9 source block (ceil(R / 8) reads of phase 3's
    row width, k = 31, p = 8) and run_reduce at the quick start's count
    (n_obs 16-byte rows in runs of ~24), each against its plain version and
    on a skewed input: all-equal scores (poly-A reads) and one run of 10^7
    rows."""
    from tpu_debruijn_torch import msp as TM
    from tpu_debruijn_torch.kernels import msp_scan, msp_scan_plain, run_reduce, run_reduce_plain

    rows = []
    # msp_scan: the scores msp_scan_batch builds for random reads
    l = -(-READ_LEN // 16) * 16
    block = -(-n_reads // N_SHARDS)
    w = K - P_MSP + 1
    lengths = torch.full((block,), READ_LEN, dtype=torch.int32, device=device)
    bases = torch.randint(0, 4, (block, l), generator=gen, dtype=torch.uint8, device=device)
    scores = TM.msp_scores(P_MSP, bases, lengths)[1]
    flat = TM.msp_scores(P_MSP, torch.zeros_like(bases), lengths)[1]  # poly-A: all equal
    check(bool((flat == flat[0, 0]).all()), "poly-A reads gave unequal scores")
    del bases
    lk = scores.shape[1] - w + 1
    e = exact_err("msp_scan", lambda: msp_scan(scores, w), lambda: msp_scan_plain(scores, w))
    rec = kernel_row("msp_scan", "msp_scan.cu", "tpu_debruijn/msp.py:145",
                     lambda: msp_scan(scores, w), lambda: msp_scan_plain(scores, w), e,
                     f"({block}, {scores.shape[1]}) int32 scores, w = {w}",
                     nbytes(scores) + block * lk * (1 + 4 + 4))
    e2, ms2, plain2 = timed_exact("msp_scan all-equal", lambda: msp_scan(flat, w),
                                  lambda: msp_scan_plain(flat, w))
    rising = torch.arange(scores.shape[1], dtype=torch.int32, device=device).expand_as(scores).contiguous()
    e3 = exact_err("msp_scan rising", lambda: msp_scan(rising, w), lambda: msp_scan_plain(rising, w))
    ms3 = min(time_ms(lambda: msp_scan(rising, w)) for _ in range(2))
    rec.update(max_abs_err=max(e, e2, e3), skewed="all-equal scores (poly-A reads)",
               skewed_ms=ms2, skewed_plain_ms=plain2, rising_ms=ms3)
    log(f"phase 2: msp_scan all-equal scores {ms2:.4f} ms (plain {plain2:.4f}), rising scores "
        f"(a rescan every step) {ms3:.4f} ms, random {rec['ms']:.4f} ms")
    rows.append(rec)
    del scores, flat, rising, lengths

    # run_reduce: the exts column of the sorted packed rows, runs of ~24
    obs = torch.randint(0, 1 << 31, (n_obs, 4), generator=gen, dtype=torch.int32, device=device)

    def ends_of(lens):
        ends = torch.cumsum(lens, 0)
        ends = ends[ends < n_obs]
        return torch.cat([ends, ends.new_full((1,), n_obs)])

    ends = ends_of(torch.randint(1, 48, (n_obs // 24 + 1,), generator=gen, device=device))
    u = ends.shape[0]
    col, sum_col = obs[:, 2], obs[:, 3]
    e = exact_err("run_reduce", lambda: run_reduce(ends, col), lambda: run_reduce_plain(ends, col))
    eb, both_ms, both_plain = timed_exact("run_reduce with sums", lambda: run_reduce(ends, col, sum_col),
                                          lambda: run_reduce_plain(ends, col, sum_col))
    library, library_form = None, None
    lens = torch.diff(ends, prepend=ends.new_zeros(1))
    for dt in (torch.int32, torch.int64, torch.float64):
        data = sum_col if dt == torch.int32 else sum_col.to(dt)
        try:
            torch.segment_reduce(data, "sum", lengths=lens)
        except (RuntimeError, NotImplementedError) as err:
            log(f"phase 2: torch.segment_reduce on {dt}: {type(err).__name__}")
            continue
        library, library_form = (lambda d=data: torch.segment_reduce(d, "sum", lengths=lens)), str(dt)
        break
    rec = kernel_row("run_reduce", "run_reduce.cu", "tpu_debruijn/sorting.py:316",
                     lambda: run_reduce(ends, col), lambda: run_reduce_plain(ends, col), e,
                     f"({n_obs}, 4) int32 rows, column 2, {u} runs",
                     nbytes(col, ends) + u * 4, library=library)
    rec["library"] = f"torch.segment_reduce sum of column 3 ({library_form})" if library else None
    rec["floor_ms"] = (n_obs * 16 + nbytes(ends) + u * 4) / HBM_BYTES_PER_S * 1e3
    skew = torch.randint(1, 48, (n_obs // 24 + 1,), generator=gen, device=device)
    skew[u // 2] = 10**7  # one run of 10^7 rows
    ends_s = ends_of(skew)
    e2, ms2, plain2 = timed_exact("run_reduce one long run", lambda: run_reduce(ends_s, col, sum_col),
                                  lambda: run_reduce_plain(ends_s, col, sum_col))
    ms2_or = min(time_ms(lambda: run_reduce(ends_s, col)) for _ in range(2))
    rec.update(max_abs_err=max(e, eb, e2), both_ms=both_ms, both_plain_ms=both_plain,
               skewed=f"one run of 10^7 rows among {ends_s.shape[0]} runs", skewed_ms=ms2_or,
               skewed_both_ms=ms2, skewed_plain_ms=plain2, replaces_also="tpu_debruijn/filter.py:1195")
    log(f"phase 2: run_reduce OR {rec['ms']:.4f} ms, OR + sum {both_ms:.4f} ms (plain "
        f"{both_plain:.4f}); one run of 10^7 rows: OR {ms2_or:.4f} ms, OR + sum {ms2:.4f} ms; "
        f"sector floor {rec['floor_ms']:.4f} ms; library ({rec['library']}) {rec['library_ms']}")
    rows.append(rec)
    return rows


def rising_read(l: int, p: int):
    """A read of l bases whose p-mers are distinct (a prefix of a de Bruijn
    sequence of order p; l - p + 1 <= 4^p) and a (4^p,) score table ranking
    them in read order, every other p-mer last: scored forward, its scores
    rise, so the scanner rescans its window every step."""
    a, seq = [0] * (p + 1), []

    def db(t, q):  # the Lyndon-word construction, stopped once long enough
        if len(seq) >= l:
            return
        if t > p:
            if p % q == 0:
                seq.extend(a[1 : q + 1])
            return
        a[t] = a[t - q]
        db(t + 1, q)
        for j in range(a[t - q] + 1, 4):
            a[t] = j
            db(t + 1, t)

    db(1, 1)
    read = np.array(seq[:l], np.int64)
    ranks = np.zeros(l - p + 1, np.int64)
    for j in range(p):
        ranks = (ranks << 2) | read[j : j + l - p + 1]
    check(len(np.unique(ranks)) == len(ranks), f"a de Bruijn prefix repeated a {p}-mer")
    perm = np.full(4**p, 1 << 30, np.int32)
    perm[ranks] = np.arange(len(ranks), dtype=np.int32)
    return read.astype(np.uint8), perm


def sorted_obs_rows(gen, n: int, lens, device) -> torch.Tensor:
    """(n, 4) int32 packed observation rows (W = 2, K = 31) whose keys come
    in runs of ``lens`` (cut at n): a multiplicative hash of the run number
    and a random word, so neighbouring runs differ; random exts bytes and
    labels."""
    run = torch.repeat_interleave(torch.arange(lens.shape[0], device=device), lens)[:n]
    check(run.shape[0] == n, "run lengths cover fewer rows than asked")
    rows = torch.randint(-(1 << 31), 1 << 31, (n, 4), generator=gen, dtype=torch.int32,
                         device=device)
    rows[:, 0] = ((run * 2654435761) & 0xFFFFFFFF).to(torch.int32)
    word = torch.randint(-(1 << 31), 1 << 31, (lens.shape[0],), generator=gen,
                         dtype=torch.int32, device=device)
    rows[:, 1] = word[run]
    rows[:, 2] &= 0xFF
    return rows


def phase_fused_kernels(gen, n_reads: int, n_obs: int, device) -> list:
    """The one-pass forms of the scan kernels, each against its plain
    version (exact) at the main path's shapes: run_reduce_rows on the quick
    start's count ((n_obs, 4) sorted rows in runs of ~24, label "first", and
    "min" and "sum" checked) beside torch.unique_consecutive on the key, and
    on skewed runs (one of 10^7 rows, all rows distinct, runs of a tile +- 1,
    one past 65535 rows), into a separate output and in place;
    msp_scan_reads at one phase 9 source block (k = 31, p = 8) and on poly-A
    reads, rising scores, p = 16 and the inverse-frequency table."""
    from tpu_debruijn_torch import msp as TM
    from tpu_debruijn_torch.kernels import (
        msp_scan_reads, msp_scan_reads_plain, run_reduce_rows, run_reduce_rows_plain,
    )

    rows = []
    # run_reduce_rows: the count's tail at the quick start's shape
    w = 2
    # runs of 1-47 rows, ~24 on average (30x), enough of them to cover n_obs
    lens = torch.randint(1, 48, (n_obs // 20,), generator=gen, device=device)
    srows = sorted_obs_rows(gen, n_obs, lens, device)
    out = torch.empty_like(srows)
    into = lambda op="first", x=srows: run_reduce_rows(x, w, label_op=op, out=out)
    plain = lambda op="first", x=srows: run_reduce_rows_plain(x, w, label_op=op, out=out)
    errs = [exact_err(f"run_reduce_rows {op}", lambda: (into(op).clone(),),
                      lambda: (plain(op).clone(),)) for op in ("first", "min", "sum")]
    want = plain().clone()
    u = want.shape[0]
    inplace = run_reduce_rows(srows.clone(), w)
    errs.append(max_abs_diff([inplace], [want]))
    check(errs[-1] == 0, "run_reduce_rows in place != plain")
    del inplace
    key = srows[:, :2].contiguous().view(torch.int64).flatten()
    rec = kernel_row("run_reduce_rows", "run_reduce.cu", "tpu_debruijn/sorting.py:316",
                     into, plain, max(errs), f"({n_obs}, 4) int32 sorted rows, {u} runs",
                     nbytes(srows) + nbytes(want) + 4,
                     library=lambda: torch.unique_consecutive(key, return_counts=True))
    rec["library"] = "torch.unique_consecutive(return_counts=True) on the int64 key: heads and counts only"
    # the kernel alone: the call also zeroes the tiles' status and reads the
    # number of runs back
    rec["device_ms"] = device_ms(into, "run_reduce_rows_kernel")
    del key
    skewed = {}
    for name, sk in (("one run of 10^7 rows", None), ("all rows distinct", "ones"),
                     ("runs of a tile +- 1", "tile"), ("a run of 70,000 rows", "long")):
        if sk == "ones":
            sl = torch.ones(n_obs, dtype=torch.int64, device=device)
        elif sk == "tile":
            sl = torch.tensor([2047, 2048, 2049], device=device).repeat(n_obs // 2047 // 3 + 1)
        else:
            sl = torch.randint(1, 48, (n_obs // 20,), generator=gen, device=device)
            sl[sl.shape[0] // 4] = 10**7 if sk is None else 70_000
        x = sorted_obs_rows(gen, n_obs, sl, device)
        e = exact_err(f"run_reduce_rows {name}", lambda: (into(x=x).clone(),),
                      lambda: (plain(x=x).clone(),))
        skewed[name] = {"max_abs_err": e, "runs": int(into(x=x).shape[0]),
                        "ms": min(time_ms(lambda: into(x=x)) for _ in range(2))}
        if sk == "long":
            check(int(into(x=x)[:, w].max()) >> 8 == 65535, "a run past 65535 rows did not saturate")
        del x
    rec.update(max_abs_err=max([rec["max_abs_err"]] + [v["max_abs_err"] for v in skewed.values()]),
               skewed=skewed, label_ops_checked=["first", "min", "sum"],
               replaces_also="tpu_debruijn/filter.py:1195 and count_kmers' run bounds, counts, head gathers")
    log(f"phase 2: run_reduce_rows {rec['ms']:.4f} ms, " + json.dumps(skewed))
    rows.append(rec)
    del srows, out, want, into, plain
    torch.cuda.empty_cache()

    # msp_scan_reads: one phase 9 source block of random reads
    l = -(-READ_LEN // 16) * 16
    block = -(-n_reads // N_SHARDS)
    k, p = K, P_MSP
    bases = torch.randint(0, 4, (block, l), generator=gen, dtype=torch.uint8, device=device)
    lk = l - k + 1
    scan = lambda b=bases, pp=p, perm=None, rc=True: msp_scan_reads(b, k, pp, perm, rc)
    scan_plain = lambda b=bases, pp=p, perm=None, rc=True: msp_scan_reads_plain(b, k, pp, perm, rc)
    e = exact_err("msp_scan_reads", scan, scan_plain)
    rec = kernel_row("msp_scan_reads", "msp_scan.cu", "tpu_debruijn/msp.py:145",
                     scan, scan_plain, e, f"({block}, {l}) uint8 bases, k = {k}, p = {p}",
                     nbytes(bases) + block * lk * (1 + 4 + 4))
    rec["device_ms"] = device_ms(scan, "msp_scan_reads_kernel")
    read, rising = rising_read(l, p)
    sample = bases[:PERM_SAMPLE].cpu().numpy()
    inv = torch.from_numpy(TM.inverse_frequency_score_table(p, sample)).to(device)
    cases = {
        "all-equal scores (poly-A reads)": dict(b=torch.zeros_like(bases)),
        "rising scores (a rescan every step)": dict(
            b=torch.from_numpy(read).to(device).expand(block, l).contiguous(),
            perm=torch.from_numpy(rising).to(device), rc=False),
        "p = 16": dict(pp=16),
        "inverse-frequency table": dict(perm=inv),
    }
    skewed = {}
    for name, kw in cases.items():
        e2, ms2, plain2 = timed_exact(f"msp_scan_reads {name}", lambda: scan(**kw),
                                      lambda: scan_plain(**kw))
        skewed[name] = {"max_abs_err": e2, "ms": ms2, "plain_ms": plain2}
    rec.update(max_abs_err=max([e] + [v["max_abs_err"] for v in skewed.values()]), skewed=skewed,
               library=None, library_none="no PyTorch call runs a scan recurrence",
               replaces_also="tpu_debruijn/msp.py:114-126 (p-mer ranks and scores)")
    log(f"phase 2: msp_scan_reads {rec['ms']:.4f} ms, " + json.dumps(skewed))
    rows.append(rec)
    return rows


def gather_line(what, table, idx) -> dict:
    """gather_rows against its plain version (exact) and index_select on one
    table and index; its kernel row, with the bytes-once bound and, beside
    it, the floor of a random gather: a whole 32-byte sector read per row of
    up to 32 bytes, plus the index and output streams."""
    from tpu_debruijn_torch.kernels import gather_rows, gather_rows_plain

    got = gather_rows(table, idx)
    e = max_abs_diff((got,), (gather_rows_plain(table, idx),))
    check(e == 0, f"{what}: kernel != plain (max abs err {e})")
    check(torch.equal(torch.index_select(table, 0, idx), got), f"{what}: index_select differs")
    del got
    n, row = idx.shape[0], table[0].numel() * table.element_size()
    shape = f"({table.shape[0]}, {table.shape[1]}) int32 table, {n} {str(idx.dtype)[6:]} indices"
    rec = kernel_row("gather_rows", "gather.cu", "scripts/probe_pallas_gather.py:80",
                     lambda: gather_rows(table, idx), lambda: gather_rows_plain(table, idx),
                     e, shape, n * row + nbytes(idx) + n * row,
                     library=lambda: torch.index_select(table, 0, idx))
    sector_bytes = n * 32 * -(-row // 32) + nbytes(idx) + n * row
    rec["random_floor_ms"] = sector_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: {what}: {rec['ms'] / rec['random_floor_ms']:.2f}x the random-gather floor of "
        f"{rec['random_floor_ms']:.4f} ms ({sector_bytes} bytes: a 32-byte sector per row read), "
        f"{rec['ms'] / rec['bound_ms']:.2f}x the bytes-once bound; {n / rec['ms'] / 1e6:.2f} G rows/s")
    return rec


def device_ms(fn, kernel: str, reps: int = 10) -> float:
    """Device time (ms) of ``kernel`` per call of ``fn``, under
    torch.profiler over ``reps`` calls after a warm-up; a trace with no
    event of ``kernel`` is taken again, up to three in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a trace loses every device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU and kernel in e.key)
        if us > 0:
            break
    check(us > 0, f"no device time for {kernel} under the profiler in three traces")
    return us / 1e3 / reps


def latency_floor_ms(m: int, rounds: int, barrier: bool) -> float:
    """Device ms of csrc/pointer_jump.cu's latency_floor_kernel on
    rank_loop's grid for m rows: ``rounds`` dependent L2 loads per thread,
    each followed by rank_loop's grid barrier when ``barrier``."""
    import ctypes

    from tpu_debruijn_torch.kernels import _build

    fn = _build.library().function("tdb_latency_floor", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    chain = torch.zeros(1, dtype=torch.int32, device="cuda")
    state = torch.empty(rounds + 1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    return device_ms(lambda: _build.check("tdb_latency_floor", fn(
        chain.data_ptr(), m, rounds, int(barrier), state.data_ptr(), stream)),
        "latency_floor_kernel")


def walk_row(succ, hops: int = 18) -> dict:
    """successor_walk against the plain walk at the probe's shape, with its
    device time under the profiler and its latency floor: ``hops``
    dependent L2 loads, one L2 load's latency measured with
    latency_floor_kernel on one block (a chain of 8192 loads)."""
    from tpu_debruijn_torch.kernels import successor_walk, successor_walk_plain

    long = 8192
    l2_load = (latency_floor_ms(1, long, False) - latency_floor_ms(1, 0, False)) / long
    e = max_abs_diff((successor_walk(succ, hops),), (successor_walk_plain(succ, hops),))
    check(e == 0, f"successor_walk: kernel != plain (max abs err {e})")
    row = kernel_row("successor_walk", "pointer_jump.cu", "scripts/probe_pallas_gather.py:90",
                     lambda: successor_walk(succ, hops), lambda: successor_walk_plain(succ, hops),
                     e, f"({succ.shape[0]},) int32, {hops} hops", 2 * nbytes(succ))
    row.update(device_ms=device_ms(lambda: successor_walk(succ, hops), "successor_walk_kernel"),
               floor_ms=hops * l2_load)
    log(f"phase 2: successor_walk device {row['device_ms']:.4f} ms, latency floor "
        f"{row['floor_ms']:.4f} ms ({hops} dependent L2 loads of {l2_load * 1e6:.1f} ns), "
        f"bytes-once bound {row['bound_ms']:.4f} ms; the one PyTorch call: none, no one "
        "call walks successors")
    return row


def rank_loop_ruler_level(gen, x, device, label: str = "phase 2", profiled: bool = True) -> dict:
    """rank_loop at the shape rank_lists gives it on the carry ``x``: the
    ruler level, one row per ruler (the carry's terminal states and its
    states whose hash picks them at the wrapper's spacing), linked at
    random into as many lists as the carry has, with the early exit.  With
    ``profiled``, its device time under torch.profiler and its latency
    floor: as many rounds of one dependent L2 load and one grid barrier,
    on the same grid."""
    from tpu_debruijn_torch.kernels import pointer_jump as PJ

    n = x.shape[0]
    live = x[:, 0] >= 0
    nr = int((~live | PJ.hashed_ruler(torch.arange(n, device=device), PJ.RULER_SPACING)).sum())
    n_lists = int((~live).sum())
    s = successor_forest(gen, nr, nr / n_lists, device)
    y = torch.stack([s, s >= 0, torch.randint(0, 1 << 30, (nr,), generator=gen, device=device),
                     torch.where(s < 0, torch.arange(nr, device=device), -1)], dim=1).to(torch.int32)
    full = PJ._full_rounds(nr)
    got, ran = PJ.rank_loop(y, full)
    want, t = PJ.rank_loop_plain(y, full)
    e = max_abs_diff((got,), (want,))
    check(e == 0, f"{label}: rank_loop at the ruler level: kernel != plain (max abs err {e})")
    check(int(ran) == t, f"{label}: rank_loop ran {int(ran)} rounds, the plain loop {t}")
    row = kernel_row("rank_loop", "pointer_jump.cu", "tpu_debruijn/compress.py:297",
                     lambda: PJ.rank_loop(y, full), lambda: PJ.rank_loop_plain(y, full),
                     e, f"({nr}, 4) int32 in {n_lists} lists, the ruler level of the carry at "
                     f"spacing {PJ.RULER_SPACING}", 2 * nbytes(y))
    row.update(rounds=t, grid=PJ.rank_loop_grid(nr))
    if profiled:
        row.update(device_ms=device_ms(lambda: PJ.rank_loop(y, full), "rank_loop_kernel"),
                   floor_ms=latency_floor_ms(nr, t, True))
        log(f"{label}: rank_loop at the ruler level: {t} rounds of {full} in one launch of "
            f"{row['grid']} blocks; device {row['device_ms']:.4f} ms, latency floor "
            f"{row['floor_ms']:.4f} ms ({t} dependent L2 loads and grid barriers)")
    return row


def host_launch_costs(tab2, idx_rows, rows64, calls: int = 1000) -> None:
    """Host time per call (us) of take_along_axis and torch.gather, each
    over ``calls`` launches with no synchronize in between, in turns; of the
    bare ctypes call into the kernel's entry point with no element (it
    returns before any launch); and of two ways to get the current stream's
    pointer (the port uses the public one)."""
    from tpu_debruijn_torch.kernels import _build, take_along_axis
    from tpu_debruijn_torch.kernels.gather import _ARGTYPES

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    dev = tab2.device
    entry = _build.library().function("tdb_take_along_axis", _ARGTYPES)
    out, stream = torch.empty_like(tab2), torch.cuda.current_stream(dev).cuda_stream
    fns = {
        "take_along_axis": lambda: take_along_axis(tab2, idx_rows, 0),
        "ctypes call, no element": lambda: _build.check("tdb_take_along_axis", entry(
            tab2.data_ptr(), idx_rows.data_ptr(), 0, tab2.shape[1], 0, 0, out.data_ptr(), stream)),
        "torch.gather": lambda: torch.gather(tab2, 0, rows64),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    }
    us = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        us[name].append(per_call(fns[name]))
    log(f"phase 2: host us per call over {calls} unsynchronised calls: " + json.dumps(us))


def phase_ranking(gen, x, device) -> int:
    """The whole ranking: the ruling-set kernels against the plain doubling
    loop, on the main carry, a list forest and an input with cycles.  Exact
    on every state whose path ends; on cycle states succ >= 0 and the
    cycle's minimum, all that the callers read there
    (tpu_debruijn/compress.py:243-245).  Lane for lane against the
    kernels' step-for-step transcription on the CPU at 2^20 states.
    The round path forced by an in-tree made from the main carry: one
    rank_loop launch, exact against the plain loop.  Times the ruling set
    (and its ruler spacings) against the doubling loop it replaced (one
    rank_loop launch) and the plain loop, on the main carry."""
    from tpu_debruijn_torch.kernels import pointer_jump as PJ

    def contract(what, got, want):
        res = want[:, 0] < 0
        check(torch.equal(got[res], want[res]), f"{what}: resolved states differ")
        check(bool((got[~res, 0] >= 0).all()), f"{what}: a cycle state resolved")
        check(torch.equal(got[~res, 2], want[~res, 2]), f"{what}: a cycle minimum differs")
        return int((~res).sum())

    round_path = PJ.rank_lists.round_path
    full = PJ._full_rounds(x.shape[0])
    rounds_loop = lambda: PJ.rank_loop(x, full)[0]
    want = PJ.rank_lists_plain(x)
    contract("rank_lists main carry", PJ.rank_lists(x), want)
    before = PJ.rank_loop.launches
    check(torch.equal(rounds_loop(), want), "the rank_loop loop != the plain loop")
    check(PJ.rank_loop.launches == before + 1, "the doubling loop took more than one launch")
    log(f"phase 2: ranking of the main carry bit-exact against the plain loop; "
        f"one rank_loop launch runs {int(PJ.rank_loop.last_rounds)} rounds of {full}")
    for cyclic in (False, True):
        s = successor_forest(gen, 1 << 20, 300, device, cyclic)
        xs = torch.stack([s, s >= 0, torch.randint(0, 1 << 30, s.shape, generator=gen, device=device),
                          torch.where(s < 0, torch.arange(s.shape[0], device=device), -1)],
                         dim=1).to(torch.int32)
        got = PJ.rank_lists(xs).cpu()
        n_cyc = contract(f"rank_lists cyclic={cyclic}", got, PJ.rank_lists_plain(xs).cpu())
        check(xs.device.type != "cuda" or torch.equal(got, PJ.rank_lists_rulers_plain(xs.cpu())),
              f"rank_lists cyclic={cyclic}: != its transcription")
        log(f"phase 2: rank_lists over 2^20 states (cyclic={cyclic}, {n_cyc} cycle states) "
            "meets the contract and equals its transcription lane for lane")
    check(PJ.rank_lists.round_path == round_path, "rank_lists took the round path")
    # the round path: a state with two predecessors
    xin = x.clone()
    live = torch.nonzero(xin[:, 0] >= 0).flatten()
    xin[live[1], 0] = xin[live[0], 0]
    loops = PJ.rank_loop.launches
    check(torch.equal(PJ.rank_lists(xin), PJ.rank_lists_plain(xin)), "the round path != the plain loop")
    check(PJ.rank_lists.round_path == round_path + 1 and PJ.rank_loop.launches == loops + 1,
          "the in-tree did not take the round path in one rank_loop launch")
    log(f"phase 2: an in-tree of the main carry takes the round path: one rank_loop launch, "
        f"{int(PJ.rank_loop.last_rounds)} rounds, exact against the plain loop")
    ms = {f"rank_lists s={sp}": min(time_ms(lambda: PJ.rank_lists(x, sp)) for _ in range(2))
          for sp in (16, 32, 64)}
    ms["rank_loop, one launch"] = min(time_ms(rounds_loop) for _ in range(2))
    ms["rank_lists round path (in-tree)"] = min(time_ms(lambda: PJ.rank_lists(xin)) for _ in range(2))
    ms["plain loop"] = time_ms(lambda: PJ.rank_lists_plain(x), iters=2)
    log("phase 2: whole ranking of the main carry (ms): " + json.dumps(ms))
    log("phase 2: rank_loop on the main carry, device ms under the profiler: "
        f"{device_ms(rounds_loop, 'rank_loop_kernel', reps=3):.4f}")
    del xin
    prof = profile_device_ms(lambda: PJ.rank_lists(x), top=8)
    log("phase 2: rank_lists on the main carry under the profiler: " + json.dumps(prof))
    return 0


# ---------------------------------------------------------------------------
# phases 3-5: the quick start and its checks
# ---------------------------------------------------------------------------


def quick_start(fastq: str, device, out_gfa: str):
    """The README quick start on the port; returns (reads, table, nodes,
    graph, stage seconds, gather_rows launches of the count and compress
    stages)."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch.kernels import gather_rows

    sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" else (lambda: None)
    t = [time.perf_counter()]
    g = [gather_rows.launches]
    reads = T.read_fastq(fastq)
    t.append(time.perf_counter())
    table = T.filter_kmers([(r, 0, 0) for r in reads], k=K, stranded=False, min_obs=2, device=device)
    sync()
    t.append(time.perf_counter())
    g.append(gather_rows.launches)
    nodes = T.compress_kmers(table, device=device)
    sync()
    t.append(time.perf_counter())
    g.append(gather_rows.launches)
    graph = T.from_compress_output(K, False, nodes).finish(device=device)
    graph.to_gfa(out_gfa)
    t.append(time.perf_counter())
    stages = dict(zip(("read", "count", "compress", "graph_gfa"), np.diff(t).tolist()))
    return reads, table, nodes, graph, stages, dict(zip(("count", "compress"), np.diff(g).tolist()))


def unitig_kmers(spec, nodes, device) -> torch.Tensor:
    """Canonical kmers of every unitig, concatenated, as (N, W) int64."""
    return seq_kmers(spec, np.concatenate([s for s, _, _ in nodes]),
                     np.array([len(s) for s, _, _ in nodes], np.int64), device)


def seq_kmers(spec, flat: np.ndarray, lens, device, starts=None) -> torch.Tensor:
    """Canonical kmers of the sequences of ``flat`` (lengths ``lens``, each
    at least K, at ``starts`` or packed), in order, as (N, W) int64."""
    from tpu_debruijn_torch import kmer as KM

    lens = np.asarray(lens, np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]) if starts is None else np.asarray(starts)
    nk = lens - spec.k + 1
    first = np.concatenate([[0], np.cumsum(nk)[:-1]])
    starts = torch.from_numpy(np.arange(int(nk.sum())) + np.repeat(offs - first, nk)).to(device)
    flat = torch.from_numpy(np.asarray(flat, np.int64)).to(device)
    nb_low = spec.k - 16 * (spec.w - 1)
    limbs = []
    for j in range(spec.w):
        c0 = 0 if j == 0 else nb_low + 16 * (j - 1)
        acc = torch.zeros_like(starts)
        for t in range(c0, c0 + (nb_low if j == 0 else 16)):
            acc = (acc << 2) | flat[starts + t]
        limbs.append(acc)
    km, _ = KM.min_rc_flip(spec, torch.stack(limbs, dim=1))
    return km


def check_assembly(table, nodes, graph, gfa_path: str, genome=None) -> None:
    from tpu_debruijn_torch import sorting as S

    spec = table.spec
    check(len(nodes) == len(graph) >= 1, "graph has no nodes")
    for t in (table.kmers, table.exts, table.counts, table.data):
        check(t.device.type == "cuda", "table tensor is not on the card")
    # every table kmer lies in exactly one unitig: the unitigs' canonical
    # kmers, sorted, are the table's sorted unique kmers
    ukm = unitig_kmers(spec, nodes, table.kmers.device)
    check(ukm.shape[0] == len(table), f"unitigs hold {ukm.shape[0]} kmers, the table {len(table)}")
    check(torch.equal(ukm[S.lex_argsort(ukm)], table.kmers), "unitig kmers != table kmers")
    if genome is not None:
        g = _LUT[genome].tobytes()
        grc = _LUT[(3 - genome)[::-1]].tobytes()
        for seq, _, _ in nodes:
            s = _LUT[seq].tobytes()
            check(s in g or s in grc, "a unitig is not a substring of the genome")
    with open(gfa_path, "rb") as f:
        gfa = f.read()
    check(gfa.count(b"\nS\t") == len(graph), "GFA S lines != graph nodes")


def phase_assembly(name, rng, genome, tmp, check_substrings: bool):
    """The quick start on a read set of ``genome``, written to
    ``tmp/{name}.fq``; returns (info, reads, unitigs, table).  gather_rows
    must launch in the count and compress stages."""
    reads = sample_reads(rng, genome, COVERAGE, READ_LEN)
    n_obs = len(reads) * (READ_LEN - K + 1)
    fq = os.path.join(tmp, f"{name}.fq")
    write_fastq(fq, reads)
    torch.cuda.reset_peak_memory_stats()
    reads_in, table, nodes, graph, stages, gathers = quick_start(
        fq, "cuda", os.path.join(tmp, f"{name}.gfa"))
    peak = torch.cuda.max_memory_allocated()
    check_assembly(table, nodes, graph, os.path.join(tmp, f"{name}.gfa"),
                   genome if check_substrings else None)
    for stage, launched in gathers.items():
        check(launched > 0, f"the {stage} stage never launched gather_rows")
    info = {
        "genome_bp": len(genome), "reads": len(reads), "read_len": READ_LEN,
        "coverage": COVERAGE, "k": K, "observations": n_obs, "table_kmers": len(table),
        "unitigs": len(nodes), "stage_s": stages, "total_s": sum(stages.values()),
        "count_obs_per_s": n_obs / stages["count"], "peak_device_bytes": peak,
        "gather_rows_launches": gathers,
    }
    return info, reads_in, nodes, table


def resolve_edges_gathers(table) -> int:
    """gather_rows launches of one resolve_edges call on ``table``."""
    from tpu_debruijn_torch.compress import resolve_edges
    from tpu_debruijn_torch.kernels import gather_rows

    before = gather_rows.launches
    resolve_edges(table.spec, table.stranded, table.kmers, table.exts)
    launched = gather_rows.launches - before
    check(launched > 0, "resolve_edges never launched gather_rows")
    return launched


def profile_device_ms(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: the card's busy time and
    the kernels that took most of it (ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: an op's self device time repeats its kernels'
    ops = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[1])
    return {"busy": sum(o[1] for o in ops), "dtoh": sum(o[1] for o in ops if "DtoH" in o[0]),
            "htod": sum(o[1] for o in ops if "HtoD" in o[0]), "top": ops[:top]}


def assembly_forms(table) -> dict:
    """compress_kmers' default policy on ``table`` in its two forms: the
    chain labels pulled to the host and assembled there
    (compress.assemble_chains), and the sequences assembled on the card
    (compress.compress_kmers_flat_device)."""
    from tpu_debruijn_torch import compress as C

    def host():
        chains, u_exts, contrib = C.compress_kmer_table_device(
            table.spec, table.stranded, table.kmers, table.exts)
        return C.assemble_chains(table.spec, table.kmers, chains, u_exts, contrib, table.counts)

    def device():
        seq, lengths, u_exts, data = C.compress_kmers_flat_device(table, device=table.kmers.device)
        return C._nodes(seq, lengths, u_exts, data.tolist())

    return {"host": host, "device": device}


def compare_assembly(table, what: str) -> dict:
    """Host against device assembly of one table: equal unitigs; host
    seconds of each form (in turns: host, device, device, host), the card's
    busy ms and its device-to-host copy ms under torch.profiler, and the
    bytes each form copies to the host."""
    from tpu_debruijn_torch import compress as C

    forms = assembly_forms(table)
    check(same_unitigs(forms["host"](), forms["device"]()),
          f"{what}: device assembly != host assembly")
    secs = {"host": [], "device": []}
    for name in ("host", "device", "device", "host"):
        t0 = time.perf_counter()
        forms[name]()
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    prof = {name: profile_device_ms(fn) for name, fn in forms.items()}
    chains, u_exts, contrib = C.compress_kmer_table_device(
        table.spec, table.stranded, table.kmers, table.exts)
    seq, lengths, data = C.assemble_unitigs_device(table.spec, table.kmers, chains, contrib,
                                                   table.counts)
    copied = {
        "host": nbytes(table.kmers, chains.uid, chains.pos, chains.length, chains.first_item,
                       chains.first_flip, u_exts, contrib, table.counts),
        "device": nbytes(seq, lengths, u_exts, data),
    }
    out = {"unitigs": chains.n_unitigs, "seconds": secs,
           "device_busy_ms": {n: p["busy"] for n, p in prof.items()},
           "dtoh_ms": {n: p["dtoh"] for n, p in prof.items()}, "dtoh_bytes": copied,
           "top_device": prof["device"]["top"]}
    log(f"{what}: host vs device assembly, equal unitigs: " + json.dumps(out))
    return out


def same_unitigs(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1:] == y[1:] for x, y in zip(a, b))


def same_chains(a, b) -> bool:
    per_item = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("uid", "pos", "flip"))
    per_unitig = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "length", "first_item", "last_item", "first_flip", "last_flip"))
    return per_item and a.n_unitigs == b.n_unitigs and per_unitig


def phase_ordered(reads, nodes_main, counters, device) -> dict:
    """The read-ordered path on the main path's reads: obs_min table ->
    ordered compress -> unitigs.  Kernel launches are counted over this run
    alone; the plain linker then runs on the same table for comparison.
    Each linker's rounds are the device count of its one rank_loop launch."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import compress as C

    rank_loop = counters["rank_loop"]
    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0
    torch.cuda.reset_peak_memory_stats()
    t = [time.perf_counter()]
    table = T.filter_kmers([(r, 0, 0) for r in reads], k=K, stranded=False, min_obs=2,
                           data_reduce="obs_min", device=device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    chains, u_exts, contrib, overflow = C.compress_kmer_table_device(
        table.spec, False, table.kmers, table.exts, first_pos=table.data
    )
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    nodes = C.assemble_chains(table.spec, table.kmers, chains, u_exts, contrib, table.counts)
    t.append(time.perf_counter())
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path
    peak = torch.cuda.max_memory_allocated()
    rounds_ordered = int(rank_loop.last_rounds)

    check(not overflow, "the ordered linker overflowed its interval cap")
    before = rank_loop.launches
    plain = C.compress_kmer_table_device(table.spec, False, table.kmers, table.exts)
    check(rank_loop.launches == before + 1, "the plain linker's ranking took more than one rank_loop")
    rounds_plain = int(rank_loop.last_rounds)
    check(same_chains(chains, plain[0]), "ordered chains != plain link_chains chains")
    check(same_unitigs(nodes, nodes_main), "ordered-path unitigs != the quick start's")
    edges = C.resolve_edges(table.spec, False, table.kmers, table.exts)
    n_iv = int(C.discovery_intervals(edges["partner_l"], edges["partner_r"], table.data)[-1].sum())
    n = len(table)
    # the linker called in the JAX package's positional form, without and
    # with an all-valid mask, gives the compress route's chains
    args = [edges[f] for f in ("partner_l", "partner_r", "in_l", "in_r")]
    for valid in (None, torch.ones(n, dtype=torch.bool, device=device)):
        direct, over = C.link_chains_ordered(*args, valid, table.data, max(1 << 14, n // 8))
        check(not over and same_chains(direct, chains),
              f"link_chains_ordered(valid={'mask' if valid is not None else None}) != the ordered chains")
    del args, direct

    # the compress stage of both linkers, in turns: plain, ordered, ordered, plain
    linkers = {
        "plain": lambda: C.compress_kmer_table_device(table.spec, False, table.kmers, table.exts),
        "ordered": lambda: C.compress_kmer_table_device(
            table.spec, False, table.kmers, table.exts, first_pos=table.data),
    }
    compress_s = {"plain": [], "ordered": []}
    for name in ("plain", "ordered", "ordered", "plain"):
        t0 = time.perf_counter()
        linkers[name]()
        torch.cuda.synchronize()
        compress_s[name].append(time.perf_counter() - t0)
    device_ms = {name: profile_device_ms(fn) for name, fn in linkers.items()}
    return {
        "table_kmers": n, "unitigs": len(nodes), "intervals": n_iv, "intervals_per_kmer": n_iv / n,
        "rounds_ordered": rounds_ordered, "rounds_plain": rounds_plain,
        "compress_s_first_ordered": t[2] - t[1], "compress_s_ordered": compress_s["ordered"],
        "compress_s_plain": compress_s["plain"], "compress_device_ms": device_ms,
        "stage_s": dict(zip(("count_obs_min", "compress_ordered", "assemble"), np.diff(t).tolist())),
        "peak_device_bytes": peak, "launches": launches,
    }


def phase_device_vs_cpu(rng, tmp, seed: int) -> None:
    from tpu_debruijn_torch import table_to_numpy

    genome = make_genome(rng, 20_000, repeat_rich=True)
    fq = os.path.join(tmp, "small.fq")
    write_fastq(fq, sample_reads(rng, genome, 15, READ_LEN))
    out = {}
    for dev in ("cuda", "cpu"):
        gfa = os.path.join(tmp, f"small_{dev}.gfa")
        _, table, nodes, graph, _, _ = quick_start(fq, dev, gfa)
        with open(gfa, "rb") as f:
            out[dev] = (table_to_numpy(table), nodes, f.read())
    (tc, nc, gc), (tp, np_, gp) = out["cuda"], out["cpu"]
    check(tc.keys() == tp.keys() and all(np.array_equal(tc[x], tp[x]) for x in tc),
          "CUDA and CPU tables differ")
    check(same_unitigs(nc, np_), "CUDA and CPU unitigs differ")
    check(gc == gp, "CUDA and CPU GFA bytes differ")
    log(f"phase 6: CUDA == CPU on {len(tc['kmers'])} kmers, {len(nc)} unitigs, {len(gc)} GFA bytes")

    # the colored streaming count: four colors, one of them negative (it
    # sorts last within its kmer, as a uint32)
    import tpu_debruijn_torch as T

    reads = [(r, 0, (i % 4) - 1) for i, r in enumerate(T.read_fastq(fq))]
    got = {}
    for dev in ("cuda", "cpu"):
        table, pair_label, split = T.filter_kmers_streaming(
            reads, K, min_obs=2, data_reduce="none", merge="device", colored=True,
            chunk_reads=256, device=dev)
        got[dev] = (table_to_numpy(table), pair_label.cpu().numpy(), split.cpu().numpy())
    (tc, lc, sc), (tp, lp, sp) = got["cuda"], got["cpu"]
    check(all(np.array_equal(tc[x], tp[x]) for x in tc), "colored: CUDA and CPU tables differ")
    check(np.array_equal(lc, lp) and np.array_equal(sc, sp), "colored: CUDA and CPU pairs differ")
    check(len(tc["kmers"]) > 0 and (lc == -1).any(), "colored: no kmer or no negative color")
    log(f"phase 6: colored streaming CUDA == CPU on {len(tc['kmers'])} kmers, {len(lc)} pairs")

    got = {dev: policy_outputs(reads, K, dev, os.path.join(tmp, f"colored_{dev}.gfa"))
           for dev in ("cuda", "cpu")}
    for name, want in got["cpu"].items():
        check(same_outputs(got["cuda"][name], want), f"colored / policy path: CUDA and CPU {name} differ")
    log(f"phase 6: the colored / policy path CUDA == CPU: {sorted(got['cpu'])}; "
        f"{len(got['cpu']['set_arrays'][0])} kmers, {len(got['cpu']['color_sets join=False'][0])} "
        f"unitigs, {len(got['cpu']['gfa'])} GFA bytes")

    got = {dev: sharded_outputs([r for r, _, _ in reads], K, dev, tmp) for dev in ("cuda", "cpu")}
    for name, want in got["cpu"].items():
        check(got["cuda"][name] == want, f"sharded path: CUDA and CPU {name} differ")
    log("phase 6: the sharded path CUDA == CPU, GFA bytes: "
        + json.dumps({name: len(b) for name, b in got["cpu"].items()}))

    # the error-handling path on reads with sequencing errors
    erng = np.random.default_rng([seed, 6])  # leaves ``rng`` as the later phases draw it
    err_reads = sample_error_reads(erng, make_genome(erng, ERR_SMALL_LEN, False), COVERAGE,
                                   READ_LEN)[0]
    got = {dev: error_outputs(err_reads, K, dev, tmp) for dev in ("cuda", "cpu")}
    for name, want in got["cpu"].items():
        check(got["cuda"][name] == want, f"error path: CUDA and CPU {name} differ")
    log("phase 6: the error-handling path CUDA == CPU, GFA bytes: "
        + json.dumps({name: len(b) for name, b in got["cpu"].items()}))

    got = {dev: cli_outputs(fq, dev, tmp) for dev in ("cuda", "cpu")}
    check(same_files(got["cuda"], got["cpu"]),
          "the CLI, its walks or its checkpoints: CUDA and CPU differ")
    log(f"phase 6: the CLI CUDA == CPU: {len(got['cpu']['gfa'])} GFA and {len(got['cpu']['json'])} "
        f"JSON bytes, walks of {len(got['cpu']['max_path'])} and {len(got['cpu']['max_path_beam'])} "
        f"nodes, both checkpoints")


def flat_of(nodes):
    """A unitig list as from_flat_output's flat buffers."""
    return (np.concatenate([s for s, _, _ in nodes]).astype(np.uint8),
            np.array([len(s) for s, _, _ in nodes], np.int64),
            np.array([e for _, e, _ in nodes], np.int32), np.array([d for _, _, d in nodes], np.int32))


def union(a, b):
    return tuple(sorted(set(a) | set(b)))


def policy_outputs(reads, k: int, dev, gfa_path: str) -> dict:
    """Every entry point of the colored / policy path on ``dev`` for the
    labeled ``reads`` at ``k``, min_obs = 2: outputs as numpy arrays and
    Python objects, by entry point.  Phase 6 and the card tests
    (tests/test_torch_cuda.py) hold the CUDA outputs to the CPU ones."""
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import graph as G
    from tpu_debruijn_torch import table_to_numpy

    tab = lambda t: list(table_to_numpy(t).values())
    listed = lambda ns: [(s.tolist(), e, d) for s, e, d in ns]
    kw = dict(min_obs=2, device=dev)
    out = {}
    t, pl, sp = F.filter_kmers_set_arrays(reads, k, **kw)
    out["set_arrays"] = tab(t) + [pl.cpu().numpy(), sp.cpu().numpy()]
    sets = out["set"] = F.filter_kmers_set(reads, k, **kw)[1]
    te, classes = F.filter_kmers_eq_classes(reads, k, **kw)
    out["eq_classes"] = tab(te) + [classes]
    pk = torch.repeat_interleave(torch.arange(len(t), device=sp.device), torch.diff(sp))
    out["eq_classes_hashed"] = list(F.assign_eq_classes(pk, pl, len(t), dense_limit=0, device=dev))
    for join in (False, True):
        nodes, labels, split = C.compress_kmers_color_sets(t, pl, sp, join_on_sets=join, device=dev)
        out[f"color_sets join={join}"] = [listed(nodes), labels, split]
    G.from_flat_output(k, False, *flat_of(nodes)).finish(device=dev).to_gfa(gfa_path)
    with open(gfa_path, "rb") as f:
        out["gfa"] = f.read()
    out["rich"] = listed(C.compress_kmers_rich(
        t, sets, reduce=union, join_test=lambda a, b: abs(len(a) - len(b)) <= 1, device=dev))
    out["scmap"] = listed(C.compress_kmers(te, spec=C.ScmapCompress(), data_field="data", device=dev))
    for summarizer in (F.CountFilterSet(2), F.CountFilterEqClass(2)):
        ts, data = F.filter_kmers_with_summarizer(reads, k, summarizer, report_all=True, device=dev)
        out[type(summarizer).__name__] = tab(ts) + [data]
    table = F.filter_kmers(reads, k, report_all=True, **kw)
    out["policies"] = [listed(C.compress_kmers(table, spec=spec, data_field="data", device=dev))
                       for spec in (C.SimpleCompress("max"), C.SimpleCompress(min))]
    out["flat_device"] = list(C.compress_kmers_flat_device(table, device=dev))
    out["infer_exts"] = C.infer_exts_device(table.spec, False, table.kmers).cpu().numpy()
    out["no_exts"] = listed(C.compress_kmers_no_exts(k, table.kmers.flip(0), table.data.flip(0),
                                                     data_reduce="min", device=dev))
    for name, fn in (("censored", F.remove_censored_exts),
                     ("censored_sharded", F.remove_censored_exts_sharded)):
        tc = F.KmerTable(table.spec, False, table.kmers, table.exts.clone(), table.counts,
                         table.data, all_kmers=table.all_kmers)
        fn(tc, device=dev)
        out[name] = tc.exts.cpu().numpy()
    return out


def same_outputs(a, b) -> bool:
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_outputs(x, y) for x, y in zip(a, b))
    return a == b


def timed_blocks(blocks, decode_s: list, chunk_s: list):
    """Yield the items of ``blocks``, appending the seconds each took to
    make to ``decode_s`` and the seconds the consumer spent on each before
    asking for the next to ``chunk_s``."""
    it = iter(blocks)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        t1 = time.perf_counter()
        decode_s.append(t1 - t0)
        yield item
        chunk_s.append(time.perf_counter() - t1)


def concat_sort_merge(keys, exts, counts, c_keys, c_exts, c_counts):
    """merge_unique's result by the other form: concatenate both tables,
    sort, and reduce each run (counts summed and saturated, exts OR'd)."""
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import sorting as S
    from tpu_debruijn_torch.kernels import gather_rows, run_reduce

    keys = torch.cat([keys, c_keys])
    perm = S.lex_argsort(keys)
    keys = gather_rows(keys, perm)
    starts, ends = TF.run_bounds(S.run_starts(keys))
    exts, counts = run_reduce(ends, gather_rows(torch.cat([exts, c_exts]), perm),
                              gather_rows(torch.cat([counts, c_counts]), perm))
    return gather_rows(keys, starts), exts, counts.clamp(max=TF.COUNT_MAX).to(torch.int32)


def phase_corpus(fq: str, reads, table_main: dict, nodes_main, rich_reads, counters,
                 device="cuda") -> dict:
    """Phase 7: the corpus path on phase 3's FASTQ file and reads, against
    phase 3's table and unitigs; launches counted from (a) through (c)."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import table_to_numpy

    def same_table(table, want: dict) -> bool:
        got = table_to_numpy(table)
        return all(np.array_equal(got[x], want[x]) for x in ("kmers", "exts", "counts", "data"))

    n_reads = len(reads)
    chunk = -(-n_reads // 64)  # bench.py's corpus model: 64 count batches
    kw = dict(stranded=False, min_obs=2)
    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0

    # (a) FASTQ -> packed blocks -> the device merge, 64 chunks
    decode_s, chunk_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_a = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    table = T.filter_kmers_streaming(
        timed_blocks(T.stream_fastx_blocks(fq, block_reads=chunk), decode_s, chunk_s), K,
        data_reduce="none", merge="device", chunk_reads=chunk, device=device, **kw)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated()
    check(len(chunk_s) == 64, f"the device merge took {len(chunk_s)} chunks, not 64")
    check(same_table(table, table_main), "the streamed table (device merge) != phase 3's")
    n_obs = sum(len(r) - K + 1 for r in reads)
    out = {
        "reads": n_reads, "chunk_reads": chunk, "chunks": len(chunk_s), "observations": n_obs,
        "table_kmers": len(table),
        "device_merge": {
            "decode_s": sum(decode_s), "decode_s_first": decode_s[0],
            "count_merge_s": wall_a - sum(decode_s), "wall_s": wall_a,
            "chunk_s_median": float(np.median(chunk_s)), "chunk_s_max": max(chunk_s),
            "chunk_s_first": chunk_s[0], "count_merge_obs_per_s": n_obs / (wall_a - sum(decode_s)),
            "peak_device_bytes": peak_a, "peak_above_held_bytes": peak_a - held_a,
        },
    }
    log("phase 7 (a): device merge from the FASTQ file equals phase 3's table: "
        + json.dumps(out["device_merge"]))

    # (b) per-read tuples through the host merge, under a 1 GB budget: the
    # bytes it allocates above what is held when it starts ((a)'s table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    table_b = T.filter_kmers_streaming(((r, 0, 0) for r in reads), K, data_reduce="label_first",
                                       memory_gb=1, read_len_cap=READ_LEN, device=device, **kw)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    peak_b = torch.cuda.max_memory_allocated()
    chunk_b = int(1e9 / TF.count_bytes_per_read(TF.KmerSpec(K), READ_LEN))
    check(same_table(table_b, table_main), "the streamed table (host merge) != phase 3's")
    check(peak_b - held <= 1e9,
          f"the host merge's peak device memory {peak_b - held} above {held} exceeds memory_gb=1")
    out["host_merge"] = {"wall_s": wall_b, "chunk_reads": chunk_b, "chunks": -(-n_reads // chunk_b),
                         "peak_device_bytes": peak_b, "held_bytes": held,
                         "peak_above_held_bytes": peak_b - held,
                         "reckoned_peak_bytes": chunk_b * TF.count_bytes_per_read(TF.KmerSpec(K), READ_LEN)}
    del table_b
    log("phase 7 (b): host merge of per-read tuples under memory_gb=1 equals phase 3's table: "
        + json.dumps(out["host_merge"]))
    # (c) compress the streamed table
    t0 = time.perf_counter()
    nodes = T.compress_kmers(table, device=device)
    torch.cuda.synchronize()
    out["compress_s"] = time.perf_counter() - t0
    check(same_unitigs(nodes, nodes_main), "the streamed table's unitigs != phase 3's")
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path
    out["launches"] = launches
    del nodes
    log(f"phase 7 (c): the streamed table compresses to phase 3's {len(nodes_main)} unitigs "
        f"in {out['compress_s']:.3f} s; launches {json.dumps(launches)}")

    # count_bytes_per_read against count_kmers' own peak on a chunk of
    # random reads (every kmer distinct), the widths and modes (b) can take,
    # and count_kmer_pairs' (four labels) for the colored count
    gen = np.random.default_rng(0)
    out["count_peak_per_read"] = []
    for k_, dr in ((K, "label_first"), (K, "sum"), (63, "none"), (63, "sum"), (16, "sum"),
                   (K, "colored"), (63, "colored"), (16, "colored")):
        spec = TF.KmerSpec(k_)
        host = gen.integers(0, 4, (20_000, 160)).astype(np.uint8)
        labels = torch.from_numpy(gen.integers(0, 4, host.shape[0]).astype(np.int32)).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        z = torch.zeros(host.shape[0], dtype=torch.int32, device=device)
        bases = torch.from_numpy(host).to(device)
        if dr == "colored":
            TF.count_kmer_pairs(spec, bases, torch.full_like(z, READ_LEN), z, labels, stranded=False)
        else:
            TF.count_kmers(spec, bases, torch.full_like(z, READ_LEN), z, z, stranded=False,
                           min_obs=1, data_reduce=dr, report_all=False)
        del bases
        per_read = (torch.cuda.max_memory_allocated() - base) / host.shape[0]
        reckoned = TF.count_bytes_per_read(spec, READ_LEN, colored=dr == "colored")
        check(per_read <= reckoned, f"the count took {per_read} bytes a read at K={k_} {dr}, "
              f"count_bytes_per_read reckons {reckoned}")
        out["count_peak_per_read"].append({"k": k_, "data_reduce": dr, "bytes": per_read,
                                           "reckoned": reckoned})
    log("phase 7: the count's peak device bytes a read (150 bases) against "
        "count_bytes_per_read: " + json.dumps(out["count_peak_per_read"]))

    # where the host merge's time goes: the same run under cProfile
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(lambda: T.filter_kmers_streaming(
        ((r, 0, 0) for r in reads), K, data_reduce="label_first", memory_gb=1,
        read_len_cap=READ_LEN, device=device, **kw))
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    out["host_merge"]["cprofile_tottime_s"] = [
        [f"{os.path.basename(f)}:{line}:{name}", tt] for (f, line, name), (_, _, tt, _, _) in top]
    log("phase 7 (b): the host merge under cProfile, seconds by function: "
        + json.dumps(out["host_merge"]["cprofile_tottime_s"]))

    # the device time of the streamed count, its blocks decoded beforehand
    blocks = list(T.stream_fastx_blocks(fq, block_reads=chunk))
    stream = lambda: T.filter_kmers_streaming(iter(blocks), K, data_reduce="none",
                                              merge="device", chunk_reads=chunk, device=device, **kw)
    t0 = time.perf_counter()
    stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_device_ms(stream, top=10)
    out["device_merge"].update(count_merge_s_decoded=wall, device_busy_ms=prof["busy"],
                               idle_share=1 - prof["busy"] / 1e3 / wall)
    log(f"phase 7: the streamed count on decoded blocks: {wall:.3f} s, device busy "
        f"{prof['busy']:.2f} ms ({1 - prof['busy'] / 1e3 / wall:.1%} idle); top: "
        + json.dumps(prof["top"]))

    # the merge at the last merge's shape: the whole table and one chunk,
    # the join against concatenate-and-sort, in turns
    first = blocks[0]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    zeros = torch.zeros(first.packed.shape[0], dtype=torch.int32, device=device)
    c = TF.count_kmers(TF.KmerSpec(K), TF.unpack_2bit(dev(first.packed)), dev(first.lengths), zeros, zeros,
                       stranded=False, min_obs=1, data_reduce="none", report_all=False)
    state = (table.kmers, table.exts, table.counts)
    got = TF.merge_unique(*(t.clone() for t in state), c.kmers, c.exts, c.counts)
    want = concat_sort_merge(*state, c.kmers, c.exts, c.counts)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "the join != concatenate-and-sort")
    del got, want
    forms = {"join": lambda: TF.merge_unique(*state, c.kmers, c.exts, c.counts),
             "concat_sort": lambda: concat_sort_merge(*state, c.kmers, c.exts, c.counts)}
    merge_ms = {name: [] for name in forms}
    for name in ("concat_sort", "join", "join", "concat_sort"):
        merge_ms[name].append(time_ms(forms[name], iters=3))
    out["merge_ms"] = {"table": len(table), "chunk": len(c), **merge_ms,
                       "device": {name: profile_device_ms(fn)["busy"] for name, fn in forms.items()}}
    log("phase 7: one merge of a chunk into the whole table (ms): " + json.dumps(out["merge_ms"]))

    # one packed chunk's upload: pageable against a reused pinned buffer
    pinned = torch.empty(first.packed.shape, dtype=torch.uint8).pin_memory()
    host = np.ascontiguousarray(first.packed)

    def via_pinned():
        pinned.numpy()[:] = host
        return pinned.to(device, non_blocking=True)

    up = {"pageable": [], "pinned": []}
    for name, fn in (("pageable", lambda: dev(host)), ("pinned", via_pinned),
                     ("pinned", via_pinned), ("pageable", lambda: dev(host))):
        up[name].append(time_ms(fn, iters=20))
    out["upload_ms"] = {"bytes": host.nbytes, **up}
    log("phase 7: one packed chunk's upload (ms): " + json.dumps(out["upload_ms"]))
    del blocks, c, state, table

    # (d) the device merge at K = 63 on phase 5's repeat-rich reads
    k63 = 63
    t0 = time.perf_counter()
    streamed = T.filter_kmers_streaming(((r, 0, 0) for r in rich_reads), k63, data_reduce="none",
                                        merge="device", chunk_reads=-(-len(rich_reads) // 64),
                                        device=device, **kw)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    one = T.filter_kmers([(r, 0, 0) for r in rich_reads], k63, data_reduce="none", device=device, **kw)
    check(len(one) > 0 and same_table(streamed, table_to_numpy(one)),
          "the K = 63 device merge != one-batch filter_kmers")
    out["k63"] = {"reads": len(rich_reads), "table_kmers": len(one), "wall_s": wall_d}
    log(f"phase 7 (d): K = 63 device merge of {len(rich_reads)} repeat-rich reads in 64 chunks "
        f"equals one-batch filter_kmers ({len(one)} kmers) in {wall_d:.3f} s")
    return out


def make_strains(rng, genome: np.ndarray, n_strains: int, per_bp: int) -> list:
    """Strains of ``genome``, each with its own substitutions, one per
    ``per_bp`` bases: positions and new bases drawn from ``rng``."""
    strains = []
    for _ in range(n_strains):
        s = genome.copy()
        pos = rng.choice(len(genome), len(genome) // per_bp, replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        strains.append(s)
    return strains


def kmer_codes(g: torch.Tensor, k: int) -> torch.Tensor:
    """The 2k-bit code of every k-window of the base tensor ``g`` (k <= 31)."""
    m = g.shape[0] - k + 1
    code = torch.zeros(max(m, 0), dtype=torch.int64, device=g.device)
    for t in range(k):
        code = (code << 2) | g[t : t + m]
    return code


def unitigs_in_strains(nodes, strains, device) -> bool:
    """Whether every unitig, or its reverse complement, is a substring of
    one of ``strains``, on the card: its first kmer is looked up among each
    strain's sorted kmers (a random genome repeats no 31-mer, and a
    substitution moves no coordinate) and the whole unitig compared there."""
    seq = torch.from_numpy(np.concatenate([s for s, _, _ in nodes])).to(device).to(torch.int64)
    lens = torch.tensor([len(s) for s, _, _ in nodes], device=device)
    offs = torch.cumsum(lens, 0) - lens
    uid = torch.repeat_interleave(torch.arange(len(nodes), device=device), lens)
    j = torch.arange(seq.shape[0], device=device) - offs[uid]
    rc = 3 - seq[offs[uid] + lens[uid] - 1 - j]  # each unitig reverse-complemented in place
    ok = torch.zeros(len(nodes), dtype=torch.bool, device=device)
    for strain in strains:
        g = torch.from_numpy(strain).to(device).to(torch.int64)
        codes, order = torch.sort(kmer_codes(g, K))
        for s in (seq, rc):
            first = kmer_codes(s, K)[offs]
            idx = torch.searchsorted(codes, first).clamp(max=codes.shape[0] - 1)
            p = order[idx]
            fits = (codes[idx] == first) & (p + lens <= g.shape[0])
            at = (p[uid] + j).clamp(max=g.shape[0] - 1)
            wrong = torch.zeros(len(nodes), dtype=torch.int64, device=device).index_add_(
                0, uid, (g[at] != s).to(torch.int64))
            ok |= fits & (wrong == 0)
    return bool(ok.all())


def check_unitigs(what, table, nodes, strains) -> None:
    """Every table kmer in exactly one unitig, and every unitig a substring
    of a strain or of its reverse complement."""
    from tpu_debruijn_torch import sorting as S

    check(sum(len(s) - K + 1 for s, _, _ in nodes) == len(table), f"{what}: unitig kmers != table kmers")
    ukm = unitig_kmers(table.spec, nodes, table.kmers.device)
    check(torch.equal(ukm[S.lex_argsort(ukm)], table.kmers), f"{what}: unitig kmers != table kmers")
    check(unitigs_in_strains(nodes, strains, table.kmers.device),
          f"{what}: a unitig is in no strain")


def check_color_sets(what, table, nodes, labels, split, strains) -> None:
    """:func:`check_unitigs`, and every color set sorted (as uint32) and
    distinct."""
    check_unitigs(what, table, nodes, strains)
    nutg = len(nodes)
    check(len(split) == nutg + 1 and split[0] == 0 and split[-1] == len(labels)
          and (np.diff(split) >= 1).all(), f"{what}: color-set splits are malformed")
    lab = labels.astype(np.int64) & 0xFFFFFFFF
    same_unitig = np.repeat(np.arange(nutg), np.diff(split))
    inner = same_unitig[1:] == same_unitig[:-1]
    check((np.diff(lab)[inner] > 0).all(), f"{what}: a color set is not sorted and distinct")


def check_eq_classes(ids, classes, pair_label, split) -> None:
    """Equal ids exactly where the pair arrays give equal sets: each kmer's
    set is its class's, and no two classes share a set."""
    ids, pl, sp = (t.cpu().numpy() for t in (ids, pair_label, split))
    check(len(set(classes)) == len(classes), "two eq classes share a set")
    class_len = np.array([len(c) for c in classes], np.int64)
    class_off = np.concatenate([[0], np.cumsum(class_len)])
    flat = np.array([x for c in classes for x in c], np.int32)
    lens = np.diff(sp)
    check(np.array_equal(lens, class_len[ids]), "a kmer's set size differs from its eq class's")
    kmer_of_pair = np.repeat(np.arange(len(ids)), lens)
    within = np.arange(len(pl)) - sp[kmer_of_pair]
    check(np.array_equal(pl, flat[class_off[ids[kmer_of_pair]] + within]),
          "a kmer's set differs from its eq class's")


def popcount8(x: torch.Tensor) -> int:
    return int(sum(((x >> b) & 1).sum() for b in range(8)))


def strain_reads(rng, genome):
    """Phase 8's input: the strains of ``genome``, their reads (n, READ_LEN)
    in strain order and each read's strain label."""
    strains = make_strains(rng, genome, N_STRAINS, SNP_EVERY)
    reads = np.concatenate([sample_reads(rng, s, STRAIN_COVERAGE, READ_LEN) for s in strains])
    labels = np.repeat(np.arange(N_STRAINS, dtype=np.int32), len(reads) // N_STRAINS)
    return strains, reads, labels


def phase_colored(strains, reads, labels, rich_reads, counters, smi: str, device="cuda") -> dict:
    """Phase 8: the colored path at full width on four strains of phase 3's
    genome (:func:`strain_reads`); launches counted from the set count
    through both color-set compressions (path "colored")."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import table_to_numpy

    t_phase = time.perf_counter()
    genome_len = len(strains[0])
    items = [(r, 0, int(lab)) for r, lab in zip(reads, labels)]
    kw = dict(stranded=False, min_obs=2)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    table, pair_label, split = timed("count", lambda: F.filter_kmers_set_arrays(
        items, K, device=device, **kw))
    res = {join: timed(f"color_sets_join_{join}", lambda: C.compress_kmers_color_sets(
        table, pair_label, split, join_on_sets=join, device=device)) for join in (False, True)}
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path
    peak = torch.cuda.max_memory_allocated()
    n = len(table)
    out = {"strains": N_STRAINS, "substitutions_per_strain": genome_len // SNP_EVERY,
           "coverage_per_strain": STRAIN_COVERAGE, "reads": len(reads),
           "observations": len(reads) * (READ_LEN - K + 1), "table_kmers": n,
           "pairs": int(pair_label.shape[0]), "peak_device_bytes": peak}
    log(f"phase 8: counted {len(reads)} reads of {N_STRAINS} strains to {n} kmers and "
        f"{out['pairs']} (kmer, color) pairs in {secs['count']:.3f} s; peak {peak} bytes")

    for join, (nodes, labs, spl) in res.items():
        check_color_sets(f"color sets join_on_sets={join}", table, nodes, labs, spl, strains)
        out[f"unitigs_join_{join}"] = len(nodes)
        out[f"color_set_pairs_join_{join}"] = len(labs)
    out["compress_device_ms"] = profile_device_ms(lambda: C.compress_kmers_color_sets(
        table, pair_label, split, device=device))

    streamed = timed("streaming_64_chunks", lambda: T.filter_kmers_streaming(
        [(reads, 0, labels)], K, data_reduce="none", merge="device", colored=True,
        chunk_reads=29_011, device=device, **kw))
    want = table_to_numpy(table)
    got = table_to_numpy(streamed[0])
    check(all(np.array_equal(got[f], want[f]) for f in want)
          and torch.equal(streamed[1], pair_label) and torch.equal(streamed[2], split),
          "filter_kmers_set_arrays != filter_kmers_streaming(colored=True)")
    del streamed

    eq_table, classes = timed("eq_classes", lambda: F.filter_kmers_eq_classes(
        items, K, device=device, **kw))
    got = table_to_numpy(eq_table)
    check(all(np.array_equal(got[f], want[f]) for f in ("kmers", "exts", "counts")),
          "the eq-class table != the set table")
    check_eq_classes(eq_table.data, classes, pair_label, split)
    out["eq_classes"] = len(classes)
    # the grouping alone, in both forms (the hashed one forced by dense_limit=0)
    pk = torch.repeat_interleave(torch.arange(n, device=split.device), torch.diff(split))
    for form, limit in (("dense", F.DENSE_LIMIT), ("hashed", 0)):
        ids, cls = timed(f"assign_eq_classes_{form}", lambda: F.assign_eq_classes(
            pk, pair_label, n, dense_limit=limit, device=device))
        check(np.array_equal(ids, eq_table.data.cpu().numpy()) and cls == classes,
              f"assign_eq_classes ({form}) != filter_kmers_eq_classes")
    del pk, ids, cls
    scmap = timed("compress_scmap", lambda: T.compress_kmers(
        eq_table, spec=T.ScmapCompress(), data_field="data", device=device))
    check(same_unitigs(res[True][0], scmap),
          "color sets with join_on_sets != compress_kmers(ScmapCompress) of the eq-class table")
    del eq_table, scmap, res

    out["assembly"] = compare_assembly(table, "phase 8")
    no_exts = timed("compress_no_exts", lambda: T.compress_kmers_no_exts(
        K, table.kmers, device=device))
    check_unitigs("compress_kmers_no_exts", table, no_exts, strains)
    out["unitigs_no_exts"] = len(no_exts)
    del no_exts

    censored = F.KmerTable(table.spec, False, table.kmers, table.exts.clone(), table.counts, table.data)
    timed("remove_censored_exts", lambda: F.remove_censored_exts(censored, device=device))
    present = C.infer_exts_device(table.spec, False, table.kmers)
    check(bool(((censored.exts & ~present) == 0).all()), "an extension still points at a missing kmer")
    out["censored_ext_bits"] = popcount8(table.exts) - popcount8(censored.exts)
    del censored, present, items, table, pair_label, split
    torch.cuda.empty_cache()

    out["small"] = colored_small(rich_reads[:SMALL_READS], device)
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"phase 8 (colored path, {smi}): " + json.dumps({k: v for k, v in out.items()
                                                         if k != "launches"}))
    return out


def colored_small(rich_reads, device) -> dict:
    """The per-kmer and per-edge Python forms on phase 5's repeat-rich reads
    with four labels, against the array forms on the same reads:
    compress_kmers_rich with a union closure equals compress_kmers_color_sets
    (unitigs and sets), with a non-equality join test it covers every kmer
    once in no fewer unitigs; the three summarizers equal filter_kmers and
    the set and eq-class filters."""
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import table_to_numpy

    reads = [(r, 0, i % 4) for i, r in enumerate(rich_reads)]
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    table, sets = F.filter_kmers_set(reads, K, min_obs=2, device=device)
    t2, pl, sp = F.filter_kmers_set_arrays(reads, K, min_obs=2, device=device)
    nodes, labels, split = C.compress_kmers_color_sets(t2, pl, sp, device=device)
    rich = timed("rich_union", lambda: C.compress_kmers_rich(table, sets, reduce=union, device=device))
    check([(s.tolist(), e, tuple(labels[split[u] : split[u + 1]].tolist()))
           for u, (s, e, _) in enumerate(nodes)] == [(s.tolist(), e, d) for s, e, d in rich],
          "compress_kmers_rich (union) != compress_kmers_color_sets")
    near = timed("rich_join_test", lambda: C.compress_kmers_rich(
        table, sets, reduce=union, join_test=lambda a, b: abs(len(a) - len(b)) <= 1, device=device))
    check(sum(len(s) - K + 1 for s, _, _ in near) == len(table) and len(near) >= len(rich),
          "compress_kmers_rich with a join test lost or repeated a kmer")
    plain = table_to_numpy(F.filter_kmers(reads, K, min_obs=2, device=device))
    t, data = timed("summarizer_count", lambda: F.filter_kmers_with_summarizer(
        reads, K, F.CountFilter(2), device=device))
    got = table_to_numpy(t)
    check(all(np.array_equal(got[f], plain[f]) for f in ("kmers", "exts", "counts"))
          and data == plain["counts"].tolist(), "CountFilter != filter_kmers")
    _, data = timed("summarizer_set", lambda: F.filter_kmers_with_summarizer(
        reads, K, F.CountFilterSet(2), device=device))
    check(data == sets, "CountFilterSet != filter_kmers_set")
    eq = F.CountFilterEqClass(2)
    _, ids = timed("summarizer_eq_class", lambda: F.filter_kmers_with_summarizer(
        reads, K, eq, device=device))
    inv = {v: key for key, v in eq.eq_classes.items()}
    check([inv[i] for i in ids] == sets, "CountFilterEqClass ids disagree with the label sets")
    out = {"reads": len(reads), "table_kmers": len(table), "unitigs": len(nodes),
           "unitigs_join_test": len(near), "seconds": secs}
    log("phase 8 (small): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the MSP-sharded path
# ---------------------------------------------------------------------------

P_MSP = 8  # the README's minimizer length
N_SHARDS = 8
PERM_SAMPLE = 20_000  # reads the balancing score table is drawn from


def gfa_of(graph, path: str) -> bytes:
    graph.to_gfa(path)
    with open(path, "rb") as f:
        return f.read()


def node_rows(graph) -> list:
    """A graph's nodes as sorted (canonical sequence bytes, exts of that
    orientation, data) rows: what test_collective_stitch_equals_host_path
    compares."""
    from tpu_debruijn_torch import exts as E

    seqs = graph.base.sequences
    flat, starts, lens = seqs._flat(), seqs.start, seqs.length
    out = []
    for i in range(len(graph)):
        b = flat[starts[i] : starts[i] + lens[i]]
        fwd, rev, e = b.tobytes(), (3 - b[::-1]).astype(np.uint8).tobytes(), int(graph.exts[i])
        out.append((rev, E.rc(e), int(graph.data[i])) if rev < fwd else (fwd, e, int(graph.data[i])))
    return sorted(out)


def ordered_rows(graph) -> list:
    return [(graph.base.sequences.get_bases(i).tobytes(), int(graph.exts[i]), int(graph.data[i]))
            for i in range(len(graph))]


def canon_seqs(nodes) -> list:
    """Unitigs [(bases, exts, data)] as sorted canonical sequence bytes."""
    return canon_set(*flat_of(nodes)[:2]) if nodes else []


def canon_set(flat: np.ndarray, lens, starts=None) -> list:
    """The sequences of ``flat`` (lengths ``lens``, at ``starts`` or packed)
    as sorted canonical bytes, each the lesser of itself and its reverse
    complement, which is a slice of the whole buffer's."""
    flat = np.ascontiguousarray(flat, np.uint8)
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens) if starts is None else np.asarray(starts, np.int64) + lens
    fwd, rev, n = flat.tobytes(), (3 - flat[::-1]).tobytes(), flat.shape[0]
    return sorted(min(fwd[e - m : e], rev[n - e : n - e + m])
                  for e, m in zip(ends.tolist(), lens.tolist()))


def graph_canon(graph) -> list:
    seqs = graph.base.sequences
    return canon_set(seqs._flat(), seqs.length, seqs.start)


def check_shard_tables(what: str, tables, want: dict) -> int:
    """The union of the shard tables against one-batch ``want`` (numpy, from
    table_to_numpy): kmers and counts bit for bit, so no kmer lies in two
    shards; exts bit for bit but where a shard dropped an extension onto a
    kmer censored in its own census (min_obs > 1), and then a subset of the
    one-batch exts.  Returns the kmers whose exts differ."""
    from tpu_debruijn_torch import kmer as KM
    from tpu_debruijn_torch import sorting as S

    km = torch.cat([t.kmers for t in tables])
    order = S.lex_argsort(km)
    km = km[order]
    ex = torch.cat([t.exts for t in tables])[order].cpu().numpy()
    cn = torch.cat([t.counts for t in tables])[order].cpu().numpy()
    check(km.shape[0] == len(want["kmers"]), f"{what}: the shards hold {km.shape[0]} kmers, "
          f"the one-batch table {len(want['kmers'])}")
    check(np.array_equal(KM.to_numpy(km), want["kmers"]) and np.array_equal(cn, want["counts"]),
          f"{what}: the union of the shard tables != the one-batch table")
    check(not (ex & ~want["exts"]).any(), f"{what}: a shard table has an extension the "
          "one-batch table lacks")
    return int((ex != want["exts"]).sum())


def stage_summary(stats: dict) -> dict:
    """Seconds by stage (sum and max over the shards for the per-shard
    ones) and the intervals a shard."""
    out = {}
    for key, v in stats.items():
        if key == "intervals":
            out["intervals"] = {"total": sum(v), "max": max(v), "mean": sum(v) / len(v),
                                "by_shard": v}
        elif len(v) > 1:
            out[key] = {"sum": sum(v), "max": max(v)}
        else:
            out[key] = v[0]
    return out


def sharded_outputs(reads, k: int, dev, tmp: str) -> dict:
    """The sharded path's entry points on ``dev`` for ``reads`` at ``k``
    (p = 8, 8 shards, min_obs = 2), as GFA bytes: assemble_sharded with both
    stitches, compress_graph of the combined shard graphs with three nodes
    censored, and clean_tips.  Phase 6 and the card tests hold the CUDA
    bytes to the CPU ones."""
    from tpu_debruijn_torch import clean as CL
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import graph as G
    from tpu_debruijn_torch import parallel as TP

    mesh = TP.make_mesh(N_SHARDS, device=dev)
    path = os.path.join(tmp, f"sharded_{torch.device(dev).type}.gfa")
    out, graphs = {}, {}
    for coll in (True, False):
        graphs[coll] = TP.assemble_sharded(reads, k, P_MSP, min_obs=2, mesh=mesh, collective=coll,
                                           device=dev)
        out[f"assemble_sharded collective={coll}"] = gfa_of(graphs[coll], path)
    _, tables, chains, u_exts, contrib = TP.sharded_tables(reads, k, P_MSP, min_obs=2, mesh=mesh,
                                                           device=dev)
    combined = G.BaseGraph(k, False)
    for table, ch, ue, cb in zip(tables, chains, u_exts, contrib):
        if ch.n_unitigs:
            seq, lengths = C.assemble_unitigs_device(table.spec, table.kmers, ch, cb)
            combined.add_flat(seq.cpu().numpy(), lengths.cpu().numpy(), ue.cpu().numpy())
    out["compress_graph"] = gfa_of(G.compress_graph(combined.finish(device=dev),
                                                    censor_nodes=[0, 2, 5], device=dev), path)
    out["clean_tips"] = gfa_of(CL.clean_tips(graphs[True], lambda n: n.len() < 2 * k, device=dev),
                               path)
    return out


def rich_sharded(rich_reads, mesh, device) -> dict:
    """Phase 9 on phase 5's repeat-rich reads at min_obs = 1: shard tables
    == the one-batch table, collective == host stitch, unitigs == the
    one-batch unitigs; then clean_tips leaves a compressed graph."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import clean as CL
    from tpu_debruijn_torch import graph as G
    from tpu_debruijn_torch import parallel as TP
    from tpu_debruijn_torch import table_to_numpy

    kw = dict(stranded=False, min_obs=1, mesh=mesh, device=device)
    table = T.filter_kmers([(r, 0, 0) for r in rich_reads], K, min_obs=1, device=device)
    nodes = T.compress_kmers(table, device=device)
    stats = {}
    _, tables, *_ = TP.sharded_tables(rich_reads, K, P_MSP, stats=stats, **kw)
    differ = check_shard_tables("phase 9 repeat-rich", tables, table_to_numpy(table))
    check(differ == 0, "phase 9 repeat-rich: exts differ at min_obs = 1")
    del tables
    t0 = time.perf_counter()
    graph = TP.assemble_sharded(rich_reads, K, P_MSP, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rows = node_rows(graph)
    check(rows == node_rows(TP.assemble_sharded(rich_reads, K, P_MSP, collective=False, **kw)),
          "phase 9 repeat-rich: the collective and host stitches differ")
    check([r[0] for r in rows] == canon_seqs(nodes),
          "phase 9 repeat-rich: sharded unitigs != one-batch unitigs")
    n_before = len(graph)
    cleaned = CL.clean_tips(graph, lambda n: n.len() < 2 * K, device=device)
    check(ordered_rows(G.compress_graph(cleaned, device=device)) == ordered_rows(cleaned),
          "phase 9 repeat-rich: clean_tips left a graph that compresses further")
    return {"reads": len(rich_reads), "table_kmers": len(table), "unitigs": len(nodes),
            "intervals": stage_summary(stats)["intervals"], "assemble_sharded_s": secs,
            "nodes_after_clean_tips": len(cleaned), "nodes_before": n_before}


def phase_sharded(reads, table_main: dict, nodes_main, peak_main: int, rich_reads, counters,
                  smi: str, gfa_path: str, device="cuda") -> dict:
    """Phase 9: the MSP-sharded path at full width, phase 3's reads over 8
    logical shards (k = 31, p = 8, min_obs = 2); launches counted over one
    assemble_sharded call with the device stitch (path "sharded"), whose
    graph is written to ``gfa_path`` for phase 11."""
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import msp as TM
    from tpu_debruijn_torch import parallel as TP

    t_phase = time.perf_counter()
    mesh = TP.make_mesh(N_SHARDS, device=device)
    kw = dict(stranded=False, min_obs=2, mesh=mesh, device=device)

    def timed(fn, stats=None):
        t0 = time.perf_counter()
        out = fn(stats)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    graph, total_s = timed(lambda st: TP.assemble_sharded(reads, K, P_MSP, stats=st, **kw), stats)
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path
    peak = torch.cuda.max_memory_allocated()
    out = {"reads": len(reads), "k": K, "p": P_MSP, "shards": N_SHARDS, "min_obs": 2,
           "nodes": len(graph), "assemble_sharded_s": total_s, "stages": stage_summary(stats),
           "peak_device_bytes": peak, "peak_device_bytes_quick_start": peak_main}
    rows = node_rows(graph)
    check([r[0] for r in rows] == canon_seqs(nodes_main), "phase 9: sharded unitigs != phase 3's")
    graph.to_gfa(gfa_path)
    stats_h = {}
    host, out["assemble_sharded_host_stitch_s"] = timed(
        lambda st: TP.assemble_sharded(reads, K, P_MSP, collective=False, stats=st, **kw), stats_h)
    out["stages_host_stitch"] = stage_summary(stats_h)
    check(node_rows(host) == rows, "phase 9: the collective and host stitches differ")
    del host
    (_, tables, *_), out["sharded_tables_s"] = timed(
        lambda st: TP.sharded_tables(reads, K, P_MSP, **kw))
    out["exts_differ_from_one_batch"] = check_shard_tables("phase 9", tables, table_main)
    del tables
    log("phase 9: shard tables == phase 3's table, collective == host stitch, unitigs == "
        f"phase 3's; {json.dumps(out)}")
    out["assemble_sharded_device"] = profile_device_ms(
        lambda: TP.assemble_sharded(reads, K, P_MSP, **kw), top=8)

    sample, sample_len = F.pad_reads(reads[:PERM_SAMPLE], min_len=K, pad_to=16)
    perm = TM.inverse_frequency_score_table(P_MSP, sample, sample_len)
    stats_p = {}
    g_perm, out["assemble_sharded_permutation_s"] = timed(
        lambda st: TP.assemble_sharded(reads, K, P_MSP, permutation=perm, stats=st, **kw), stats_p)
    out["intervals_permutation"] = stage_summary(stats_p)["intervals"]
    check(node_rows(g_perm) == rows, "phase 9: the permutation changed the graph")
    del g_perm, graph
    torch.cuda.empty_cache()

    out["repeat_rich"] = rich_sharded(rich_reads, mesh, device)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"phase 9 (sharded path, {smi}): " + json.dumps({k: v for k, v in out.items()
                                                        if k != "launches"}))
    return out


# ---------------------------------------------------------------------------
# phase 10: the command line and the graph API at full size
# ---------------------------------------------------------------------------

BEAM = 4
LOOKUPS = 10_000  # get_key_id / get / get_key calls on table kmers
ITER_SAMPLE = 1_000  # kmers whose hamming_neighbors are held to one_hamming_iter
HD1_CHUNK = 1 << 17  # kmers a hamming_neighbors chunk: (2^17, 4K, W) int64 candidates


def path_ok(graph, path) -> bool:
    """Node ids unique, and each step an edge of find_edges: leaving (v,
    entered by side d) by side 1 - d onto w, entered by its side e."""
    return len({v for v, _ in path}) == len(path) and all(
        any(t == w and side == e for t, side, _ in graph.find_edges(v, 1 - d))
        for (v, d), (w, e) in zip(path, path[1:]))


def kmers_in_table(table, bases: np.ndarray) -> bool:
    """Every kmer of ``bases``, canonicalized, is a row of ``table``: one
    search on the table's device."""
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import kmer as KM
    from tpu_debruijn_torch import sorting as S

    spec, dev = table.spec, table.kmers.device
    km = KM.to_torch(KM.kmers_from_bytes(spec, bases), dev)
    canon, _, _ = F.canonicalize(spec, km, torch.zeros(km.shape[0], dtype=torch.int32, device=dev),
                                 stranded=False)
    return bool(S.searchsorted_limbs(table.kmers, canon)[1].all())


def against_genome(seq, genome: np.ndarray, device) -> dict:
    """Where a walk's sequence lies on ``genome``: the orientation in which
    more of its kmers are genome kmers, the start its first such kmer
    implies and, where the whole sequence fits there, its Hamming distance
    to that stretch (DnaSeq.hamming_distance)."""
    from tpu_debruijn_torch.dna import DnaSeq

    codes, order = torch.sort(kmer_codes(torch.from_numpy(genome).to(device).to(torch.int64), K))
    best = None
    for orient, s in (("forward", seq), ("reverse_complement", seq.rc())):
        q = kmer_codes(torch.from_numpy(s.bases()).to(device).to(torch.int64), K)
        idx = torch.searchsorted(codes, q).clamp(max=codes.shape[0] - 1)
        hit = codes[idx] == q
        n_hit = int(hit.sum())
        if best is None or n_hit > best["kmers_in_genome"]:
            first = int(torch.nonzero(hit)[0]) if n_hit else 0
            best = {"orientation": orient, "kmers_in_genome": n_hit, "kmers": int(q.shape[0]),
                    "start": int(order[idx[first]]) - first if n_hit else None, "seq": s}
    s, start = best.pop("seq"), best["start"]
    fits = start is not None and 0 <= start and start + len(s) <= len(genome)
    best["hamming_distance"] = (s.hamming_distance(DnaSeq.from_bases(genome[start : start + len(s)]))
                                if fits else None)
    return best


def walks(graph, table, genome, device) -> dict:
    """max_path and max_path_beam(BEAM) on ``graph`` with the data as the
    score and no solid node: each path checked by :func:`path_ok` and its
    sequence's kmers looked up in ``table``; seconds, nodes, bases and the
    sequence against ``genome``."""
    out = {}
    for name, fn in (("max_path", lambda: graph.max_path(lambda d: float(d), lambda d: False)),
                     (f"max_path_beam_{BEAM}",
                      lambda: graph.max_path_beam(BEAM, lambda d: float(d), lambda d: False))):
        t0 = time.perf_counter()
        path = fn()
        secs = time.perf_counter() - t0
        seq = graph.sequence_of_path(path)
        check(path_ok(graph, path), f"{name}: a repeated node or a step on no edge")
        check(kmers_in_table(table, seq.bases()), f"{name}: a kmer of its sequence is not in the table")
        out[name] = {"s": secs, "nodes": len(path), "bases": len(seq), "genome_bp": len(genome),
                     **against_genome(seq, genome, device)}
    return out


def dangling(graph) -> np.ndarray:
    """(n, 2) extension bits of each node side that lead to no node: onto
    kmers the count dropped (``min_obs``)."""
    from tpu_debruijn_torch import exts as E

    edges = np.array([[len(graph.find_edges(i, d)) for d in (0, 1)] for i in range(len(graph))])
    return np.stack([E.num_ext_dir(graph.exts, d) for d in (0, 1)], axis=1) - edges.reshape(-1, 2)


def compressed_check(graph, device) -> dict:
    """is_compressed on the CLI's graph.  compress_kmers never joins a node
    side with two extensions, one of them onto a kmer ``min_obs`` dropped;
    is_compressed counts only the extensions that reach a node, so it may
    return such a pair (the JAX package's does too).  Any pair returned must
    have a side with such a dangling extension, and compress_graph (which
    drops them first) must leave a graph where is_compressed finds none."""
    from tpu_debruijn_torch import graph as G

    t0 = time.perf_counter()
    pair = graph.is_compressed()
    out = {"s": time.perf_counter() - t0, "pair": None if pair is None else list(pair)}
    extra = dangling(graph)
    out["sides_with_dangling_extensions"] = int((extra > 0).sum())
    if pair is not None:
        check(bool((extra[list(pair)] > 0).any()),
              f"is_compressed() found {pair}, a pair with no dangling extension")
        again = G.compress_graph(G.BaseGraph.combine([graph.base]).finish(device=device), device=device)
        check(again.is_compressed() is None, "is_compressed() found a pair after compress_graph")
        out["nodes_after_compress_graph"] = len(again)
    return out


def one_node_per_kmer(table, device):
    """A graph of one node a table kmer (exts and counts from the table)."""
    from tpu_debruijn_torch import graph as G
    from tpu_debruijn_torch import kmer as KM

    g = G.BaseGraph(table.spec.k, table.stranded)
    n = len(table)
    g.add_flat(KM.to_bases_batch_np(table.spec, KM.to_numpy(table.kmers)).reshape(-1),
               np.full(n, table.spec.k), table.exts.cpu().numpy(), table.counts.cpu().numpy())
    return g.finish(device=device)


def npz_arrays(path) -> dict:
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def checkpoints(graph, table, rich_reads, tmp: str, device) -> dict:
    """Round trips: the graph (GFA bytes), compress_kmers_rich's graph with
    its int-tuple sidecar and with a pickled one, and the table back onto
    ``device`` bit for bit; file bytes and seconds."""
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import graph as G

    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t0
        return res

    path = os.path.join(tmp, "graph.npz")
    timed("graph_save", lambda: graph.save(path))
    loaded = timed("graph_load", lambda: G.DebruijnGraph.load(path, device=device))
    out["graph_bytes"] = os.path.getsize(path)
    check(gfa_of(loaded, os.path.join(tmp, "loaded.gfa")) == gfa_of(graph, os.path.join(tmp, "g.gfa")),
          "the graph's save/load changed its GFA bytes")
    reads = [(r, 0, i % N_STRAINS) for i, r in enumerate(rich_reads[:SMALL_READS])]
    small, sets = F.filter_kmers_set(reads, K, min_obs=2, device=device)
    nodes = C.compress_kmers_rich(small, sets, reduce=union, device=device)
    ints = [d for _, _, d in nodes]
    for form, rich in (("int_tuples", ints), ("pickled", [tuple(f"strain{c}" for c in r)
                                                          for r in ints])):
        base = G.BaseGraph(K, False)
        base.add_flat(np.concatenate([s for s, _, _ in nodes]), [len(s) for s, _, _ in nodes],
                      [e for _, e, _ in nodes], rich=rich)
        g = base.finish(device=device)
        p = os.path.join(tmp, f"rich_{form}.npz")
        g.save(p)
        back = G.DebruijnGraph.load(p, device=device)
        check(back.rich == rich and gfa_of(back, p + ".gfa") == gfa_of(g, p + ".want.gfa"),
              f"the {form} rich sidecar did not round-trip")
        check(("rich_flat" if form == "int_tuples" else "rich_pickle") in npz_arrays(p),
              f"the {form} sidecar was saved in the wrong form")
        out[f"rich_{form}_nodes"] = len(g)
        out[f"rich_{form}_bytes"] = os.path.getsize(p)
    path = os.path.join(tmp, "table.npz")
    timed("table_save", lambda: table.save(path))
    back = timed("table_load", lambda: F.KmerTable.load(path, device=device))
    out["table_bytes"] = os.path.getsize(path)
    check(back.kmers.device == table.kmers.device and all(
        torch.equal(getattr(back, f), getattr(table, f)) for f in ("kmers", "exts", "counts", "data"))
          and (back.spec, back.stranded) == (table.spec, table.stranded),
          "the table's save/load changed it")
    return out


def lookups_and_helpers(table, seed: int) -> dict:
    """KmerTable lookups and the kmer helpers over the whole table on its
    device: get_key_id / get / get_key on sampled rows, at + gc == K,
    hamming_dist(a, a) == 0, hamming_neighbors in chunks (3K candidates a
    kmer; one_hamming_iter's order on a sample) and the count of kmers with
    an HD-1 neighbour in the table."""
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch import kmer as KM
    from tpu_debruijn_torch import sorting as S
    from tpu_debruijn_torch.neighbors import one_hamming_iter

    spec, dev, n = table.spec, table.kmers.device, len(table)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)
    out = {}
    rows = rng.choice(n, min(LOOKUPS, n), replace=False)
    kms = KM.to_numpy(table.kmers[torch.from_numpy(rows).to(dev)])
    exts, data = table.exts.cpu().numpy(), table.data.cpu().numpy()
    t0 = time.perf_counter()
    for row, km in zip(rows.tolist(), kms):
        check(table.get_key_id(km) == row and table.get(km) == (int(exts[row]), int(data[row]))
              and np.array_equal(table.get_key(row), km), f"lookup of table row {row} failed")
    out["lookups"] = len(rows)
    out["lookup_us_per_call"] = (time.perf_counter() - t0) / len(rows) * 1e6
    t0 = time.perf_counter()
    check(bool((KM.at_count(spec, table.kmers) + KM.gc_count(spec, table.kmers) == spec.k).all()),
          "at_count + gc_count != K")
    check(not bool(KM.hamming_dist(spec, table.kmers, table.kmers).any()), "hamming_dist(a, a) != 0")
    sync()
    out["counts_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with_neighbour = 0
    for lo in range(0, n, HD1_CHUNK):
        cands, mask = KM.hamming_neighbors(spec, table.kmers[lo : lo + HD1_CHUNK])
        check(bool((mask.sum(1) == 3 * spec.k).all()), "hamming_neighbors: not 3K candidates a kmer")
        flat = cands[mask]
        canon, _, _ = F.canonicalize(spec, flat, torch.zeros(flat.shape[0], dtype=torch.int32,
                                                             device=dev), stranded=False)
        found = S.searchsorted_limbs(table.kmers, canon)[1]
        with_neighbour += int(found.view(-1, 3 * spec.k).any(1).sum())
    sync()
    out["hd1_s"] = time.perf_counter() - t0
    out["kmers_with_hd1_neighbour"] = with_neighbour
    sample = rows[:ITER_SAMPLE]
    cands, mask = KM.hamming_neighbors(spec, table.kmers[torch.from_numpy(sample).to(dev)])
    cands, mask = KM.to_numpy(cands), mask.cpu().numpy()
    for i in range(len(sample)):
        want = np.stack(list(one_hamming_iter(spec, kms[i])))
        check(np.array_equal(cands[i][mask[i]], want), "hamming_neighbors != one_hamming_iter")
    out["one_hamming_iter_checked"] = len(sample)
    return out


def cli_outputs(fq: str, dev, tmp: str) -> dict:
    """The command line's outputs on ``dev`` for the FASTQ file ``fq``: GFA
    and JSON bytes, both walks (paths), and the arrays of the graph's and of
    the table's checkpoints.  Phase 6 and the card tests hold the CUDA
    outputs to the CPU ones."""
    from tpu_debruijn_torch import assemble
    from tpu_debruijn_torch import filter as F
    from tpu_debruijn_torch.io import read_fastq

    name = torch.device(dev).type
    gfa, js, gnpz, tnpz = (os.path.join(tmp, f"cli_{name}.{ext}") for ext in ("gfa", "json", "g.npz",
                                                                            "t.npz"))
    graph = assemble.run([fq, "-o", gfa, "--json", js, "--device", str(dev)])
    graph.save(gnpz)
    F.filter_kmers([(r, 0, 0) for r in read_fastq(fq)], K, min_obs=2, device=dev).save(tnpz)
    out = {}
    for key, path in (("gfa", gfa), ("json", js)):
        with open(path, "rb") as f:
            out[key] = f.read()
    out["max_path"] = graph.max_path(lambda d: float(d), lambda d: False)
    out["max_path_beam"] = graph.max_path_beam(BEAM, lambda d: float(d), lambda d: False)
    out["graph_npz"] = npz_arrays(gnpz)
    out["table_npz"] = npz_arrays(tnpz)
    return out


def same_files(a, b) -> bool:
    """Equal outputs of :func:`cli_outputs`: bytes, paths, npz arrays
    (dtypes included)."""
    return a.keys() == b.keys() and all(
        same_outputs(list(a[key].values()), list(b[key].values())) and a[key].keys() == b[key].keys()
        if isinstance(b[key], dict) else a[key] == b[key] for key in b)


def phase_cli(genome, strains, reads, rich_reads, counters, smi: str, tmp: str, seed: int,
              device="cuda") -> dict:
    """Phase 10: the command line on phase 8's four-strain reads written to
    a FASTQ file (k = 31, min_obs = 2, unstranded), launches counted over
    that run (path "cli"); then the graph API on its graph and table."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import assemble
    from tpu_debruijn_torch import graph as G

    t_phase = time.perf_counter()
    fq = os.path.join(tmp, "strains.fq")
    t0 = time.perf_counter()
    write_fastq(fq, reads)
    out = {"reads": len(reads), "write_fastq_s": time.perf_counter() - t0}
    gfa, js = os.path.join(tmp, "cli.gfa"), os.path.join(tmp, "cli.json")
    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    graph = assemble.run([fq, "-o", gfa, "--json", js, "--device", device], stats=stats)
    out["run_s"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["stage_s"] = {key[:-2]: v[0] for key, v in stats.items()}
    out["nodes"] = len(graph)
    with open(gfa, "rb") as f:
        gfa_bytes = f.read()
    with open(js, "rb") as f:
        json_bytes = f.read()
    out["gfa_bytes"], out["json_bytes"] = len(gfa_bytes), len(json_bytes)
    parsed = json.loads(json_bytes)
    check(len(parsed["nodes"]) == len(graph) and [n["id"] for n in parsed["nodes"]]
          == [str(i) for i in range(len(graph))], "the CLI's JSON does not hold one node a unitig")
    out["json_links"] = len(parsed["links"])
    del parsed

    table = T.filter_kmers([(r, 0, 0) for r in reads], K, min_obs=2, device=device)
    want = T.from_compress_output(K, False, T.compress_kmers(table, device=device)).finish(device=device)
    check(gfa_of(want, os.path.join(tmp, "in_memory.gfa")) == gfa_bytes,
          "the CLI's GFA != filter_kmers -> compress_kmers -> to_gfa on the reads in memory")
    del want
    out["table_kmers"] = len(table)
    log(f"phase 10: the CLI on {len(reads)} reads: {len(graph)} unitigs, GFA == the in-memory "
        f"path's; {json.dumps(out)}")

    out["walks"] = walks(graph, table, genome, device)
    log("phase 10: walks " + json.dumps(out["walks"]))

    out["is_compressed"] = compressed_check(graph, device)
    rich_table = T.filter_kmers([(r, 0, 0) for r in rich_reads], K, min_obs=2, device=device)
    rich_nodes = T.compress_kmers(rich_table, device=device)
    per_kmer = one_node_per_kmer(rich_table, device)
    t0 = time.perf_counter()
    pair = per_kmer.is_compressed()
    out["is_compressed_per_kmer_s"] = time.perf_counter() - t0
    check(pair is not None, "is_compressed() found no pair on a one-node-per-kmer graph")
    recompressed = G.compress_graph(per_kmer, device=device)
    check([r[0] for r in node_rows(recompressed)] == canon_seqs(rich_nodes),
          "compress_graph of the one-node-per-kmer graph != phase 5's unitigs")
    out["is_compressed"].update({"per_kmer_nodes": len(per_kmer), "per_kmer_pair": list(pair),
                                 "per_kmer_recompressed_nodes": len(recompressed)})
    del per_kmer, recompressed, rich_table, rich_nodes

    exports = {}
    t0 = time.perf_counter()
    w = io.StringIO()
    graph.write_gfa(w)
    exports["write_gfa_s"] = time.perf_counter() - t0
    check(w.getvalue().encode() == gfa_bytes, "write_gfa != to_gfa")
    t0 = time.perf_counter()
    w = io.StringIO()
    graph.to_json(lambda d: d, w)
    exports["to_json_s"] = time.perf_counter() - t0
    check(w.getvalue().encode() == json_bytes, "to_json != the CLI's JSON file")
    del w
    for name, fn in (("to_dot", lambda p: graph.to_dot(p, lambda d: f"count {d}")),
                     ("to_gfa_with_tags", lambda p: graph.to_gfa_with_tags(
                         p, lambda node: f"KC:i:{node.data()}"))):
        p = os.path.join(tmp, name)
        t0 = time.perf_counter()
        fn(p)
        exports[name + "_s"] = time.perf_counter() - t0
        exports[name + "_bytes"] = os.path.getsize(p)
    out["exports"] = exports
    out["checkpoints"] = checkpoints(graph, table, rich_reads, tmp, device)
    log("phase 10: exports " + json.dumps(exports) + "; checkpoints " + json.dumps(out["checkpoints"]))
    del graph
    out["lookups"] = lookups_and_helpers(table, seed)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"phase 10 (CLI and graph API, {smi}): " + json.dumps({k: v for k, v in out.items()
                                                              if k != "launches"}))
    return out


# ---------------------------------------------------------------------------
# phase 11: the sharded path over several processes
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
MP_FILES = 4  # phase 11's FASTQ files, two a process
MP_TIMEOUT = 300  # seconds a collective waits for a process before it raises
MP_WAIT = 900  # seconds a run of workers may take in all
# chip_smoke's name of each launch counter -> the wrapper in tpu_debruijn_torch.kernels
COUNTERS = {
    "canonical": "canonicalize", "extract_canonical": "extract_canonical",
    "gather_rows": "gather_rows", "take_along_axis": "take_along_axis",
    "successor_walk": "successor_walk", "rank_loop": "rank_loop", "rank_lists": "rank_lists",
    "run_reduce": "run_reduce", "msp_scan": "msp_scan", "run_reduce_rows": "run_reduce_rows",
    "msp_scan_reads": "msp_scan_reads",
}
# the kernels each path must launch: every path counts, sorts and ranks;
# the sharded paths, and phase 12's cross-check through one, also scan minimizers
ON_PATH = ("canonical", "extract_canonical", "gather_rows", "rank_loop", "rank_lists",
           "run_reduce_rows")
ON_PATH_BY = {"sharded": ON_PATH + ("msp_scan_reads",),
              "multiprocess": ON_PATH + ("msp_scan_reads",),
              "errors": ON_PATH + ("msp_scan_reads",)}

MP_WORKER = r'''
"""One process of chip_smoke.start_workers: argv = repo root, spec file, rank.
Imports the port and nothing of JAX; runs each case of the spec ("repeat"
times, recording the last) and writes its GFA (and for "tables" its shard
tables) and a JSON record."""
import datetime, json, sys, time

root, spec_path, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(2)
from tpu_debruijn_torch import kernels as KN
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch.io import read_fastx

with open(spec_path) as f:
    spec = json.load(f)
world, dev = spec["world"], spec["device"]
if world > 1:
    TP.initialize(spec["init"], world, rank, backend=spec["backend"], timeout=spec["timeout"])
else:  # initialize does nothing for one process: a group of one by hand
    dist.init_process_group(spec["backend"], init_method=spec["init"], world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=spec["timeout"]))
cuda = torch.device(dev).type == "cuda"
# the first collective sets up the communicators: not a case's time
dist.all_reduce(torch.zeros(1, device="cpu" if dist.get_backend() == "gloo" else dev))
kw = dict(stranded=False, min_obs=spec["min_obs"], device=dev)
record = {"rank": rank, "backend": dist.get_backend(), "cases": {}}
for case in [c for c in spec["cases"] for _ in range(c.get("repeat", 1))]:
    name, out = case["name"], {}
    for attr in spec["counters"].values():
        getattr(KN, attr).launches = 0
    KN.rank_lists.round_path = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    if case["entry"] == "multihost":
        graph = TP.assemble_multihost(case["files"], spec["k"], spec["p"], stats=stats,
                                      **case.get("kwargs", {}), **kw)
    elif case["entry"] == "multiprocess":
        lo, hi, step = case["slices"][rank]
        reads = np.load(case["reads"])[lo:hi:step]
        t0 = time.perf_counter()
        graph = TP.assemble_multiprocess(reads, spec["k"], spec["p"], stats=stats,
                                         **case.get("kwargs", {}), **kw)
    else:  # "tables": this process's shard tables of its files' reads
        reads = [r for path in TP.local_read_slice(case["files"]) for r in read_fastx(path)]
        out["read_s"] = time.perf_counter() - t0
        _, tables, *_ = TP.sharded_tables(reads, spec["k"], spec["p"], stats=stats,
                                          mesh=TP.global_mesh(device=dev), **kw)
        np.savez(f"{spec['out']}/{name}_{rank}.npz", **{
            f"{col}_{s}": getattr(t, col).cpu().numpy()
            for s, t in enumerate(tables) for col in ("kmers", "exts", "counts")})
        graph = None
    if cuda:
        torch.cuda.synchronize()
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {n: getattr(KN, attr).launches for n, attr in spec["counters"].items()}
    out["launches"]["rank_lists.round_path"] = KN.rank_lists.round_path
    out["stats"] = stats
    if "files" in case:
        out["slice"] = TP.local_read_slice(case["files"])
    if graph is not None:
        out["nodes"] = len(graph)
        graph.to_gfa(f"{spec['out']}/{name}_{rank}.gfa")
    record["cases"][name] = out
dist.destroy_process_group()
with open(f"{spec['out']}/record_{rank}.json", "w") as f:
    json.dump(record, f)
'''


def start_workers(spec: dict, tmp: str) -> list:
    """Start ``spec["world"]`` fresh processes of MP_WORKER (``sys.executable``,
    importing only the port), joined by a file rendezvous in ``tmp``; their
    outputs go to ``spec["out"]`` (made here)."""
    os.makedirs(spec["out"], exist_ok=True)
    worker = os.path.join(tmp, "mp_worker.py")
    with open(worker, "w") as f:
        f.write(MP_WORKER)
    spec = {"counters": COUNTERS, "init": "file://" + os.path.join(spec["out"], "rendezvous"),
            **spec}
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return [subprocess.Popen([sys.executable, worker, ROOT, path, str(r)], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(spec["world"])]


def wait_workers(procs, out: str, timeout: float) -> list:
    """Each rank's JSON record, once every worker has ended; a worker that
    fails, or outlasts ``timeout`` seconds, fails the run, and none is left
    running."""
    deadline = time.monotonic() + timeout
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"worker {r} exited {p.returncode}:\n{text[-4000:]}")
    records = []
    for r in range(len(procs)):
        with open(os.path.join(out, f"record_{r}.json")) as f:
            records.append(json.load(f))
    return records


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def rank_summary(case: dict) -> dict:
    """One rank's numbers of one case, for the phase's line."""
    stats = case["stats"]
    out = {key: case[key] for key in ("wall_s", "read_s", "peak_device_bytes", "nodes")
           if key in case}
    for key in ("exchange_bytes", "gather_bytes", "shard_unitigs"):
        out[key] = stats.get(key)
    out["stages"] = stage_summary({k: v for k, v in stats.items() if k.endswith("_s")})
    return out


def phase_multiprocess(reads, table_main: dict, sharded_gfa: bytes, sharded_s: float, smi: str,
                       tmp: str, device="cuda") -> dict:
    """Phase 11: phase 3's reads in 4 FASTQ files, assembled by
    assemble_multihost in two worker processes on the card (gloo, an
    8-shard global mesh, 4 shards and 2 files a process), and by
    assemble_multiprocess in one worker under NCCL (a group of one, the
    collectives run all the same).  Checks: both ranks' GFA bytes equal,
    and equal to phase 9's assemble_sharded and to the NCCL run; the union
    of the ranks' shard tables equals phase 3's table.  Launches are counted
    in each worker over its assemble_multihost call and summed over the
    ranks (path "multiprocess")."""
    from types import SimpleNamespace

    t_phase = time.perf_counter()
    files = []
    for i, part in enumerate(np.array_split(np.asarray(reads), MP_FILES)):
        files.append(os.path.join(tmp, f"mp_{i}.fq"))
        write_fastq(files[-1], part)
    npy = os.path.join(tmp, "mp_reads.npy")
    np.save(npy, np.asarray(reads))
    torch.cuda.empty_cache()
    base = dict(k=K, p=P_MSP, min_obs=2, device=device, timeout=MP_TIMEOUT)
    out_a, out_b = os.path.join(tmp, "mp_gloo"), os.path.join(tmp, "mp_nccl")
    t0 = time.perf_counter()
    # the tables first: the timed assemble_multihost call finds the process warm
    ranks = wait_workers(start_workers(dict(base, world=2, backend="gloo", out=out_a, cases=[
        {"name": "tables", "entry": "tables", "files": files},
        {"name": "multihost", "entry": "multihost", "files": files},
    ]), tmp), out_a, MP_WAIT)
    run_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = wait_workers(start_workers(dict(base, world=1, backend="nccl", out=out_b, cases=[
        {"name": "nccl", "entry": "multiprocess", "reads": npy, "slices": [[0, None, 1]],
         "repeat": 2},
    ]), tmp), out_b, MP_WAIT)
    run_b_s = time.perf_counter() - t0

    gfa = [read_bytes(os.path.join(out_a, f"multihost_{r}.gfa")) for r in range(2)]
    check(gfa[0] == gfa[1], "phase 11: the two ranks' graphs differ")
    check(gfa[0] == sharded_gfa, "phase 11: two processes' graph != phase 9's assemble_sharded")
    check(read_bytes(os.path.join(out_b, "nccl_0.gfa")) == sharded_gfa,
          "phase 11: the NCCL run's graph != phase 9's assemble_sharded")
    for r, rec in enumerate(ranks):
        check(rec["cases"]["multihost"]["slice"] == files[r::2],
              f"phase 11: rank {r} read {rec['cases']['multihost']['slice']}")
    check(nccl["backend"] == "nccl", f"phase 11: run (b) ran on {nccl['backend']}")
    tables = []
    for r in range(2):
        z = np.load(os.path.join(out_a, f"tables_{r}.npz"))
        tables += [SimpleNamespace(**{col: torch.from_numpy(z[f"{col}_{s}"]).to(device)
                                      for col in ("kmers", "exts", "counts")})
                   for s in range(N_SHARDS // 2)]
    differ = check_shard_tables("phase 11", tables, table_main)
    del tables
    launches = {}
    for rec in ranks:
        for name, n in rec["cases"]["multihost"]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out = {"device": smi, "files": MP_FILES, "reads": len(reads), "k": K, "p": P_MSP,
           "shards": N_SHARDS, "min_obs": 2, "exts_differ_from_one_batch": differ,
           "assemble_sharded_s_phase_9": sharded_s,
           "gloo_two_processes": {"run_s": run_a_s, "ranks": [
               {"multihost": rank_summary(rec["cases"]["multihost"]),
                "tables": rank_summary(rec["cases"]["tables"]),
                "launches": rec["cases"]["multihost"]["launches"]} for rec in ranks]},
           "nccl_one_process": {"run_s": run_b_s, **rank_summary(nccl["cases"]["nccl"]),
                                "launches": nccl["cases"]["nccl"]["launches"]},
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 11 (two processes, {smi}): ranks' GFA equal, == phase 9's and the NCCL run's; "
        "shard tables == phase 3's; " + json.dumps(out))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 12: the error-handling path on reads with sequencing errors
# ---------------------------------------------------------------------------

ERR_MIN_OBS = (1, 2)
ERR_SMALL_LEN = 20_000  # phase 6's genome of error reads, CUDA against the CPU
RECOVERY_MIN = 0.999  # genome kmers the min_obs = 2 table must hold


def tip_predicate(k: int):
    """The README's tip test: a node shorter than 2K."""
    return lambda node: node.len() < 2 * k


def kmer_codes_of(limbs: torch.Tensor, k: int) -> np.ndarray:
    """(n, W) int64 limbs of kmers (k <= 32) as uint64 2k-bit codes."""
    code = limbs[:, 0]
    for j in range(1, limbs.shape[1]):
        code = (code << 32) | limbs[:, j]
    return code.cpu().numpy().astype(np.uint64)


def error_outputs(reads, k: int, dev, tmp: str) -> dict:
    """The error-handling path's entry points on ``dev`` for ``reads`` at
    ``k`` (unstranded), as GFA bytes at each min_obs of ERR_MIN_OBS:
    filter_kmers -> compress_kmers -> graph, compress_graph of that graph,
    the same path after remove_censored_exts, and clean_tips(len < 2K) of
    the censored graph.  Phase 6 and the card tests hold the CUDA bytes to
    the CPU ones."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import clean as CL
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import graph as G

    path = os.path.join(tmp, f"errors_{torch.device(dev).type}.gfa")
    items = [(r, 0, 0) for r in reads]
    graph_of = lambda table: T.from_compress_output(
        k, False, T.compress_kmers(table, device=dev)).finish(device=dev)
    out = {}
    for min_obs in ERR_MIN_OBS:
        table = T.filter_kmers(items, k, stranded=False, min_obs=min_obs, device=dev)
        graph = graph_of(table)
        out[f"min_obs={min_obs} compress"] = gfa_of(graph, path)
        out[f"min_obs={min_obs} compress_graph"] = gfa_of(G.compress_graph(graph, device=dev), path)
        TF.remove_censored_exts(table, device=dev)
        censored = graph_of(table)
        out[f"min_obs={min_obs} remove_censored_exts"] = gfa_of(censored, path)
        out[f"min_obs={min_obs} clean_tips"] = gfa_of(
            CL.clean_tips(censored, tip_predicate(k), device=dev), path)
    return out


def error_kernel_rows(reads, table, seed: int, device) -> list:
    """run_reduce_rows, rank_lists, rank_loop and gather_rows at phase 12's
    own shapes, each exact against its plain version and timed by CUDA
    events as phase 2 times them: the count's sorted rows of the error
    reads; the ranking carry that link_chains builds for the min_obs = 1
    table, and a ruler level of that carry's shape (rank_loop_ruler_level,
    drawn from ``seed``); the table search of neighbor_bits
    (remove_censored_exts), 8 candidates a kmer."""
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import sorting as S
    from tpu_debruijn_torch.kernels import pointer_jump as PJ
    from tpu_debruijn_torch.kernels import (
        gather_rows, gather_rows_plain, run_reduce_rows, run_reduce_rows_plain,
    )

    spec, w, rows = table.spec, table.spec.w, []
    bases, lengths, seq_exts, labels = TF._read_batch(spec, [(r, 0, 0) for r in reads], device)
    srows = TF._sorted_rows(spec, bases, lengths, seq_exts, labels.to(torch.int32)[:, None], False)
    del bases, lengths, seq_exts, labels
    out = torch.empty_like(srows)
    into = lambda: run_reduce_rows(srows, w, out=out)
    plain = lambda: run_reduce_rows_plain(srows, w, out=out)
    e = exact_err("phase 12: run_reduce_rows", lambda: (into().clone(),), lambda: (plain().clone(),))
    runs = int(into().shape[0])
    check(runs == len(table), f"phase 12: {runs} runs for {len(table)} table kmers")
    key = srows[:, :2].contiguous().view(torch.int64).flatten()
    rec = kernel_row("run_reduce_rows", "run_reduce.cu", "tpu_debruijn/sorting.py:316", into, plain,
                     e, f"phase 12: ({srows.shape[0]}, 4) int32 sorted rows, {runs} runs",
                     nbytes(srows) + runs * 4 * 4 + 4,
                     library=lambda: torch.unique_consecutive(key, return_counts=True))
    rows.append(rec)
    del srows, out, key
    torch.cuda.empty_cache()

    # the carry of link_chains on the min_obs = 1 table
    edges = C.resolve_edges(spec, False, table.kmers, table.exts)
    succ = C._succ_states(edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"])
    m = succ.shape[0]
    node = torch.arange(m // 2, device=device).repeat_interleave(2)
    mnmo = (node << 1) | torch.arange(2, device=device).repeat(m // 2)
    x = torch.stack([succ, succ >= 0, mnmo, torch.where(succ == -1, torch.arange(m, device=device), -1)],
                    dim=1).to(torch.int32)
    del edges, succ, node, mnmo
    loops = PJ.rank_loop.launches
    PJ.rank_loop.last_rounds = None
    got = PJ.rank_lists(x)
    cuda = x.device.type == "cuda"
    check(not cuda or PJ.rank_loop.launches == loops + 1,
          "phase 12: the ranking took other than one rank_loop")
    rounds = int(PJ.rank_loop.last_rounds) if cuda else None
    want = PJ.rank_lists_plain(x)
    ends = want[:, 0] < 0
    e = max_abs_diff((got[ends], got[~ends, 2]), (want[ends], want[~ends, 2]))
    check(e == 0, "phase 12: rank_lists != the plain loop where a path ends or on a cycle minimum")
    lists = int((x[:, 0] < 0).sum())
    del got, want
    rec = kernel_row("rank_lists", "list_rank.cu", "tpu_debruijn/compress.py:277",
                     lambda: PJ.rank_lists(x), lambda: PJ.rank_lists_plain(x), e,
                     f"phase 12: ({m}, 4) int32 carry, {lists} lists", 2 * nbytes(x))
    rec.update(rank_loop_rounds=rounds, lists=lists)
    rows.append(rec)
    gen = torch.Generator(device=device).manual_seed(seed)
    # phase 12's kernel rows are timed by events only: late in the run the
    # profiler has lost a kernel's events (rank_loop_kernel, count traces)
    rec = rank_loop_ruler_level(gen, x, device, "phase 12", profiled=False)
    rec["shape"] = "phase 12: " + rec["shape"]
    log(f"phase 12: rank_lists {rows[-1]['ms']:.4f} ms over {m} states in {lists} lists, its "
        f"ruler level in {rounds} rank_loop rounds; rank_loop on a ruler level of that shape "
        f"{rec['ms']:.4f} ms in {rec['rounds']} rounds")
    rows.append(rec)
    del x
    torch.cuda.empty_cache()

    # neighbor_bits' search of the table: 8n canonical candidates
    from tpu_debruijn_torch import kmer as KM

    n = len(table)
    cands = torch.cat([(KM.extend_left if d == 0 else KM.extend_right)(spec, table.kmers, b)
                       for d in (0, 1) for b in range(4)])
    cands = TF._canonicalize(spec, cands, torch.zeros(8 * n, dtype=torch.int32, device=device))[0]
    skey = S.pack_keys(table.kmers)[0].contiguous()
    qkey = S.pack_keys(cands)[0].contiguous()
    del cands
    idx = torch.searchsorted(skey, qkey)
    del qkey
    g = gather_rows(skey, idx)
    e = max_abs_diff((g,), (gather_rows_plain(skey, idx),))
    check(e == 0 and torch.equal(torch.index_select(skey, 0, idx.clamp(max=n - 1)), g),
          "phase 12: gather_rows != plain on the table search")
    del g
    rec = kernel_row("gather_rows", "gather.cu", "scripts/probe_pallas_gather.py:80",
                     lambda: gather_rows(skey, idx), lambda: gather_rows_plain(skey, idx), e,
                     f"phase 12: ({n},) int64 table keys, {8 * n} int64 indices",
                     nbytes(idx) + nbytes(skey) + nbytes(idx),
                     library=lambda: torch.index_select(skey, 0, idx.clamp(max=n - 1)))
    rec["random_floor_ms"] = (idx.shape[0] * (32 + 8 + 8)) / HBM_BYTES_PER_S * 1e3
    rows.append(rec)
    return rows


def phase_errors(genome, seed: int, counters, smi: str, tmp: str, device="cuda") -> dict:
    """Phase 12: the error-handling path at full width.  Reads of phase 3's
    genome at 30x with sequencing errors (sample_error_reads), written to a
    FASTQ file; at each min_obs of ERR_MIN_OBS: filter_kmers against a
    plain numpy count, remove_censored_exts, compress_kmers with and
    without it, the graph and its GFA, compress_graph, clean_tips(len < 2K);
    the streamed count of the FASTQ file in 64 chunks; assemble_sharded
    (k = 31, p = 8, 8 shards) with its shard tables and clean_tips.
    Launches are counted over all of that (path "errors"); then the card's
    busy time of the min_obs = 1 count and compress, and the kernels at the
    phase's own shapes (error_kernel_rows)."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import clean as CL
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import graph as G
    from tpu_debruijn_torch import parallel as TP
    from tpu_debruijn_torch import sorting as S
    from tpu_debruijn_torch import table_to_numpy

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 12])
    t0 = time.perf_counter()
    reads, errors = sample_error_reads(rng, genome, COVERAGE, READ_LEN)
    fq = os.path.join(tmp, "errors.fq")
    write_fastq(fq, reads)
    host_s = {"reads_and_fastq": time.perf_counter() - t0}
    t0 = time.perf_counter()
    codes, counts = plain_count(reads, K)
    host_s["plain_count"] = time.perf_counter() - t0
    genome_codes = plain_count(genome[None, :], K)[0]
    log(f"phase 12: errors injected {json.dumps(errors)}; plain count of "
        f"{len(reads) * (READ_LEN - K + 1)} kmers: {codes.shape[0]} distinct")
    items = [(r, 0, 0) for r in reads]
    pred = tip_predicate(K)
    mesh = TP.make_mesh(N_SHARDS, device=device)
    chunk = -(-len(reads) // 64)  # bench.py's corpus model: 64 count batches
    path = os.path.join(tmp, "errors.gfa")
    out = {"reads": len(reads), "k": K, "coverage": COVERAGE, "read_len": READ_LEN,
           "errors": errors, "host_s": host_s, "by_min_obs": {}}
    table1 = None

    for fn in counters.values():
        fn.launches = 0
    counters["rank_lists"].round_path = 0
    for min_obs in ERR_MIN_OBS:
        secs, rec = {}, {}
        t_loop = time.perf_counter()

        def stage(name, fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return res

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["held_bytes"] = torch.cuda.memory_allocated()  # the min_obs = 1 table, at 2
        table = stage("count", lambda: T.filter_kmers(items, K, stranded=False, min_obs=min_obs,
                                                      device=device))
        rec["peak_count_bytes"] = torch.cuda.max_memory_allocated()
        # check 1: the table against the plain count
        keep = counts >= min_obs
        got_counts = table.counts.cpu().numpy()
        check(np.array_equal(kmer_codes_of(table.kmers, K), codes[keep])
              and np.array_equal(got_counts, np.minimum(counts[keep], 65535)),
              f"phase 12 min_obs={min_obs}: the table != the plain numpy count")
        want = table_to_numpy(table)
        rec.update(table_kmers=len(table), singletons=int((got_counts == 1).sum()))
        rec["singleton_share"] = rec["singletons"] / max(1, len(table))

        censored = TF.KmerTable(table.spec, False, table.kmers, table.exts.clone(), table.counts,
                                table.data)
        stage("censor", lambda: TF.remove_censored_exts(censored, device=device))
        rec["exts_censored"] = int((censored.exts != table.exts).sum())
        torch.cuda.reset_peak_memory_stats()
        nodes = stage("compress", lambda: T.compress_kmers(table, device=device))
        rec["peak_compress_bytes"] = torch.cuda.max_memory_allocated()
        nodes_c = stage("compress_censored", lambda: T.compress_kmers(censored, device=device))
        # check 3: every table kmer in exactly one unitig, with and without the censor
        for what, ns in (("", nodes), (" after remove_censored_exts", nodes_c)):
            ukm = unitig_kmers(table.spec, ns, device)
            check(ukm.shape[0] == len(table) and torch.equal(ukm[S.lex_argsort(ukm)], table.kmers),
                  f"phase 12 min_obs={min_obs}: unitig kmers != table kmers{what}")
            del ukm
        graph = stage("graph", lambda: T.from_compress_output(K, False, nodes).finish(device=device))
        gfa = stage("gfa", lambda: gfa_of(graph, path))
        check(gfa.count(b"\nS\t") == len(graph), f"phase 12 min_obs={min_obs}: GFA S lines != nodes")
        rec["gfa_bytes"] = len(gfa)
        del gfa
        graph_c = stage("graph_censored",
                        lambda: T.from_compress_output(K, False, nodes_c).finish(device=device))
        # the graphs of check 4, each read before a call that sets its exts
        sets = {"remove_censored_exts": graph_canon(graph_c)}
        compressed = {"remove_censored_exts": graph_c.is_compressed()}
        one = stage("compress_graph", lambda: G.compress_graph(graph, device=device))
        sets["compress_graph of the one-batch graph"] = graph_canon(one)
        compressed["compress_graph of the one-batch graph"] = one.is_compressed()
        rec.update(nodes=len(graph), nodes_compress_graph=len(one),
                   nodes_remove_censored_exts=len(graph_c), unitigs=len(nodes))
        del nodes, nodes_c, graph, one
        # check 5: the tips, then clean_tips
        bad = stage("find_tips", lambda: CL.CleanGraph(pred).find_bad_nodes(graph_c))
        lens = np.asarray(graph_c.base.sequences.length)
        tester = CL.CleanGraph(pred)
        check(all(tester.test_tip(graph_c, i) == i for i in bad) and bool((lens[bad] < 2 * K).all()),
              f"phase 12 min_obs={min_obs}: a node find_bad_nodes returned is no tip")
        n_in = len(graph_c)
        cleaned = stage("clean_tips", lambda: CL.clean_tips(graph_c, pred, device=device))
        gfa = stage("gfa_cleaned", lambda: gfa_of(cleaned, path))
        check(gfa.count(b"\nS\t") == len(cleaned), f"phase 12 min_obs={min_obs}: cleaned GFA S lines")
        check(cleaned.is_compressed() is None, f"phase 12 min_obs={min_obs}: the cleaned graph "
              "is not compressed")
        check(len(cleaned) < n_in or not bad, f"phase 12 min_obs={min_obs}: clean_tips removed "
              f"no node of {len(bad)} tips")
        rec.update(tips=len(bad), nodes_clean_tips=len(cleaned))
        del gfa, graph_c

        # the sharded path on the same reads
        stats = {}
        sharded = stage("assemble_sharded", lambda: TP.assemble_sharded(
            reads, K, P_MSP, stranded=False, min_obs=min_obs, mesh=mesh, device=device,
            stats=stats))
        rec["assemble_sharded_stages"] = stage_summary(stats)
        sets["assemble_sharded"] = graph_canon(sharded)
        compressed["assemble_sharded"] = sharded.is_compressed()
        again = stage("compress_graph_sharded", lambda: G.compress_graph(sharded, device=device))
        sets["compress_graph of assemble_sharded"] = graph_canon(again)
        compressed["compress_graph of assemble_sharded"] = again.is_compressed()
        del again
        # clean_tips sets the exts of the graph it cleans: last
        cleaned_s = stage("clean_tips_sharded", lambda: CL.clean_tips(sharded, pred, device=device))
        check(graph_canon(cleaned_s) == graph_canon(cleaned),
              f"phase 12 min_obs={min_obs}: sharded and one-batch cleaned graphs differ")
        del sharded, cleaned_s
        # check 4
        for name, pair in compressed.items():
            check(pair is None, f"phase 12 min_obs={min_obs}: {name} is not compressed: {pair}")
        first = sets["remove_censored_exts"]
        for name, s in sets.items():
            check(s == first, f"phase 12 min_obs={min_obs}: {name} != the censored graph "
                  f"({len(s)} and {len(first)} unitigs)")
        del sets, first
        (_, tables, *_) = stage("sharded_tables", lambda: TP.sharded_tables(
            reads, K, P_MSP, stranded=False, min_obs=min_obs, mesh=mesh, device=device))
        rec["exts_differ_from_one_batch"] = check_shard_tables(
            f"phase 12 min_obs={min_obs}", tables, want)
        check(min_obs > 1 or rec["exts_differ_from_one_batch"] == 0,
              "phase 12 min_obs=1: shard exts differ from the one-batch table")
        del tables
        # check 2: the streamed count of the FASTQ file
        streamed = stage("streamed_count", lambda: T.filter_kmers_streaming(
            T.stream_fastx_blocks(fq, block_reads=chunk), K, stranded=False, min_obs=min_obs,
            data_reduce="none", merge="device", chunk_reads=chunk, device=device))
        got = table_to_numpy(streamed)
        check(all(np.array_equal(got[x], want[x]) for x in ("kmers", "exts", "counts", "data")),
              f"phase 12 min_obs={min_obs}: the streamed table != the one-batch table")
        del streamed, got

        # check 6: genome recovery
        tcodes = kmer_codes_of(table.kmers, K)
        in_table = np.isin(genome_codes, tcodes, assume_unique=True)
        seqs = cleaned.base.sequences
        ccodes = kmer_codes_of(seq_kmers(table.spec, seqs._flat(), seqs.length, device,
                                         seqs.start), K)
        in_clean = np.isin(genome_codes, ccodes)
        rec["genome_kmers"] = int(genome_codes.shape[0])
        rec["genome_share_in_table"] = float(in_table.mean())
        rec["genome_share_in_cleaned_graph"] = float(in_clean.mean())
        rec["genome_kmers_lost_by_cleaning"] = int((in_table & ~in_clean).sum())
        if min_obs == 2:
            check(rec["genome_share_in_table"] >= RECOVERY_MIN,
                  f"phase 12: the min_obs = 2 table holds {rec['genome_share_in_table']:.5f} of "
                  "the genome's kmers")
        rec["stage_s"] = secs
        # the checks' own host time: what the loop took beside its stages
        rec["checks_s"] = time.perf_counter() - t_loop - sum(secs.values())
        out["by_min_obs"][min_obs] = rec
        log(f"phase 12 min_obs={min_obs} ({smi}): " + json.dumps(rec))
        if min_obs == 1:
            table1 = table
        del table, censored, cleaned, want
        torch.cuda.empty_cache()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["rank_lists.round_path"] = counters["rank_lists"].round_path

    out["device_ms"] = {
        "count min_obs=1": profile_device_ms(lambda: T.filter_kmers(
            items, K, stranded=False, min_obs=1, device=device), top=8),
        "compress min_obs=1": profile_device_ms(lambda: T.compress_kmers(table1, device=device),
                                                top=8),
    }
    # the count uploads its reads: a trace without that copy lost events
    out["device_ms"]["count min_obs=1"]["complete"] = out["device_ms"]["count min_obs=1"]["htod"] > 0
    out["kernels"] = error_kernel_rows(reads, table1, seed, device)
    del table1
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 (error-handling path, {smi}): " + json.dumps(
        {k: v for k, v in out.items() if k not in ("by_min_obs", "kernels")}))
    out["launches"] = launches
    return out


def sharded_and_corpus_stages(raw, reps: int, device) -> dict:
    """``--stages``' MSP and corpus numbers: ``reps`` calls of phase 9's
    assemble_sharded (its "msp" stage and total seconds) and of phase 7's
    streamed count of a FASTQ file in 64 chunks with the device merge (the
    median seconds a chunk and gather_rows launches a chunk), and the card's
    busy time of one call of each."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import parallel as TP
    from tpu_debruijn_torch.kernels import gather_rows

    mesh = TP.make_mesh(N_SHARDS, device=device)
    shard = lambda stats=None: TP.assemble_sharded(raw, K, P_MSP, stranded=False, min_obs=2,
                                                   mesh=mesh, device=device, stats=stats)
    out = {"sharded_s": [], "sharded_msp_s": [], "corpus_chunk_s_median": [],
           "corpus_count_merge_s": [], "corpus_gather_rows_per_chunk": []}
    for _ in range(reps):
        stats = {}
        t0 = time.perf_counter()
        shard(stats)
        torch.cuda.synchronize()
        out["sharded_s"].append(time.perf_counter() - t0)
        out["sharded_msp_s"].append(sum(stats["msp_s"]))
    out["device_ms_sharded"] = profile_device_ms(shard, top=8)
    chunk = -(-len(raw) // 64)
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, raw)

        def corpus(decode_s=None, chunk_s=None):
            blocks = T.stream_fastx_blocks(fq, block_reads=chunk)
            if chunk_s is not None:
                blocks = timed_blocks(blocks, decode_s, chunk_s)
            return T.filter_kmers_streaming(blocks, K, stranded=False, min_obs=2,
                                            data_reduce="none", merge="device",
                                            chunk_reads=chunk, device=device)

        for _ in range(reps):
            decode_s, chunk_s = [], []
            before = gather_rows.launches
            t0 = time.perf_counter()
            corpus(decode_s, chunk_s)
            torch.cuda.synchronize()
            out["corpus_count_merge_s"].append(time.perf_counter() - t0 - sum(decode_s))
            out["corpus_chunk_s_median"].append(float(np.median(chunk_s)))
            out["corpus_gather_rows_per_chunk"].append((gather_rows.launches - before) / len(chunk_s))
        out["device_ms_corpus"] = profile_device_ms(corpus, top=10)
    return out


def count_tail_ms(reads, device) -> dict:
    """The count's tail on the quick start's sorted rows, pass by pass (CUDA
    events): the passes count_kmers ran before run_reduce_rows (run starts,
    run bounds with their host read, counts, the exts OR by run_reduce, the
    head rows' gather; the segmented min of data_reduce "min"/"max"), and
    run_reduce_rows where the checkout has it."""
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import kernels as KN
    from tpu_debruijn_torch import sorting as S
    from tpu_debruijn_torch.kmer import KmerSpec

    spec = KmerSpec(K)
    w = spec.w
    bases, lengths, seq_exts, labels = TF._read_batch(spec, reads, device)
    args = (spec, bases, lengths, seq_exts, labels.to(torch.int32)[:, None], False)
    srows = TF._sorted_rows(*args) if hasattr(TF, "_sorted_rows") else TF._sorted_runs(*args)[0]
    del args, bases, lengths, seq_exts, labels
    is_start = S.run_starts(srows[:, :w])
    starts, ends = TF.run_bounds(is_start)
    run = torch.cumsum(is_start, 0) - 1
    passes = {
        "run_starts": lambda: S.run_starts(srows[:, :w]),
        "run_bounds": lambda: TF.run_bounds(is_start),
        "counts": lambda: (ends - starts).clamp(max=65535).to(torch.int32),
        "run_reduce": lambda: KN.run_reduce(ends, srows[:, w]),
        "gather_heads": lambda: KN.gather_rows(srows, starts),
    }
    out = {name: min(time_ms(fn) for _ in range(2)) for name, fn in passes.items()}
    out["parent_tail"] = sum(out.values())
    out["segment_min (min/max only)"] = min(time_ms(
        lambda: S.segment_min(srows[:, w + 1], run, starts.shape[0], "amin")) for _ in range(2))
    if hasattr(KN, "run_reduce_rows"):
        buf = torch.empty_like(srows)
        out["run_reduce_rows"] = min(time_ms(lambda: KN.run_reduce_rows(srows, w, out=buf))
                                     for _ in range(2))
    out["rows"], out["runs"] = srows.shape[0], starts.shape[0]
    return out


def stage_times(seed: int, reps: int = 3, device="cuda") -> dict:
    """``--stages``: the count and compress stages and both linkers, each
    ``reps`` times (host clock, ending in a synchronize), the card's busy
    time of one call of each and the count's peak bytes, the extraction
    kernel, the whole ranking and gather_rows at the main path's shapes
    (CUDA events); the count's tail pass by pass (:func:`count_tail_ms`);
    the MSP and corpus numbers of :func:`sharded_and_corpus_stages`; phase
    8's colored count (seconds and peak bytes).  Uses only entry points
    that every version of the port with a sharded path has."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import compress as C
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch.kernels import _build, extract_canonical, gather_rows
    from tpu_debruijn_torch.kmer import KmerSpec

    _build.library()
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, ECOLI_LEN, False)
    raw = sample_reads(rng, genome, COVERAGE, READ_LEN)
    reads = [(r, 0, 0) for r in raw]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    count = lambda **kw: T.filter_kmers(reads, k=K, stranded=False, min_obs=2, device=device, **kw)
    out = {"count_s": [], "compress_s": [], "linker_plain_s": [], "linker_ordered_s": []}
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        dt, table = timed(count)
        out["count_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["count_s"].append(dt)
        out["compress_s"].append(timed(lambda: T.compress_kmers(table, device=device))[0])
    ordered = count(data_reduce="obs_min")
    linkers = {
        "linker_plain_s": lambda: C.compress_kmer_table_device(
            ordered.spec, False, ordered.kmers, ordered.exts),
        "linker_ordered_s": lambda: C.compress_kmer_table_device(
            ordered.spec, False, ordered.kmers, ordered.exts, first_pos=ordered.data),
    }
    for _ in range(reps):
        for name, fn in linkers.items():
            out[name].append(timed(fn)[0])
    out["device_ms"] = {
        "count": profile_device_ms(count, top=10),
        "compress": profile_device_ms(lambda: T.compress_kmers(table, device=device)),
        "linker_ordered": profile_device_ms(linkers["linker_ordered_s"]),
    }
    del table, ordered
    out["count_tail_ms"] = count_tail_ms(reads, device)
    torch.cuda.empty_cache()
    out.update(sharded_and_corpus_stages(raw, reps, device))
    # phase 8's colored count: four strains' reads labelled by strain
    _, reads8, labels8 = strain_reads(rng, genome)
    items = [(r, 0, int(lab)) for r, lab in zip(reads8, labels8)]
    del reads8, labels8
    out["colored_count_s"] = []
    for _ in range(reps):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["colored_count_s"].append(timed(lambda: TF.filter_kmers_set_arrays(
            items, K, stranded=False, min_obs=2, device=device))[0])
        out["colored_count_peak_bytes"] = torch.cuda.max_memory_allocated()
    del items
    torch.cuda.empty_cache()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_reads = len(reads)
    l = -(-READ_LEN // 16) * 16
    bases = torch.randint(0, 4, (n_reads, l), generator=gen, dtype=torch.uint8, device=device)
    lengths = torch.full((n_reads,), READ_LEN, dtype=torch.int32, device=device)
    seq_exts = torch.zeros(n_reads, dtype=torch.int32, device=device)
    spec = KmerSpec(K)
    out["extract_canonical_ms"] = min(
        time_ms(lambda: extract_canonical(spec, bases, lengths, seq_exts, False)) for _ in range(2))
    del bases
    n_states = 2 * (ECOLI_LEN - K + 1)
    succ = successor_forest(gen, n_states, n_states // 2, device)
    mnmo = torch.randint(0, 1 << 30, (n_states,), generator=gen, device=device)
    out["rank_all_ms"] = min(time_ms(lambda: C._rank_all(succ, mnmo)) for _ in range(2))
    del succ, mnmo
    # gather_rows at the count stage's shape: (n_obs, 4) int32 rows by a
    # random permutation and by a sorted index
    n_obs = n_reads * (READ_LEN - K + 1)
    obs = torch.randint(0, 1 << 31, (n_obs, 4), generator=gen, dtype=torch.int32, device=device)
    out["gather_rows_count_ms"] = {}
    for name, idx in (("random", torch.randperm(n_obs, generator=gen, device=device)),
                      ("sorted", torch.arange(n_obs, device=device))):
        out["gather_rows_count_ms"][name] = min(time_ms(lambda: gather_rows(obs, idx)) for _ in range(2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every random input")
    ap.add_argument("--stages", action="store_true",
                    help="only time the stages, the extraction kernel and the ranking")
    ap.add_argument("--root", default=None,
                    help="with --stages: the checkout whose tpu_debruijn_torch is timed")
    args = ap.parse_args(argv)

    # phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    if args.stages:
        if args.root:
            sys.path.insert(0, os.path.abspath(args.root))
        out = stage_times(args.seed)
        log("stages " + json.dumps({"root": args.root or ".", "device": smi, **out}))
        return 0

    from tpu_debruijn_torch import kernels as KN
    from tpu_debruijn_torch import table_to_numpy
    from tpu_debruijn_torch.io import native
    from tpu_debruijn_torch.kernels import _build

    log(f"native host codec loaded: {native.native_available()}")

    # phase 1
    lib = _build.library()
    log(f"phase 1: built {len(_build.sources())} sources in {lib.build_seconds:.2f} s -> {lib.path}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log("  " + line.strip())

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    # phase 2, at the main path's shapes: every read of phase 3, the 3n
    # canonicalized rows of resolve_edges and the 2n-state doubling carry
    # for a table of the genome's kmers
    n_reads = -(-COVERAGE * ECOLI_LEN // READ_LEN)
    n_kmers = ECOLI_LEN - K + 1
    rows = phase_kernels(gen, n_reads, 3 * n_kmers, "cuda")
    torch.cuda.empty_cache()
    rows += phase_pointer_kernels(gen, 2 * n_kmers, "cuda")
    torch.cuda.empty_cache()
    rows += phase_scan_kernels(gen, n_reads, n_reads * (READ_LEN - K + 1), "cuda")
    torch.cuda.empty_cache()
    rows += phase_fused_kernels(gen, n_reads, n_reads * (READ_LEN - K + 1), "cuda")
    torch.cuda.empty_cache()

    # every wrapper counts its launches; the kernels each path must launch
    counters = {name: getattr(KN, attr) for name, attr in COUNTERS.items()}
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        # phase 3: the main path
        genome = make_genome(rng, ECOLI_LEN, repeat_rich=False)
        for fn in counters.values():
            fn.launches = 0
        KN.rank_lists.round_path = 0
        main, reads, nodes_main, table = phase_assembly("ecoli", rng, genome, tmp, check_substrings=True)
        by_path["quick_start"] = {name: fn.launches for name, fn in counters.items()}
        by_path["quick_start"]["rank_lists.round_path"] = KN.rank_lists.round_path
        main["rank_loop_rounds"] = int(KN.rank_loop.last_rounds)
        main["gather_rows_launches"]["resolve_edges"] = resolve_edges_gathers(table)
        table_main = table_to_numpy(table)
        log("phase 3 (main path): " + json.dumps(main))
        assembly = {"phase 3": compare_assembly(table, "phase 3")}
        del table

        # phase 4: the read-ordered path on the same reads
        ordered = phase_ordered(reads, nodes_main, counters, "cuda")
        by_path["ordered"] = ordered["launches"]
        log("phase 4 (ordered path): " + json.dumps(ordered))

        # phase 5
        rich, rich_reads = phase_assembly("repeat_rich", rng, make_genome(rng, 1_000_000, True),
                                          tmp, False)[:2]
        log("phase 5 (repeat-rich): " + json.dumps(rich))

        # phase 6
        phase_device_vs_cpu(rng, tmp, args.seed)

        # phase 7: the corpus path on phase 3's file and reads
        corpus = phase_corpus(os.path.join(tmp, "ecoli.fq"), reads, table_main, nodes_main,
                              rich_reads, counters, "cuda")
        by_path["corpus"] = corpus.pop("launches")
        log("phase 7 (corpus path): " + json.dumps({"device": smi, **corpus}))

        # phase 8: the colored path at full width
        strains, reads8, labels8 = strain_reads(rng, genome)
        colored = phase_colored(strains, reads8, labels8, rich_reads, counters, smi)
        by_path["colored"] = colored.pop("launches")
        assembly["phase 8"] = colored.pop("assembly")
        log("host vs device assembly: " + json.dumps({"device": smi, **assembly}))

        # phase 9: the MSP-sharded path at full width
        sharded_gfa = os.path.join(tmp, "sharded.gfa")
        sharded = phase_sharded(reads, table_main, nodes_main, main["peak_device_bytes"],
                                rich_reads, counters, smi, sharded_gfa)
        by_path["sharded"] = sharded.pop("launches")
        del nodes_main

        # phase 10: the command line on phase 8's reads, and the graph API
        cli = phase_cli(genome, strains, reads8, rich_reads, counters, smi, tmp, args.seed)
        by_path["cli"] = cli.pop("launches")
        del reads8, labels8, rich_reads

        # phase 11: the sharded path in two processes on the card
        multi = phase_multiprocess(reads, table_main, read_bytes(sharded_gfa),
                                   sharded["assemble_sharded_s"], smi, tmp)
        by_path["multiprocess"] = multi.pop("launches")
        del reads

        # phase 12: the error-handling path on reads with sequencing errors
        errors = phase_errors(genome, args.seed, counters, smi, tmp)
        by_path["errors"] = errors.pop("launches")
        rows += errors.pop("kernels")

        for path, launches in by_path.items():
            for name in ON_PATH_BY.get(path, ON_PATH):
                check(launches[name] > 0, f"the {path} path never launched kernel {name}")
            check(launches["rank_lists.round_path"] == 0, f"the {path} path ranked by the round path")
            check(launches["rank_loop"] == launches["rank_lists"],
                  f"the {path} path: {launches['rank_loop']} rank_loop launches for "
                  f"{launches['rank_lists']} rankings")
        for r in rows:
            r["launches_by_path"] = {path: by_path[path][r["name"]] for path in by_path}
            r["launches"] = sum(r["launches_by_path"].values())

    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
