"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc``, and skip without
them.  This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch.kernels import (
    canonicalize,
    canonicalize_plain,
    extract_canonical,
    extract_canonical_plain,
    gather_rows,
    gather_rows_plain,
    msp_scan,
    msp_scan_plain,
    msp_scan_reads,
    msp_scan_reads_plain,
    rank_lists,
    rank_lists_plain,
    rank_loop,
    rank_loop_plain,
    rank_round_plain,
    run_reduce,
    run_reduce_plain,
    run_reduce_rows,
    run_reduce_rows_plain,
    successor_walk,
    successor_walk_plain,
    take_along_axis,
    take_along_axis_plain,
)

KS = [4, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_canonical_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    spec = TK.KmerSpec(k)
    km = TK.to_torch(TK.from_bases_batch_np(spec, rng.integers(0, 4, (50_000, k))), cuda)
    ex = torch.from_numpy(rng.integers(0, 256, 50_000).astype(np.int32)).to(cuda)
    got = canonicalize(spec, km, ex)
    want = canonicalize_plain(spec, km, ex)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(257, 160), (33, 97), (5, 3001)])
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", KS)
def test_extract_canonical_kernel_matches_plain(cuda, k, stranded, shape):
    """Rows of 160 bases (16-byte loads), of 97 (byte loads) and of 3001
    (cut into pieces); every slot, invalid ones too, as the plain version
    writes them."""
    rng = np.random.default_rng(k)
    spec = TK.KmerSpec(k)
    r, l = shape
    bases = torch.from_numpy(rng.integers(0, 4, (r, l)).astype(np.uint8)).to(cuda)
    lengths = torch.from_numpy(rng.integers(k, l + 1, r).astype(np.int32)).to(cuda)
    seq_exts = torch.from_numpy(rng.integers(0, 256, r).astype(np.int32)).to(cuda)
    got = extract_canonical(spec, bases, lengths, seq_exts, stranded)
    want = extract_canonical_plain(spec, bases, lengths, seq_exts, stranded)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _forest(rng, m, cyclic):
    """Successors over m states: random lists, every other one closed into
    a cycle when ``cyclic``."""
    succ = np.full(m, -1, np.int64)
    parts = np.split(rng.permutation(m), np.sort(rng.choice(np.arange(1, m), m // 50, replace=False)))
    for j, part in enumerate(parts):
        succ[part[:-1]] = part[1:]
        if cyclic and j % 2:
            succ[part[-1]] = part[0]
    return succ


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("c", [None, 1, 2, 3, 4, 5, 8, 128])
def test_gather_rows_kernel_matches_plain(cuda, c, dtype, idx_dtype):
    rng = np.random.default_rng(0)
    shape = (5000,) if c is None else (5000, c)
    tab = torch.from_numpy(rng.integers(-(2**31), 2**31, shape)).to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(-50, 5050, 20_000)).to(idx_dtype).to(cuda)
    before = gather_rows.launches
    got = gather_rows(tab, idx)
    assert gather_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_plain(tab, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("words", [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 128])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, (1 << 20) + 3])
def test_gather_rows_row_widths_match_plain(cuda, n, words, idx_dtype):
    """The thread-per-row kernel (up to 8 words, every vector width) and
    the warp-per-row kernel (above) at ragged row counts, out-of-range
    indices clamped."""
    rng = np.random.default_rng(words)
    m = 3001
    tab = torch.from_numpy(rng.integers(-(2**31), 2**31, (m, words)).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-7, m + 7, n)).to(idx_dtype).to(cuda)
    got = gather_rows(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_plain(tab, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(33, 7), (5, 3001), (1, 1), (3, 5)])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_ragged_shapes(cuda, axis, shape, idx_dtype):
    """Element counts that are not a multiple of 4."""
    rng = np.random.default_rng(7)
    tab = torch.from_numpy(rng.integers(0, 2**31, shape).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-3, shape[axis] + 3, shape)).to(idx_dtype).to(cuda)
    before = take_along_axis.launches
    got = take_along_axis(tab, idx, axis)
    assert take_along_axis.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, take_along_axis_plain(tab, idx, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_unaligned_indices(cuda, axis):
    """Indices that are a view not starting on 16 bytes."""
    rng = np.random.default_rng(8)
    r, l = 7, 12
    tab = torch.from_numpy(rng.integers(0, 2**31, (r, l)).astype(np.int32)).to(cuda)
    flat = torch.from_numpy(rng.integers(-2, (r, l)[axis] + 2, r * l + 1).astype(np.int32)).to(cuda)
    idx = flat[1:].view(r, l)
    got = take_along_axis(tab, idx, axis)
    torch.cuda.synchronize()
    assert torch.equal(got, take_along_axis_plain(tab, idx, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("data_reduce", ["label_first", "min", "obs_min", "none"])
@pytest.mark.parametrize("k", [15, 31, 33, 63])
def test_count_stage_gathers_on_card(cuda, k, data_reduce):
    """filter_kmers on the card moves its observations with gather_rows and
    gives the CPU's table; edge resolution gathers with it too."""
    from tpu_debruijn_torch import compress as TC
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import table_to_numpy

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 5_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 150, 600)
    reads = [(genome[s : s + 150], int(rng.integers(0, 256)), int(rng.integers(-99, 99)))
             for s in starts]
    kw = dict(stranded=False, min_obs=2, report_all=True, data_reduce=data_reduce)
    before = gather_rows.launches
    table = TF.filter_kmers(reads, k, device=cuda, **kw)
    assert gather_rows.launches >= before + 3  # compaction, permutation, run starts
    got, want = table_to_numpy(table), table_to_numpy(TF.filter_kmers(reads, k, device="cpu", **kw))
    assert got.keys() == want.keys() and all(np.array_equal(got[x], want[x]) for x in got)
    before = gather_rows.launches
    edges = TC.resolve_edges(table.spec, False, table.kmers, table.exts)
    assert gather_rows.launches > before
    plain = TC.resolve_edges(table.spec, False, table.kmers.cpu(), table.exts.cpu())
    assert all(torch.equal(edges[x].cpu(), plain[x]) for x in plain)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_kernel_matches_plain(cuda, axis, idx_dtype):
    rng = np.random.default_rng(1)
    r, l = 2048, 128
    tab = torch.from_numpy(rng.integers(0, 2**31, (r, l)).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-3, (r, l)[axis] + 3, (r, l))).to(idx_dtype).to(cuda)
    got = take_along_axis(tab, idx, axis)
    torch.cuda.synchronize()
    assert torch.equal(got, take_along_axis_plain(tab, idx, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probe", "cycles", "list"])
def test_successor_walk_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(2)
    m = 1 << 18
    if kind == "probe":
        succ = np.where(rng.random(m) < 0.99, rng.integers(0, m, m), -1)
    elif kind == "cycles":
        succ = rng.permutation(m)
    else:
        succ = np.append(np.arange(1, m), -1)
    succ = torch.from_numpy(succ.astype(np.int32)).to(cuda)
    got = successor_walk(succ, 18)
    torch.cuda.synchronize()
    assert torch.equal(got, successor_walk_plain(succ, 18))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probe", "terminal", "cycles"])
@pytest.mark.parametrize("steps", [0, 1, 18, 64])
@pytest.mark.parametrize("m", [5, 1000, 1 << 18, 1 << 21])
def test_successor_walk_sizes_and_steps(cuda, m, steps, kind):
    """The probe's 2^18 entries and a table eight times larger, no hop to 64
    hops, an all-terminal table; successors out of range are clamped, as the
    plain version does."""
    rng = np.random.default_rng(m + steps)
    if kind == "probe":
        succ = np.where(rng.random(m) < 0.99, rng.integers(0, m + 3, m), -1)
    elif kind == "terminal":
        succ = np.full(m, -1)
    else:
        succ = rng.permutation(m)
    succ = torch.from_numpy(succ.astype(np.int32)).to(cuda)
    before = successor_walk.launches
    got = successor_walk(succ, steps)
    assert successor_walk.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, successor_walk_plain(succ, steps))


def _same_ranking(got, want):
    """Exact where the path ends; on cycles succ >= 0 and the same minimum,
    all the callers read there (tpu_debruijn/compress.py:243-245)."""
    res = want[:, 0] < 0
    assert torch.equal(got[res], want[res])
    assert bool((got[~res, 0] >= 0).all())
    assert torch.equal(got[~res, 2], want[~res, 2])


def _carry(rng, succ):
    m = len(succ)
    cols = [succ, succ >= 0, rng.integers(0, 1 << 30, m), np.where(succ < 0, np.arange(m), -1)]
    return torch.from_numpy(np.stack(cols, 1)).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("cyclic", [False, True])
def test_rank_round_kernel_matches_plain(cuda, cyclic):
    """One round (rank_loop with max_rounds = 1), then the whole ranking on
    the card against the plain doubling loop: exact on resolved states, the
    cycle contract on cycles."""
    from tpu_debruijn_torch import compress as TC

    rng = np.random.default_rng(3)
    m = 200_003
    succ = _forest(rng, m, cyclic)
    x = _carry(rng, succ).to(cuda)
    got, rounds = rank_loop(x, 1, early_exit=False)
    want, _ = rank_round_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and rounds.tolist() == [1]
    mnmo = torch.from_numpy(rng.integers(0, 1 << 30, m))
    before = rank_lists.launches
    ranked = TC._rank_all(torch.from_numpy(succ).to(cuda), mnmo.to(cuda))
    assert rank_lists.launches == before + 1
    plain = TC._rank_all(torch.from_numpy(succ), mnmo)
    _same_ranking(torch.stack([g.cpu() for g in ranked], 1), torch.stack(plain, 1))


def _lists(rng, m, n_lists):
    """n_lists random lists over m states."""
    succ = np.full(m, -1, np.int64)
    for part in np.array_split(rng.permutation(m), n_lists):
        succ[part[:-1]] = part[1:]
    return succ


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("max_rounds", [1, 5, None])
@pytest.mark.parametrize("kind", ["ruler_level", "ruler_level_cycles", "in_tree"])
def test_rank_loop_kernel_matches_plain(cuda, kind, max_rounds, early_exit):
    """The persistent loop against the plain loop, every lane and the count
    of rounds: at the ruler-level shape of the E. coli carry (144,769 rows in
    two lists), with cycles, and on an in-tree of 2^20 states (the round
    path's input)."""
    rng = np.random.default_rng(6)
    m = 1 << 20 if kind == "in_tree" else 144_769
    succ = _lists(rng, m, 2) if kind != "ruler_level_cycles" else _forest(rng, m, True)
    if kind == "in_tree":
        live = np.nonzero(succ >= 0)[0]
        succ[live[1]] = succ[live[0]]
    x = _carry(rng, succ).to(cuda)
    x0 = x.clone()
    rounds = max_rounds or math.ceil(math.log2(m + 1))
    want, t = rank_loop_plain(x, rounds, early_exit)
    before = rank_loop.launches
    got, ran = rank_loop(x, rounds, early_exit)
    assert rank_loop.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want) and ran.tolist() == [t]
    assert torch.equal(x, x0)  # the input is only read


@pytest.mark.cuda
def test_rank_loop_grid(cuda):
    """The cooperative grid: the resident blocks of the card (a whole number
    per SM, at most 2048 threads per SM), and no more than the rows need;
    then a loop over more rows than the grid has threads."""
    from tpu_debruijn_torch.kernels.pointer_jump import LOOP_THREADS, rank_loop_grid

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = rank_loop_grid(1 << 30)
    assert resident % sms == 0 and 1 <= resident // sms <= 2048 // LOOP_THREADS
    for m in (1, 255, 1023, 1024, 1025, 144_769, 1 << 20, 9_283_244):
        assert rank_loop_grid(m) == min(-(-m // LOOP_THREADS), resident)
    # a loop as wide as the card, every block resident at once
    rng = np.random.default_rng(9)
    x = _carry(rng, _lists(rng, LOOP_THREADS * resident + 77, 3)).to(cuda)
    got, ran = rank_loop(x, 30)
    want, t = rank_loop_plain(x, 30)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and ran.tolist() == [t]


@pytest.mark.cuda
@pytest.mark.parametrize("spacing", [2, 32])
@pytest.mark.parametrize("kind", ["forest", "chain", "cycles", "in_tree"])
def test_rank_lists_kernels_match_plain(cuda, kind, spacing):
    """The ruling-set kernels against the doubling loop and, lane for lane,
    against their step-for-step transcription; an in-tree takes the round
    path and comes out exact, from one rank_loop launch."""
    from tpu_debruijn_torch.kernels.pointer_jump import rank_lists_rulers_plain

    rng = np.random.default_rng(5)
    m = 100_000
    if kind == "chain":
        order = rng.permutation(m)
        succ = np.full(m, -1, np.int64)
        succ[order[:-1]] = order[1:]
    else:
        succ = _forest(rng, m, kind == "cycles")
    if kind == "in_tree":
        live = np.nonzero(succ >= 0)[0]
        succ[live[1]] = succ[live[0]]
    x = _carry(rng, succ)
    before, loops = rank_lists.round_path, rank_loop.launches
    got = rank_lists(x.to(cuda), spacing).cpu()
    assert rank_lists.round_path == before + (kind == "in_tree")
    # one loop for the ruler level or the round path; one more for cycles
    # without a ruler
    assert rank_loop.launches - loops in ((1,) if kind != "cycles" else (1, 2))
    want = rank_lists_plain(x)
    if kind == "in_tree":
        assert torch.equal(got, want)
    else:
        _same_ranking(got, want)
        assert torch.equal(got, rank_lists_rulers_plain(x, spacing))


@pytest.mark.cuda
def test_ordered_path_cuda_matches_cpu(cuda):
    """obs_min table -> ordered compress: the same chains on the card and
    on the CPU, through the ranking kernels."""
    from tpu_debruijn_torch import compress as TC
    from tpu_debruijn_torch import filter as TF

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 150, 4000)
    reads = [(genome[s : s + 150], 0, 0) for s in starts]
    out = {}
    for dev in ("cpu", cuda):
        table = TF.filter_kmers(reads, 31, min_obs=2, data_reduce="obs_min", device=dev)
        before = rank_lists.launches
        chains, _, _, overflow = TC.compress_kmer_table_device(
            table.spec, False, table.kmers, table.exts, first_pos=table.data
        )
        assert not overflow
        assert (rank_lists.launches > before) == (dev == cuda)
        out[str(dev)] = [t.cpu() for t in (table.data, chains.uid, chains.pos, chains.flip, chains.length)]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 31, 63])
def test_streaming_cuda_matches_cpu(cuda, k):
    """filter_kmers_streaming on the card equals the CPU run: the device
    merge of packed blocks (unpacked on the card) and of per-read tuples,
    the colored count with a negative color, and the host merge."""
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import table_to_numpy

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    rows = np.stack([genome[s : s + 160] for s in rng.integers(0, len(genome) - 160, 600)])
    lengths = rng.integers(k, 161, len(rows)).astype(np.int32)
    packed = rows[:, 0::4] | (rows[:, 1::4] << 2) | (rows[:, 2::4] << 4) | (rows[:, 3::4] << 6)
    reads = [(rows[i, : lengths[i]], 0, (i % 3) - 1) for i in range(len(rows))]
    runs = [
        ([TF.PackedReadBlock(packed, lengths, 160)], dict(merge="device", data_reduce="none")),
        (reads, dict(merge="device", data_reduce="none")),
        (reads, dict(merge="device", data_reduce="none", colored=True)),
        (reads, dict(data_reduce="sum")),
    ]
    for items, kw in runs:
        out = {}
        for dev in ("cpu", cuda):
            got = TF.filter_kmers_streaming(items, k, min_obs=2, chunk_reads=128, device=dev, **kw)
            table, *pairs = got if isinstance(got, tuple) else (got,)
            assert table.kmers.device.type == torch.device(dev).type
            out[str(dev)] = [table_to_numpy(table)] + [p.cpu().numpy() for p in pairs]
        (tc, *pc), (tp, *pp) = out["cuda"], out["cpu"]
        assert len(tp["kmers"]) > 0
        assert all(np.array_equal(tc[x], tp[x]) for x in tp), kw
        assert all(np.array_equal(a, b) for a, b in zip(pc, pp)), kw


def _labeled(k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    genome[3000:3400] = genome[1000:1400]  # a repeat: branches and several unitigs
    starts = rng.integers(0, len(genome) - 120, 800)
    return [(genome[s : s + 120], 0, (i % 4) - 1) for i, s in enumerate(starts)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 31, 63])
def test_policy_entry_points_cuda_match_cpu(cuda, k, tmp_path):
    """The colored / policy path's entry points on the card equal their CPU
    runs (chip_smoke.py's phase 6 harness): tables, pair labels, splits, eq
    classes (both forms), unitigs, color sets, payloads, GFA bytes,
    inferred and censored exts."""
    import chip_smoke

    got = {dev: chip_smoke.policy_outputs(_labeled(k), k, dev, str(tmp_path / f"{dev}.gfa"))
           for dev in ("cuda", "cpu")}
    assert len(got["cpu"]["set_arrays"][0]) > 0
    differ = [name for name, want in got["cpu"].items()
              if not chip_smoke.same_outputs(got["cuda"][name], want)]
    assert not differ, differ


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 31, 63])
def test_sharded_path_cuda_matches_cpu(cuda, k, tmp_path):
    """The sharded path on the card equals its CPU run (chip_smoke.py's phase
    6 harness): assemble_sharded with both stitches, compress_graph of the
    combined shard graphs with censored nodes, and clean_tips, as GFA bytes."""
    import chip_smoke

    reads = [r for r, _, _ in _labeled(k)]
    got = {dev: chip_smoke.sharded_outputs(reads, k, dev, str(tmp_path)) for dev in ("cuda", "cpu")}
    assert len(got["cpu"]["assemble_sharded collective=True"]) > 100
    differ = [name for name, want in got["cpu"].items() if got["cuda"][name] != want]
    assert not differ, differ


@pytest.mark.cuda
def test_two_processes_cuda_match_cpu(cuda, tmp_path):
    """Two gloo processes on the card (assemble_multiprocess, an even split
    of the reads over an 8-shard global mesh) give the same GFA bytes as two
    on the CPU, and both equal one process's assemble_sharded."""
    import chip_smoke
    from tpu_debruijn_torch import parallel as TP

    rng = np.random.default_rng(11)
    reads = chip_smoke.sample_reads(rng, chip_smoke.make_genome(rng, 30_000, True), 30, 150)
    npy = str(tmp_path / "reads.npy")
    np.save(npy, reads)
    got = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        case = {"name": "even", "entry": "multiprocess", "reads": npy,
                "slices": [[0, None, 2], [1, None, 2]]}
        procs = chip_smoke.start_workers(dict(world=2, backend="gloo", device=dev, k=31, p=8,
                                              min_obs=2, timeout=60, out=out, cases=[case]),
                                         str(tmp_path))
        chip_smoke.wait_workers(procs, out, 300)
        got[dev] = [chip_smoke.read_bytes(f"{out}/even_{r}.gfa") for r in range(2)]
    want = chip_smoke.gfa_of(TP.assemble_sharded(reads, 31, 8, min_obs=2, device="cuda"),
                             str(tmp_path / "one.gfa"))
    assert want.count(b"\nS\t") > 10
    assert got["cuda"] == got["cpu"] == [want, want]


@pytest.mark.cuda
def test_compress_graph_cuda_matches_cpu(cuda, tmp_path):
    """compress_graph on the card equals the CPU's under a named and a
    closure reduce, the data join and censored nodes."""
    import tpu_debruijn_torch as T
    from tpu_debruijn_torch import graph as TG

    reads = _labeled(31)
    nodes = T.compress_kmers(T.filter_kmers(reads, 31, min_obs=2, device="cpu"), device="cpu")
    # each unitig cut in two at its middle kmer: nodes that compress_graph joins again
    cut = TG.BaseGraph(31, False)
    for seq, exts, data in nodes:
        h = len(seq) // 2
        if h < 31:
            cut.add(seq, exts, data)
            continue
        cut.add(seq[:h], (exts & 0x0F) | (1 << (4 + int(seq[h]))), data)
        cut.add(seq[h - 30 :], (exts & 0xF0) | (1 << int(seq[h - 31])), data + 1)
    for kw in (dict(), dict(data_reduce="max"), dict(data_reduce=lambda a, b: a + 2 * b),
               dict(join_on_data=True), dict(censor_nodes=[1, 4])):
        out = {}
        for dev in ("cuda", "cpu"):
            g = TG.compress_graph(TG.BaseGraph.combine([cut]).finish(device=dev), device=dev, **kw)
            g.to_gfa(str(tmp_path / f"{dev}.gfa"))
            out[dev] = ((tmp_path / f"{dev}.gfa").read_bytes(), g.data.tolist())
        assert out["cuda"] == out["cpu"], kw


@pytest.mark.cuda
def test_error_path_cuda_matches_cpu(cuda, tmp_path):
    """The error-handling path on reads with sequencing errors (chip_smoke.py's
    phase 6 harness, a 20 kb genome at 30x): the GFA bytes after compress,
    compress_graph, remove_censored_exts and clean_tips(len < 2K) at min_obs
    1 and 2 equal the CPU's, and every kernel of the main path launched on
    the card, one rank_loop a ranking."""
    import chip_smoke
    from tpu_debruijn_torch import kernels as KN

    rng = np.random.default_rng(12)
    genome = chip_smoke.make_genome(rng, chip_smoke.ERR_SMALL_LEN, repeat_rich=False)
    reads = chip_smoke.sample_error_reads(rng, genome, 30, 150)[0]
    counters = {name: getattr(KN, attr) for name, attr in chip_smoke.COUNTERS.items()}
    for fn in counters.values():
        fn.launches = 0
    KN.rank_lists.round_path = 0
    got = chip_smoke.error_outputs(reads, 31, "cuda", str(tmp_path))
    launched = {name: fn.launches for name, fn in counters.items()}
    want = chip_smoke.error_outputs(reads, 31, "cpu", str(tmp_path))
    assert want["min_obs=2 clean_tips"].count(b"\nS\t") > 10
    assert [name for name in want if got[name] != want[name]] == []
    assert all(launched[name] > 0 for name in chip_smoke.ON_PATH), launched
    assert KN.rank_lists.round_path == 0 and launched["rank_loop"] == launched["rank_lists"]


@pytest.mark.cuda
def test_cli_and_walks_cuda_match_cpu(cuda, tmp_path):
    """assemble.run on the card equals its CPU run (chip_smoke.py's phase 6
    harness): GFA and JSON bytes, max_path and max_path_beam, and the arrays
    of the graph's and the table's checkpoints."""
    import chip_smoke

    rng = np.random.default_rng(31)
    fq = str(tmp_path / "reads.fq")
    chip_smoke.write_fastq(fq, chip_smoke.sample_reads(
        rng, chip_smoke.make_genome(rng, 20_000, repeat_rich=True), 15, 150))
    got = {dev: chip_smoke.cli_outputs(fq, dev, str(tmp_path)) for dev in ("cuda", "cpu")}
    assert len(got["cpu"]["max_path_beam"]) > 1 and len(got["cpu"]["gfa"]) > 1000
    assert chip_smoke.same_files(got["cuda"], got["cpu"])


def _scan_scores(rng, kind: str, r: int, n: int) -> torch.Tensor:
    """(r, n) int32 scores: random order keys of a few distinct values (ties
    within windows), the full int32 range (p = 16 keys, negative ones
    included), all equal (poly-A), rising (a rescan every step) or falling."""
    if kind == "few":
        s = rng.integers(-3, 3, (r, n))
    elif kind == "full":
        s = rng.integers(-(1 << 31), 1 << 31, (r, n))
    elif kind == "equal":
        s = np.full((r, n), 7)
    elif kind == "rising":
        s = np.broadcast_to(np.arange(n), (r, n))
    else:
        s = np.broadcast_to(-np.arange(n), (r, n))
    return torch.from_numpy(np.ascontiguousarray(s, dtype=np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["few", "full", "equal", "rising", "falling"])
@pytest.mark.parametrize("r,n,w", [(1000, 153, 24), (77, 153, 24), (3, 3001, 24),
                                   (130, 24, 24), (65, 40, 1), (64, 200, 49)])
def test_msp_scan_kernel_matches_plain(cuda, kind, r, n, w):
    """One launch; whole (R, Lk) arrays against the plain loop, padding
    included: rows staged in shared memory (n <= 191) and rows walked in
    device memory (3001), Lk = 1 (n == w), w = 1, a partial last block."""
    rng = np.random.default_rng(r + n + w)
    scores = _scan_scores(rng, kind, r, n).to(cuda)
    before = msp_scan.launches
    got = msp_scan(scores, w)
    assert msp_scan.launches == before + 1
    want = msp_scan_plain(scores, w)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.shape == x.shape == (r, n - w + 1) and torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,perm", [(31, 8, False), (31, 16, False), (15, 5, True), (63, 12, False)])
def test_msp_scan_batch_on_card(cuda, k, p, perm):
    """msp_scan_batch and the interval table on the card equal the CPU's,
    ranks, scores and the recurrence in one msp_scan_reads launch."""
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import msp as TM

    rng = np.random.default_rng(k * p)
    seqs = [rng.integers(0, 4, int(m)).astype(np.uint8) for m in rng.integers(k - 5, 200, 500)]
    seqs += [np.zeros(150, np.uint8), np.full(150, 3, np.uint8)]
    bases, lengths = TF.pad_reads(seqs, min_len=k, pad_to=16)
    table = rng.permutation(4**p).astype(np.int32) if perm else None
    b, l = torch.from_numpy(bases), torch.from_numpy(lengths)
    before = msp_scan_reads.launches, msp_scan.launches
    got = TM.msp_scan_batch(k, p, b.to(cuda), l.to(cuda), table)
    assert (msp_scan_reads.launches, msp_scan.launches) == (before[0] + 1, before[1])
    for g, x in zip(got, TM.msp_scan_batch(k, p, b, l, table)):
        assert torch.equal(g.cpu(), x)
    iv = TM.msp_intervals_device(k, p, b.to(cuda), l.to(cuda), table)
    want = TM.msp_intervals_device(k, p, b, l, table)
    assert iv["n_intervals"] == want["n_intervals"]
    assert all(torch.equal(iv[f].cpu(), want[f]) for f in want if f != "n_intervals")


def _run_ends(rng, n: int, kind: str) -> np.ndarray:
    if kind == "ones":
        return np.arange(1, n + 1, dtype=np.int64)
    if kind == "one_big":  # one run of 90% of the rows among runs of one
        big = max(1, int(0.9 * n))
        lo = int(rng.integers(0, n - big + 1))
        return np.array([*range(1, lo + 1), lo + big, *range(lo + big + 1, n + 1)], np.int64)
    lens = rng.geometric(1 / 24, n)  # 30x coverage: ~24 rows a kmer
    ends = np.cumsum(lens)
    return np.append(ends[ends < n], n).astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", ["both", "or", "sum"])
@pytest.mark.parametrize("kind", ["random", "ones", "one_big"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 511, 512, 513, 100_000, 3_000_001])
def test_run_reduce_kernel_matches_plain(cuda, n, kind, outputs):
    """One launch over columns of 16-byte packed rows read in place; exts
    bytes with every bit, negative labels; runs of one row, of ~24 and one
    of 90% of the rows."""
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n, 4)).astype(np.int32)).to(cuda)
    ends = torch.from_numpy(_run_ends(rng, n, kind)).to(cuda)
    or_col = rows[:, 2] if outputs != "sum" else None
    sum_col = rows[:, 3] if outputs != "or" else None
    before = run_reduce.launches
    got = run_reduce(ends, or_col, sum_col)
    assert run_reduce.launches == before + 1
    want = run_reduce_plain(ends, or_col, sum_col)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if g is not None:
            assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.cuda
def test_run_reduce_empty_and_refusals(cuda):
    z = torch.zeros(0, dtype=torch.int32, device=cuda)
    e = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = run_reduce.launches
    o, s = run_reduce(e, z, z)
    assert o.shape == s.shape == (0,) and run_reduce.launches == before
    col = torch.ones(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        run_reduce(torch.tensor([8], device=cuda), col)  # int64 column
    with pytest.raises(ValueError):
        run_reduce(torch.tensor([8], dtype=torch.int32, device=cuda), col.int())  # int32 ends


@pytest.mark.cuda
@pytest.mark.parametrize("data_reduce", ["sum", "label_first"])
def test_count_reduces_runs_in_one_launch(cuda, data_reduce):
    """count_kmers on the card makes one run_reduce_rows launch (its whole
    tail, the label sum with "sum") and no run_reduce launch, and gives the
    CPU's table; the colored count is one run_reduce_rows launch and the
    pair rollup one run_reduce launch."""
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import table_to_numpy

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 5_000).astype(np.uint8)
    reads = [(genome[s : s + 150], int(rng.integers(0, 256)), int(rng.integers(-99, 99)))
             for s in rng.integers(0, len(genome) - 150, 600)]
    reads.append((np.zeros(150, np.uint8), 255, -5))  # a poly-A run of 120 observations
    kw = dict(stranded=False, min_obs=1, data_reduce=data_reduce)
    before = run_reduce_rows.launches, run_reduce.launches
    table = TF.filter_kmers(reads, 31, device=cuda, **kw)
    assert (run_reduce_rows.launches, run_reduce.launches) == (before[0] + 1, before[1])
    got, want = table_to_numpy(table), table_to_numpy(TF.filter_kmers(reads, 31, device="cpu", **kw))
    assert all(np.array_equal(got[x], want[x]) for x in got)
    before = run_reduce_rows.launches, run_reduce.launches
    sets = TF.filter_kmers_set_arrays(reads, 31, device=cuda)
    # the pair count, then the rollup
    assert (run_reduce_rows.launches, run_reduce.launches) == (before[0] + 1, before[1] + 1)
    want_sets = TF.filter_kmers_set_arrays(reads, 31, device="cpu")
    got, want = table_to_numpy(sets[0]), table_to_numpy(want_sets[0])
    assert all(np.array_equal(got[x], want[x]) for x in want)
    assert all(torch.equal(g.cpu(), x) for g, x in zip(sets[1:], want_sets[1:]))


# the rows form of run_reduce: run lengths of each kind
TILE_RUNS = [1023, 1024, 1025, 2047, 2048, 2049]  # a tile of 8-word / 4-word rows, +- 1


def _run_lengths(rng, n: int, kind: str) -> np.ndarray:
    if kind == "ones":
        return np.ones(n, np.int64)
    if kind == "one_big":  # one run of 90% of the rows among runs of one
        big = max(1, int(0.9 * n))
        lo = int(rng.integers(0, n - big + 1))
        return np.array([1] * lo + [big] + [1] * (n - lo - big), np.int64)
    if kind == "tile":
        return np.resize(np.array(TILE_RUNS, np.int64), n // 1023 + 1)
    lens = rng.geometric(1 / 24, n)  # 30x coverage: ~24 rows a kmer
    if kind == "long":  # and one run past 65535 rows
        lens[len(lens) // 3] = 70_000
    return lens


def _packed_rows(rng, n: int, w: int, kind: str, by_label: bool = False) -> torch.Tensor:
    """(n, 4 or 8) int32 rows whose keys come in runs of ``kind``: distinct
    neighbouring keys (word 0 a multiplicative hash of the run number), every
    other word random (exts bytes with every bit, negative labels, nonzero
    padding the kernel must ignore); with ``by_label`` labels of four values,
    so label runs split kmer runs."""
    rw = 4 if w <= 2 else 8
    lens = _run_lengths(rng, n, kind)
    run = np.repeat(np.arange(len(lens)), lens)[:n]
    keys = rng.integers(-(1 << 31), 1 << 31, (len(lens), w)).astype(np.int64)
    keys[:, 0] = (np.arange(len(lens), dtype=np.int64) * 2654435761) % (1 << 32)
    rows = rng.integers(-(1 << 31), 1 << 31, (n, rw)).astype(np.int64)
    rows[:, :w] = keys[run]
    if by_label:
        rows[:, w + 1] = rng.integers(-2, 2, n)
    return torch.from_numpy(rows.astype(np.uint32).view(np.int32))


def _rows_both(srows, w, by_label, label_op):
    """The kernel into a separate out and in place, each one launch, against
    the plain version: equal."""
    want = run_reduce_rows_plain(srows.cpu(), w, by_label, label_op,
                                 out=torch.empty_like(srows, device="cpu"))
    before = run_reduce_rows.launches
    out = torch.full_like(srows, -1)
    got = run_reduce_rows(srows, w, by_label, label_op, out=out)
    inplace = run_reduce_rows(srows, w, by_label, label_op)
    assert run_reduce_rows.launches == before + (2 if srows.shape[0] else 0)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and inplace.data_ptr() == srows.data_ptr()
    assert torch.equal(got.cpu(), want) and torch.equal(inplace.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ones", "one_big", "tile", "long"])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 1023, 2048, 2049, 100_000, 3_000_001])
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_run_reduce_rows_kernel_matches_plain(cuda, w, n, kind):
    """One launch over 16- and 32-byte rows; runs of one row, of ~24, of a
    tile +- 1, one of 90% of the rows and one past 65535 rows (the count
    saturates)."""
    rng = np.random.default_rng(n + w)
    _rows_both(_packed_rows(rng, n, w, kind).to(cuda), w, False, "first")


@pytest.mark.cuda
@pytest.mark.parametrize("label_op", ["first", "min", "max", "sum", "none"])
@pytest.mark.parametrize("by_label", [False, True])
@pytest.mark.parametrize("w", [2, 3])
def test_run_reduce_rows_label_ops(cuda, w, by_label, label_op):
    rng = np.random.default_rng(w)
    _rows_both(_packed_rows(rng, 200_000, w, "long", by_label).to(cuda), w, by_label, label_op)


@pytest.mark.cuda
def test_run_reduce_rows_empty_and_refusals(cuda):
    rows = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    before = run_reduce_rows.launches
    assert run_reduce_rows(rows, 1).shape == (0, 4) and run_reduce_rows.launches == before
    with pytest.raises(ValueError):
        run_reduce_rows(torch.zeros((8, 8), dtype=torch.int32, device=cuda)[:, :4], 1)
    with pytest.raises(ValueError):
        run_reduce_rows(torch.zeros((8, 4), dtype=torch.int64, device=cuda), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "poly", "rising"])
@pytest.mark.parametrize("score", ["rc", "forward", "permutation", "tied"])
@pytest.mark.parametrize("r,l,k,p", [(1000, 160, 31, 8), (77, 97, 31, 8), (3, 3001, 31, 8),
                                     (5, 3008, 31, 8),
                                     (130, 31, 31, 8), (500, 160, 31, 16), (200, 160, 15, 5),
                                     (200, 160, 63, 12), (64, 100, 64, 1)])
def test_msp_scan_reads_kernel_matches_plain(cuda, r, l, k, p, score, kind):
    """One launch; whole (R, Lk) arrays against the plain version, padding
    included: 16-byte loads (L = 160, 3008) and byte loads (97, 3001), Lk = 1,
    p = 16 (negative order keys), w = 64 (the ring above 48 KB), a
    permutation table with and without ties, all-equal scores and rising
    ones (a rescan every step)."""
    import chip_smoke

    rng = np.random.default_rng(r + l + k + p)
    perm = None
    if score == "permutation" and p <= 15:
        perm = rng.permutation(4**p).astype(np.int32)
    elif score == "tied" and p <= 15:
        perm = rng.integers(-3, 4, 4**p).astype(np.int32)
    rc = score != "forward"
    if kind == "rising" and p <= 15 and 4**p >= l - p + 1:
        read, perm = chip_smoke.rising_read(l, p)
        bases, rc = np.broadcast_to(read, (r, l)).copy(), False
    elif kind == "poly":
        bases = np.zeros((r, l), np.uint8)
    else:
        bases = rng.integers(0, 4, (r, l)).astype(np.uint8)
    b = torch.from_numpy(bases)
    before = msp_scan_reads.launches
    got = msp_scan_reads(b.to(cuda), k, p, perm, rc)
    assert msp_scan_reads.launches == before + 1
    want = msp_scan_reads_plain(b, k, p, perm, rc)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.shape == x.shape == (r, l - k + 1) and torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["words", "bytes"])
def test_stitch_device_on_card_matches_stitch_flat(cuda, form):
    """The merge's device stitch at the command line's size: 882,000 nodes of
    31-56 bases (~38.8M source bases) in 31,500 unitigs of 28 nodes, a
    third of the nodes flipped, against the host's ``stitch_flat``; prints
    the device milliseconds a call (CUDA events over 5 calls after one)."""
    from tpu_debruijn_torch import compress as TC
    from tpu_debruijn_torch.dna import pack_bases

    k, n, per = 31, 882_000, 28
    rng = np.random.default_rng(21)
    lens = rng.integers(k, k + 26, n).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    flat = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    nodes = rng.permutation(n).astype(np.int64)
    uid = np.arange(n, dtype=np.int64) // per
    pos = np.concatenate([rng.permutation(per) for _ in range(n // per)]).astype(np.int64)
    flip = rng.random(n) < 1 / 3
    nutg = n // per
    want_flat, want_lens = TC.stitch_flat(k, flat, starts, lens, nodes, uid, pos, flip, nutg)
    src = torch.from_numpy(flat if form == "bytes" else pack_bases(flat).view(np.int32))
    args = [k, src.to(cuda)] + [torch.from_numpy(x).to(cuda)
                                for x in (starts, lens, nodes, uid, pos, flip)] + [nutg]
    words, got_lens = TC.stitch_device(*args)
    assert torch.equal(got_lens.cpu(), torch.from_numpy(want_lens))
    assert np.array_equal(words.cpu().numpy().view(np.uint32), pack_bases(want_flat))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        TC.stitch_device(*args)
    end.record()
    torch.cuda.synchronize()
    print(f"stitch_device {form}: {len(flat)} source bases, {len(want_flat)} out, "
          f"{start.elapsed_time(end) / 5:.4f} ms a call")
