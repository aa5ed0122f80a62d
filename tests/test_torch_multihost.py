"""Port parity for parallel.multihost: the sharded assembly over two real
processes joined by torch.distributed (gloo, CPU).

One module fixture spawns two fresh interpreters (chip_smoke.start_workers:
they import the port and nothing of JAX) on a file rendezvous, each running
every case of the spec; the tests read their GFA bytes, shard tables and
stats.  The reads are test_torch_sharded's contig reads (200 reads of 60 bp,
k = 31, p = 8, min_obs = 2, 8 shards, 4 a process).  Every multi-process
graph must equal, byte for byte in GFA, JAX's assemble_multiprocess (one
process on the 8 virtual CPU devices of tests/conftest.py) and the port's
one-process assemble_sharded."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from test_torch_sharded import CAP, K, P, contig_reads, gfa_bytes
from tpu_debruijn.parallel.multihost import assemble_multiprocess as jax_assemble_multiprocess
from tpu_debruijn_torch import parallel as TP

CPU = "cpu"
EVEN = [[0, None, 2], [1, None, 2]]
CASES = {
    "even": {"entry": "multiprocess", "slices": EVEN},
    "rank1_empty": {"entry": "multiprocess", "slices": [[0, None, 1], [0, 0, 1]]},
    "cap16": {"entry": "multiprocess", "slices": EVEN, "kwargs": {"cap_per_dest": 16}},
    "multihost": {"entry": "multihost"},
}


@pytest.fixture(scope="module")
def reads():
    return contig_reads(np.random.default_rng(8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reads):
    """The two workers' records and outputs, and the one-process graphs of
    JAX and of the port, computed while the workers run."""
    path = tmp_path_factory.mktemp("multihost")
    tmp = str(path)
    arr = np.stack(reads)
    npy = os.path.join(tmp, "reads.npy")
    np.save(npy, arr)
    files = []
    for i, part in enumerate(np.array_split(arr, 3)):
        files.append(os.path.join(tmp, f"part{i}.fq"))
        chip_smoke.write_fastq(files[-1], part)
    out = os.path.join(tmp, "out")
    cases = [{"name": name, "reads": npy, "files": files, **case} for name, case in CASES.items()]
    for case in cases[:3]:
        del case["files"]
    cases.append({"name": "tables", "entry": "tables", "files": files})
    procs = chip_smoke.start_workers(dict(world=2, backend="gloo", device=CPU, k=K, p=P, min_obs=2,
                                          timeout=60, out=out, cases=cases), tmp)
    try:
        jax_graph = jax_assemble_multiprocess(reads, K, P, min_obs=2, cap_per_dest=CAP)
        want = {"jax": gfa_bytes(jax_graph, path / "jax.gfa")}
        one_stats = {}
        port = TP.assemble_sharded(reads, K, P, min_obs=2, mesh=TP.make_mesh(8, device=CPU),
                                   device=CPU, stats=one_stats)
        want["port"] = gfa_bytes(port, path / "port.gfa")
    finally:
        records = chip_smoke.wait_workers(procs, out, 120)
    return {"records": records, "out": out, "files": files, "want": want,
            "one_stats": one_stats}


def rank_gfa(runs, name: str) -> list:
    return [chip_smoke.read_bytes(os.path.join(runs["out"], f"{name}_{r}.gfa")) for r in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_equal_one(runs, name):
    """(a) an even split, (b) rank 1 with no reads, (c) cap_per_dest=16
    (accepted and unused), (d) assemble_multihost over 3 FASTQ files: both
    ranks' GFA bytes are equal, and equal JAX's assemble_multiprocess and
    the port's assemble_sharded."""
    got = rank_gfa(runs, name)
    assert got[0] == got[1]
    assert got[0].count(b"\nS\t") > 10
    assert got[0] == runs["want"]["jax"]
    assert got[0] == runs["want"]["port"]


def test_local_read_slice(runs):
    """(d) round-robin by rank: rank 0 reads files 0 and 2, rank 1 file 1;
    without a process group every file."""
    files = runs["files"]
    slices = [rec["cases"]["multihost"]["slice"] for rec in runs["records"]]
    assert slices == [[files[0], files[2]], [files[1]]]
    assert not dist.is_initialized()
    assert TP.local_read_slice(files) == files


def test_shard_tables_equal_one_process(runs, reads):
    """Global shard r * 4 + s is rank r's local shard s, and equals the
    one-process mesh's shard bit for bit."""
    _, tables, *_ = TP.sharded_tables(reads, K, P, min_obs=2, mesh=TP.make_mesh(8, device=CPU),
                                      device=CPU)
    for r in range(2):
        z = np.load(os.path.join(runs["out"], f"tables_{r}.npz"))
        for s in range(4):
            want = tables[4 * r + s]
            assert len(want) > 0
            for col in ("kmers", "exts", "counts"):
                assert np.array_equal(z[f"{col}_{s}"], getattr(want, col).numpy()), (r, s, col)


def test_multiprocess_stats(runs):
    """Every rank's stats: its 4 shards' intervals and unitigs, which over
    both ranks are the one-process run's; bytes sent to the other process
    and the two all-gathers' bytes; a rank with no reads scans nothing and
    sends nothing."""
    one = runs["one_stats"]
    even = [rec["cases"]["even"]["stats"] for rec in runs["records"]]
    assert [st["intervals"] for st in even] == [one["intervals"][:4], one["intervals"][4:]]
    assert [st["shard_unitigs"] for st in even] == [one["shard_unitigs"][:4],
                                                     one["shard_unitigs"][4:]]
    for st in even:
        assert st["exchange_bytes"] > 0
        assert len(st["gather_bytes"]) == len(st["gather_s"]) == 2
        assert min(st["gather_bytes"]) > 0
        assert len(st["count_s"]) == len(st["compress_s"]) == 4
    empty = [rec["cases"]["rank1_empty"]["stats"] for rec in runs["records"]]
    assert empty[1]["exchange_bytes"] == 0 and "msp_s" not in empty[1]
    assert empty[0]["exchange_bytes"] > 0
    assert [st["intervals"] for st in empty] == [one["intervals"][:4], one["intervals"][4:]]
    assert all(rec["backend"] == "gloo" for rec in runs["records"])


def test_no_process_group_is_assemble_sharded(reads, tmp_path):
    """(e) Without a process group, global_mesh is make_mesh, initialize of
    one process does nothing, and assemble_multiprocess is assemble_sharded."""
    TP.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()
    assert TP.global_mesh(device=CPU) == TP.make_mesh(8, device=CPU)
    got = TP.assemble_multiprocess(reads, K, P, min_obs=2, device=CPU)
    want = TP.assemble_sharded(reads, K, P, min_obs=2, device=CPU)
    assert gfa_bytes(got, tmp_path / "got.gfa") == gfa_bytes(want, tmp_path / "want.gfa")


def test_global_mesh_over_processes(monkeypatch):
    """(f) A global mesh over 4 processes gives each a contiguous block of
    shards, and refuses 6 shards."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    mesh = TP.global_mesh(8, device=CPU)
    assert (mesh.rank, mesh.world, mesh.distributed, mesh.local) == (1, 4, True, range(2, 4))
    assert mesh.device == torch.device(CPU)
    with pytest.raises(ValueError, match="split evenly"):
        TP.global_mesh(6, device=CPU)
    with pytest.raises(ValueError, match="distributed"):
        TP.LogicalMesh(8, torch.device(CPU), 0, 2)
