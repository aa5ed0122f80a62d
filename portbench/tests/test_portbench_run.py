"""Whole runs of each cell on the CPU at a small genome: the result line,
the comparison, the control and the faults the comparison has to catch."""

import json

import numpy as np
import pytest
import torch

from conftest import SMALL_GENOME
from portbench import control, generate, harness, trace

CELLS = ["ecoli_err_k31.library", "ecoli_err_k31_msp8.sharded", "ecoli_err_k31.cli"]
SEED = 2**31 + 2**30 + 12345  # wider than 32 signed bits


def run(cell, seed=SEED, traced=False):
    c = harness.load_cell(harness.ROOT, cell)
    return harness.run_cell(c, seed, 0.05, traced, "cpu", genome_length=SMALL_GENOME)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_and_line_has_the_keys(cell, capsys):
    result, limits = run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(v == 0 and lim == 0 for v, lim in limits.values())
    c = harness.load_cell(harness.ROOT, cell)
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(result)
    assert "portbench reference" in capsys.readouterr().err


def test_traced_line_has_breakdown(monkeypatch):
    def fake(prof, tmp, kernels, spans):
        return trace.Summary(busy_s=0.01, window_s=0.02, kernels={}, device_ops=[["k", 0.01]],
                             idle_gaps=[["count", 0.01]])
    monkeypatch.setattr(trace, "read", fake)
    result, _ = run("ecoli_err_k31.library", traced=True)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"count_s", "compress_s", "graph_s", "device_idle_pct"} <= set(result["metrics"])
    # no device launches on the CPU: the rooflines find nothing to read
    assert not any(n.endswith("_roofline") for n in result["metrics"])


def test_same_seed_same_reads():
    cfg = harness.load_cell(harness.ROOT, CELLS[0]).config
    a = generate.error_reads(cfg, SEED, "cpu", SMALL_GENOME)
    b = generate.error_reads(cfg, SEED, "cpu", SMALL_GENOME)
    c = generate.error_reads(cfg, SEED + 1, "cpu", SMALL_GENOME)
    assert torch.equal(a, b) and a.shape == c.shape and not torch.equal(a, c)
    assert a.shape == (-(-30 * SMALL_GENOME // 150), 150) and int(a.max()) <= 3


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_is_not_correct(cell, seed):
    c = harness.load_cell(harness.ROOT, cell)
    reads = generate.error_reads(c.config, seed, "cpu", SMALL_GENOME)
    got = control.readings(c, reads)
    assert any(v > 0 for v in got.values()), got
    assert got["cleaned"] > 0 and got["jobs"] == 1


def _half_rows(fn):
    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        n = out[0].shape[0] // 2
        return tuple(x[:n] for x in out)
    return wrapper


def fault_unchanged(mp):
    """clean_tips returns the graph it was given."""
    from tpu_debruijn_torch import assemble as TA, clean as TCL
    mp.setattr(TCL, "clean_tips", lambda g, *a, **kw: g)
    mp.setattr(TA, "clean_tips", lambda g, *a, **kw: g)


def fault_half_batch(mp):
    """Half of the reads left out of the count."""
    from tpu_debruijn_torch import filter as TF
    mp.setattr(TF, "pad_reads", _half_rows(TF.pad_reads))
    mp.setattr(TF, "_read_batch", _half_rows(TF._read_batch))


def fault_no_exchange(mp):
    """The exchange left out: each shard keeps the intervals its own
    source block made."""
    from tpu_debruijn_torch.parallel import shard
    orig = shard.exchange

    def stay(dest, n_shards, columns, *a, **kw):
        own = torch.arange(dest.shape[0], device=dest.device) * n_shards // max(1, dest.shape[0])
        return orig(own, n_shards, columns, *a, **kw)
    mp.setattr(shard, "exchange", stay)


def fault_altered(mp):
    """One base of one unitig altered where the unitigs are made."""
    from tpu_debruijn_torch import compress as TC
    orig_c, orig_s = TC.compress_kmers, TC.stitch_flat

    def compress(*a, **kw):
        nodes = orig_c(*a, **kw)
        seq, e, d = nodes[0]
        seq = np.array(seq, np.uint8)
        seq[0] = (seq[0] + 1) & 3
        return [(seq, e, d)] + nodes[1:]

    def stitch_flat(*a, **kw):  # the sharded path's final unitigs
        flat, lengths = orig_s(*a, **kw)
        flat = np.array(flat, np.uint8)
        flat[0] = (flat[0] + 1) & 3
        return flat, lengths
    mp.setattr(TC, "compress_kmers", compress)
    mp.setattr(TC, "stitch_flat", stitch_flat)


FAULTS = {"unchanged": fault_unchanged, "half_batch": fault_half_batch,
          "no_exchange": fault_no_exchange, "altered": fault_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS if f != "no_exchange" or "sharded" in c]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, limits = run(cell)
    assert not result["correct"], limits
