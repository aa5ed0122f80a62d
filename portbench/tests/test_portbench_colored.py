"""The colored cell's own files: the strain generator, the colored reference
(plain PyTorch, nothing of the program), the configuration under the checks
every configuration gets, whole runs on the CPU at a small genome, and
faults the comparison has to catch."""

import json

import pytest
import torch

import test_portbench_cells as cells
from conftest import SMALL_GENOME
from portbench import generate, harness, job, strains, trace
from test_portbench_imports import FORBIDDEN, python

CELL = "strains4_err_k31.colored"
SEED = 2**31 + 2**30 + 777  # wider than 32 signed bits
METRICS = ["strains4.pad_s", "strains4.pairs_s", "strains4.pair_table_s", "strains4.eq_classes_s",
           "strains4.fold_sets_s", "strains4.clean_s", "strains4.device_idle_pct"]


def cell():
    return harness.load_cell(harness.ROOT, CELL)


def run(traced=False, seed=SEED):
    return harness.run_cell(cell(), seed, 0.05, traced, "cpu", genome_length=SMALL_GENOME)


def test_reference_colored_loads_nothing_of_the_program():
    got = python(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference_colored, portbench.strains, portbench.job\n"
        "portbench.job.load('colored')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('tpu_debruijn')), "
        f"sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN}))")
    assert got == "[] []"


def test_strains_are_the_seeds_and_in_four_labelled_parts():
    cfg = cell().config
    host = generate.error_reads(cfg, SEED, "cpu", SMALL_GENOME)
    a, la = strains.labelled_reads(cfg, host.numpy(), "cpu")
    b, lb = strains.labelled_reads(cfg, host, "cpu")
    other = generate.error_reads(cfg, SEED + 1, "cpu", SMALL_GENOME)
    c, lc = strains.labelled_reads(cfg, other, "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert a.shape == host.shape == c.shape and a.dtype == torch.uint8 and int(a.max()) <= 3
    n = host.shape[0]
    sizes = strains.part_sizes(n, 4)
    assert sum(sizes) == n and max(sizes) - min(sizes) <= 1
    assert torch.equal(la, torch.repeat_interleave(torch.arange(4, dtype=torch.int32),
                                                   torch.tensor(sizes)))
    assert torch.equal(la, lc) and not torch.equal(a, c)
    assert strains.strain_seed(host) != strains.strain_seed(other)
    assert strains.ancestor_length(cfg, n) == SMALL_GENOME
    assert strains.ancestor_length(cfg, 1_856_661) == cfg["genome"]["length"]


def test_strains_differ_by_their_substitutions(monkeypatch):
    """Each strain is the ancestor with its own glen // snp_every
    substitutions: read them off the strains the generator samples."""
    cfg = cell().config
    host = generate.error_reads(cfg, SEED, "cpu", SMALL_GENOME)
    made = []
    orig = generate._block

    def block(r, genome, n, gen):
        made.append(genome.clone())
        return orig(r, genome, n, gen)
    monkeypatch.setattr(generate, "_block", block)
    strains.labelled_reads(cfg, host, "cpu", block=1 << 30)
    assert len(made) == 4
    snps = SMALL_GENOME // cfg["strains"]["snp_every"]
    for i in range(4):
        for j in range(i + 1, 4):
            diff = int((made[i] != made[j]).sum())
            assert snps < diff <= 2 * snps


@pytest.mark.parametrize("check", ["config_file", "resolves", "kind"])
def test_new_config_passes_the_cells_checks(check):
    (cfg,) = [c for c in cells.BENCH["configs"] if c["name"] == "strains4_err_k31"]
    if check == "config_file":
        cells.test_config_file(cfg)
        assert cfg["reduced"] == [] and cfg["source"] == "https://doi.org/10.1038/ng.1028"
    elif check == "resolves":
        cells.test_cell_resolves_its_files(CELL)
        for entry in [cfg] + [w for w in cells.BENCH["workloads"] if w["name"] == CELL]:
            cells.test_names_and_units(entry)
    else:
        cells.test_cell_finds_its_kind_of_job_by_name(CELL)


def test_run_is_correct():
    result, limits = run()
    assert result["correct"] and result["failed"] == 0, limits
    assert set(limits) == {"table", "sets", "censor", "unitigs", "unitig_sets", "cleaned", "gfa",
                           "jobs"}
    assert set(result["metrics"]) == {"assembly_s", "peak_device_GB", "setup_s"}
    json.dumps(result)


def test_traced_run_reports_its_metrics(monkeypatch):
    def fake(prof, tmp, kernels, spans):
        return trace.Summary(busy_s=0.01, window_s=0.02, kernels={}, device_ops=[["k", 0.01]],
                             idle_gaps=[["count", 0.01]])
    monkeypatch.setattr(trace, "read", fake)
    result, _ = run(traced=True)
    assert result["correct"]
    # device_idle_pct has no list of cells, so this cell reports it too
    assert set(result["metrics"]) == set(METRICS) | {"device_idle_pct"}
    assert result["metrics"]["device_idle_pct"] == result["metrics"]["strains4.device_idle_pct"]


def fault_default_clean(mp):
    """clean_tips re-joins across sets (the policy not handed on)."""
    from tpu_debruijn_torch import clean as TCL
    orig = TCL.clean_tips
    mp.setattr(TCL, "clean_tips", lambda g, p, *, spec=None, **kw: orig(g, p, **kw))


def fault_one_label(mp):
    """Every read counted under label 0."""
    from tpu_debruijn_torch import filter as TF
    orig = TF._read_batch
    mp.setattr(TF, "_read_batch", lambda spec, items, device, labels=None: orig(
        spec, [(r, e, 0) for r, e, _ in items], device, labels))


def fault_no_set_join(mp):
    """Unitigs joined whatever their sets."""
    from tpu_debruijn_torch import compress as TC
    orig = TC.compress_kmers_color_sets
    mp.setattr(TC, "compress_kmers_color_sets", lambda *a, join_on_sets=False, **kw: orig(
        *a, join_on_sets=False, **kw))


def fault_untagged(mp):
    """The GFA written without its tags."""
    from tpu_debruijn_torch import graph as TG
    mp.setattr(TG.DebruijnGraph, "to_gfa_with_tags", lambda self, path, tag: self.to_gfa(path))


FAULTS = {"default_clean": fault_default_clean, "one_label": fault_one_label,
          "no_set_join": fault_no_set_join, "untagged": fault_untagged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, limits = run()
    assert not result["correct"], limits
