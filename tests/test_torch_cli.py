"""The port's command line (``tpu_debruijn_torch.assemble``) against the JAX
package's ``scripts/assemble.py``, both run in this process on the CPU:
the same GFA bytes, JSON bytes and stderr summary lines in the default,
``--clean-tips``, ``--streaming`` and ``--sharded`` modes."""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tpu_debruijn_torch import assemble
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch.clean import clean_tips
from tpu_debruijn_torch.io import read_fastx

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_main():
    spec = importlib.util.spec_from_file_location("jax_assemble_script", ROOT / "scripts" / "assemble.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """A 3 kb random genome at ~25x in 100 bp reads, half reverse-
    complemented, a few of them with one substitution (tips at min_obs 1),
    and reads shorter than K that every mode drops."""
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    lines = []
    for i in range(760):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s : s + 100].copy()
        if i % 40 == 7:
            r[int(rng.integers(40, 60))] ^= 1
        if i % 2:
            r = (3 - r[::-1]).astype(np.uint8)
        if i % 97 == 3:
            r = r[:20]
        seq = "".join("ACGT"[b] for b in r)
        lines += [f"@r{i}", seq, "+", "I" * len(seq)]
    path = tmp_path_factory.mktemp("cli") / "reads.fq"
    path.write_text("\n".join(lines) + "\n")
    return path


MODES = {
    "default": [],
    "clean_tips": ["--clean-tips", "--min-obs", "1"],
    "streaming": ["--streaming", "--memory-gb", "0.001", "--max-records", "700"],
    "sharded": ["--sharded", "-p", "8"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_reference(mode, fastq, tmp_path, monkeypatch, capsys):
    out = {}
    for name in ("jax", "torch"):
        argv = [str(fastq), "-o", str(tmp_path / f"{name}.gfa"), "--json",
                str(tmp_path / f"{name}.json"), *MODES[mode]]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["assemble.py", *argv])
            assert _jax_main()() == 0
        else:
            stats = {}
            graph = assemble.run([*argv, "--device", "cpu"], stats=stats)
            assert len(graph) > 0 and stats["export_s"][0] >= 0
        out[name] = ((tmp_path / f"{name}.gfa").read_bytes(), (tmp_path / f"{name}.json").read_bytes(),
                     capsys.readouterr().err.splitlines())
    assert out["torch"] == out["jax"]
    assert out["torch"][2][-1].startswith("total ") and len(out["torch"][0]) > 1000
    if mode == "clean_tips":
        assert b"\nL\t" in out["torch"][0]  # the substitutions leave branches after tip cleaning


@pytest.mark.parametrize("mode", ["default", "clean_tips"])
def test_cli_builds_graph_from_flat_buffers(mode, fastq, tmp_path, monkeypatch):
    """run() builds its graph from the device compression's flat buffers:
    with the per-unitig tuple route made to raise, it writes the GFA and
    JSON bytes of a compress_kmers + from_compress_output graph of the same
    table."""
    k, min_obs = 31, (1 if mode == "clean_tips" else 2)
    reads = [r for r in read_fastx(str(fastq)) if len(r) >= k]
    table = TF.filter_kmers([(r, 0, 0) for r in reads], k, min_obs=min_obs, device="cpu")
    graph = TG.from_compress_output(k, False, TC.compress_kmers(table, device="cpu"))
    graph = graph.finish(device="cpu")
    if mode == "clean_tips":
        graph = clean_tips(graph, lambda node: node.len() < 2 * k, device="cpu")
    graph.to_gfa(str(tmp_path / "want.gfa"))
    with open(tmp_path / "want.json", "w") as f:
        graph.to_json(lambda d: d, f)

    def refuse(*a, **kw):
        raise AssertionError("the command line made a tuple a unitig")
    monkeypatch.setattr(TC, "_nodes", refuse)
    monkeypatch.setattr(TG, "from_compress_output", refuse)
    argv = [str(fastq), "-o", str(tmp_path / "got.gfa"), "--json", str(tmp_path / "got.json"),
            *MODES[mode], "--device", "cpu"]
    stats = {}
    assert len(assemble.run(argv, stats=stats)) == len(graph) > 0
    assert len(stats["compress.nodes_s"]) == len(stats["graph.add_s"]) == 1
    for ext in ("gfa", "json"):
        assert (tmp_path / f"got.{ext}").read_bytes() == (tmp_path / f"want.{ext}").read_bytes()


def test_cli_without_reads(tmp_path, capsys):
    (tmp_path / "short.fa").write_text(">a\nACGT\n")
    argv = [str(tmp_path / "short.fa"), "-o", str(tmp_path / "x.gfa"), "--device", "cpu"]
    assert assemble.run(argv) is None and assemble.main(argv) == 1
    assert capsys.readouterr().err.splitlines() == ["no reads of length >= K"] * 2
    assert not (tmp_path / "x.gfa").exists()


def test_cli_module_entry_point(fastq, tmp_path):
    """``python -m tpu_debruijn_torch.assemble`` writes the GFA that run() does."""
    res = subprocess.run([sys.executable, "-m", "tpu_debruijn_torch.assemble", str(fastq), "-o",
                          str(tmp_path / "m.gfa"), "--device", "cpu", "-k", "25"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    assert "unitigs" in res.stderr
    assemble.run([str(fastq), "-o", str(tmp_path / "r.gfa"), "--device", "cpu", "-k", "25"])
    assert (tmp_path / "m.gfa").read_bytes() == (tmp_path / "r.gfa").read_bytes()
