"""BENCHMARK.json against the contract's shape, and every cell's files by name."""

import json
import os
import re

import pytest
import torch

from portbench import harness, job, readers, roofline

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_names_unique_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = harness.load_cell(harness.ROOT, cell)
    assert c.chips == 1
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(readers.load(m["name"]).read)
        if "moves" in m:
            assert m["moves"] in e2e, f"{m['name']} moves a metric {cell} does not report"
        if m["name"].endswith("_roofline"):
            mod = roofline.kernel(m["name"].removesuffix("_roofline"))
            assert mod.KERNEL and callable(mod.job_bytes) and callable(mod.launches)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert path.startswith(os.path.join(harness.ROOT, "portbench") + os.sep)
    c = json.load(open(path))
    assert c["name"] == config["name"] and c["source"] == config["source"]
    assert c["reduced"] == config["reduced"]
    assert c["assumed"] and c["guarantees"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_kind_of_job_by_name(cell):
    c = harness.load_cell(harness.ROOT, cell)
    kind = job.load(c.traffic["entry"])
    assert issubclass(kind.Job, job.Job)
    for fn in ("reference", "sizes", "control"):
        assert callable(getattr(kind, fn))


def test_untraced_spans_record_nothing(monkeypatch):
    synced = []
    monkeypatch.setattr(harness, "_sync", lambda device: synced.append(device))
    out = {}
    with harness.Spans(torch.device("cpu"), False).into(out)("count"):
        pass
    assert out == {} and synced == []
    with harness.Spans(torch.device("cpu"), True).into(out)("count"):
        pass
    assert set(out) == {"count"} and len(synced) == 2
