"""The control of the comparison that decides ``correct``.

The control is the reference put in the program's place with one of the
configuration's guarantees broken: a kmer's exts are those of its first
observation, not the OR over all of them (the step a count that skips its
reduction would take).  Its outputs go through each cell's comparison; the
control must come out not correct.  On the card, at the cells' own size:

    python3 portbench/control.py --seeds 11 12 13

prints, for each seed, one JSON line with every cell's numbers (the
program's runs give 0 on each).  The CPU tests run the same at a small
genome.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import generate  # noqa: E402
from portbench import harness  # noqa: E402
from portbench import job  # noqa: E402


def readings(cell, reads: torch.Tensor) -> dict:
    """The cell's numbers for the control on ``reads``: its kind of job's
    ``control`` (``jobs/<entry>.py``)."""
    return job.load(cell.traffic["entry"]).control(cell.config, reads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workloads", nargs="*", default=None)
    args = ap.parse_args(argv)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        names = args.workloads or [w["name"] for w in json.load(f)["workloads"]]
    cells = [harness.load_cell(harness.ROOT, n) for n in names]
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        line = {"seed": seed, "device": torch.cuda.get_device_name()}
        by_config = {}
        for cell in cells:
            key = cell.config["name"]
            if key not in by_config:
                by_config[key] = generate.error_reads(cell.config, seed, "cuda")
            line[cell.name] = readings(cell, by_config[key])
        print(json.dumps(line), flush=True)
        by_config.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
