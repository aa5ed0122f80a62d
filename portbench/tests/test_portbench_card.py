"""A traced run of each cell on the card at a small genome (marked ``cuda``):
python -m pytest -q -p no:cacheprovider portbench/tests -m cuda"""

import pytest

from conftest import SMALL_GENOME
from portbench import harness

CELLS = ["ecoli_err_k31.library", "ecoli_err_k31_msp8.sharded", "ecoli_err_k31.cli"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cuda, cell):
    c = harness.load_cell(harness.ROOT, cell)
    result, _ = harness.run_cell(c, 2**31 + 7, 1.0, True, cuda, genome_length=10 * SMALL_GENOME)
    assert result["correct"], result["checks"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert set(result["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
