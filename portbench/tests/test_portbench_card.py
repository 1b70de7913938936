"""On a card: every cell at a small size through the whole run, the
kernels included.  Skips without a CUDA device.

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

import time

import pytest

from portbench import harness

SMALL = {"snp-paper.multisurf": {"n_samples": 4096, "n_features": 4096},
         "snp-paper.multisurf-resident": {"n_samples": 4096,
                                          "n_features": 4096},
         "large-n.relieff": {"n_samples": 4096, "n_features": 100},
         "large-n.multisurf": {"n_samples": 4096, "n_features": 100}}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_run_on_the_card(card, cell, trace):
    c = harness.load_cell(cell)
    line = harness.run_cell(c, 2**31 + 5, 1.0, trace, card,
                            time.perf_counter(), overrides=SMALL[cell])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert all(v["value"] <= 105 for k, v in line["metrics"].items()
                   if k.endswith("_pct"))
