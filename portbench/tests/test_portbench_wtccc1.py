"""wtccc1.multisurf-resident rehearsed on the CPU at small sizes: a sound
run is correct, and one with the control (the reference in bfloat16) in
the program's place is not; control.py reads the program within the limit
and the control past it."""

import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import torch

import test_portbench_spans
from portbench import control, harness
from portbench.reference.relief import relief_scores

CELL = "wtccc1.multisurf-resident"
SMALL = {"n_samples": 600, "n_cases": 240, "n_features": 256}
# test_portbench_spans.py rehearses every cell at a small size that it
# finds by configuration: wtccc1's reaches v2 on the CPU (TI 4,096, n_pad
# 8,192) with its first block across the class boundary, so that the span
# discrete.straddle exists
test_portbench_spans.SMALL.setdefault("wtccc1", {"n_samples": 4200,
                                                 "n_cases": 1680,
                                                 "n_features": 256})


class Bfloat16Reference:
    """The control in the program's place: the reference's scores computed
    in bfloat16, and their top features."""

    def fit(self, x, y):
        s = relief_scores(x, [y], algo="multisurf", dtype=torch.bfloat16)[0]
        self.feature_importances_ = s
        self.top_features_ = np.argsort(s)[::-1][:10].copy()
        return self


def run(make=None, seed=2**31 + 4077):
    c = harness.load_cell(CELL)
    return harness.run_cell(c, seed, 0.5, False, "cpu", time.perf_counter(),
                            make=make, overrides=SMALL)


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["fits_checked"]["value"] >= 2


def test_bfloat16_reference_is_not_correct():
    line = run(make=Bfloat16Reference)
    assert line["correct"] is False, line["checks"]


def test_control_fails_and_program_passes():
    buf = io.StringIO()
    with redirect_stdout(buf):
        control.main(["--workload", CELL, "--seeds", "11",
                      "--control-seeds", "13"], device="cpu",
                     overrides=SMALL)
    limit = harness.load_cell(CELL).limits["numbers"]["score_gap"]["limit"]
    rows = [json.loads(r) for r in buf.getvalue().splitlines()]
    assert [r["kind"] for r in rows] == ["program", "control"]
    for r in rows:
        ok = r["score_gap"] <= limit and r["top_miss"] == 0
        assert ok == (r["kind"] == "program"), r
