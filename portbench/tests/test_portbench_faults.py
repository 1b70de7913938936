"""The check catches a broken timed path, and its control: a whole run at
a small size on the CPU (the look for a card skipped) with the program
broken underneath comes out not correct, and so does the control."""

import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from portbench import control, harness

SMALL = {"snp-paper.multisurf": {"n_samples": 160, "n_features": 256,
                                 "phenotypes": 3},
         "snp-paper.multisurf-resident": {"n_samples": 160,
                                          "n_features": 256,
                                          "phenotypes": 3},
         "large-n.relieff": {"n_samples": 300, "n_features": 16},
         "large-n.multisurf": {"n_samples": 300, "n_features": 16}}


class Faulty:
    """The mix's estimator with one fault planted in its answer."""
    last = None

    def __init__(self, make, fault):
        self.make, self.fault = make, fault

    def fit(self, x, y):
        if self.fault == "unchanged" and Faulty.last is not None:
            # the fit returns the state it had: the last fit's answer
            self.feature_importances_, self.top_features_ = Faulty.last
            return self
        est = self.make()
        if self.fault == "half_batch":
            # half of the rows left out, the mean taken over the rest
            half = x.shape[0] // 2
            est.fit(x[:half], y[:half])
        else:
            est.fit(x, y)
        imp = np.array(est.feature_importances_)
        top = np.array(est.top_features_)
        if self.fault == "score_altered":
            imp[np.argmax(np.abs(imp))] *= 1.05
        if self.fault == "top_altered":
            top[-1] = int(np.argmin(imp))
        self.feature_importances_, self.top_features_ = imp, top
        Faulty.last = (imp, top)
        return self


def run(cell, fault=None, seed=2**31 + 77):
    c = harness.load_cell(cell)
    make = harness.estimator_factory(c.mix)
    Faulty.last = None
    maker = make if fault is None else (lambda: Faulty(make, fault))
    return harness.run_cell(c, seed, 0.5, False, "cpu", time.perf_counter(),
                            make=maker, overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "score_altered", "top_altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    line = run(cell, fault)
    assert line["correct"] is False, line["checks"]


@pytest.fixture
def staged_on_cpu(monkeypatch):
    """The program's half-width staging, a CUDA path, rehearsed on the
    CPU at a small size (as the port's own tests rehearse it)."""
    from fastselect_tpu_torch.models import _relief_base
    monkeypatch.setattr(_relief_base, "_STAGED_DEVICE_TYPES",
                        ("cuda", "cpu"))
    monkeypatch.setattr(_relief_base, "_STAGED_MIN_ELEMS", 0)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(cell, staged_on_cpu):
    buf = io.StringIO()
    with redirect_stdout(buf):
        control.main(["--workload", cell, "--seeds", "11", "12",
                      "--control-seeds", "13", "14"], device="cpu",
                     overrides=SMALL[cell])
    limit = harness.load_cell(cell).limits["numbers"]["score_gap"]["limit"]
    rows = [json.loads(r) for r in buf.getvalue().splitlines()]
    assert [r["kind"] for r in rows] == ["program"] * 2 + ["control"] * 2
    for r in rows:
        ok = r["score_gap"] <= limit and r["top_miss"] == 0
        assert ok == (r["kind"] == "program"), r
