"""large-p.multisurf rehearsed on the CPU at a small size (100 x 8,192,
where pass 1 splits 64 feature ranges and D is about 1,800): a sound run
is correct, and one with the one-pass float32 threshold rule in the
program's place is not; the control fails and the program passes."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

import test_portbench_spans
from portbench import control, harness

CELL = "large-p.multisurf"
SMALL = {"n_samples": 100, "n_features": 8192}
# test_portbench_spans.py rehearses every cell at a small size that it
# finds by configuration; large-p's is given here
test_portbench_spans.SMALL.setdefault("large-p", {"n_samples": 40,
                                                  "n_features": 2048})


def one_pass_rules(D, yi, vi, iid, y_flat, valid_flat, n_real, use_star):
    """MultiSURF's rule as it was before the shifted statistics: float32 D
    (pass 1 summed its ranges in float32), sigma^2 = E[D^2] - mu^2 in
    float32, D compared with mu - sigma/2 unshifted."""
    from fastselect_tpu_torch.ops import relief as TR
    D = D.to(torch.float32)
    vmask, hit = TR._pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    Dm = torch.where(vmask, D, 0.0)
    denom = 1.0 / (n_real - 1.0)
    mu = Dm.sum(dim=1) * denom
    var = torch.clamp_min((Dm * Dm).sum(dim=1) * denom - mu * mu, 0.0)
    near = (D < (mu - 0.5 * torch.sqrt(var))[:, None]) & vmask
    near_hit, near_miss = near & hit, near & ~hit
    w_hit = -1.0 / torch.clamp_min(near_hit.sum(dim=1).float(), 1.0)
    w_miss = 1.0 / torch.clamp_min(near_miss.sum(dim=1).float(), 1.0)
    return [(near_hit, w_hit), (near_miss, w_miss)]


def run(seed=2**31 + 2077):
    c = harness.load_cell(CELL)
    return harness.run_cell(c, seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=SMALL)


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] is True, line["checks"]


def test_one_pass_rule_is_not_correct(monkeypatch):
    from fastselect_tpu_torch.ops import relief as TR
    monkeypatch.setattr(TR, "_rules_multisurf", one_pass_rules)
    line = run()
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["score_gap"]["value"] > 1e-3


@pytest.fixture
def staged_on_cpu(monkeypatch):
    """The program's half-width staging, a CUDA path, rehearsed on the
    CPU at a small size."""
    from fastselect_tpu_torch.models import _relief_base
    monkeypatch.setattr(_relief_base, "_STAGED_DEVICE_TYPES",
                        ("cuda", "cpu"))
    monkeypatch.setattr(_relief_base, "_STAGED_MIN_ELEMS", 0)


def test_control_fails_and_program_passes(staged_on_cpu):
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
