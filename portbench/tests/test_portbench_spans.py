"""The metrics read from the program's span records: a traced run
rehearsed on the CPU at a small size, in its own process, reports each of
them in every cell that lists it; and the reader itself."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.spans import span_seconds

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SMALL = {"snp-paper": {"n_samples": 160, "n_features": 256,
                       "phenotypes": 2},
         "large-n": {"n_samples": 300, "n_features": 16}}
REHEARSE = """
import sys
sys.path.insert(0, {repo!r})
from portbench import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", "3000000017",
                   "--seconds", "1", "--trace", "1"], device="cpu",
                  overrides={over!r}))
"""


def _span_metrics(cell):
    """The per-layer metrics of ``cell`` whose reader names a span."""
    return {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]
            and hasattr(harness.load_metric(m["name"]), "SPAN")}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_rehearsal_reads_the_program_spans(cell):
    config = next(w["config"] for w in BENCH["workloads"]
                  if w["name"] == cell)
    code = REHEARSE.format(repo=str(REPO), cell=cell, over=SMALL[config])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    want = _span_metrics(cell)
    assert want and want <= set(line["metrics"]), want - set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0


def test_span_seconds_reads_exact_names_a_fit():
    fits = [(1.0, [("fit.validate", 0.5), ("fit.validate_x", 9.0),
                   ("weight_rules", 0.25), ("weight_rules", 0.25)]),
            (1.0, [("weight_rules", 1.0)])]
    assert span_seconds(fits, "fit.validate") == 0.25
    assert span_seconds(fits, "weight_rules") == 0.75
    # a program without the span (the parent) gives nothing to read
    assert span_seconds(fits, "discrete.pass1") is None
    assert span_seconds([], "weight_rules") is None
