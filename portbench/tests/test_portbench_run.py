"""A whole run rehearsed on the CPU at a small size, in its own
process, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SMALL = {"snp-paper.multisurf": {"n_samples": 160, "n_features": 256,
                                 "phenotypes": 2},
         "large-n.multisurf": {"n_samples": 300, "n_features": 16}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
REHEARSE = """
import json, sys
sys.path.insert(0, {repo!r})
from portbench import run
rc = run.main(["--workload", {cell!r}, "--seed", "3000000001",
               "--seconds", "1", "--trace", {trace!r}], device="cpu",
              overrides={over!r})
print(json.dumps(run.forbidden_modules()), file=sys.stderr)
sys.exit(rc)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_rehearsal_prints_one_result_line(cell, trace):
    code = REHEARSE.format(repo=str(REPO), cell=cell, trace=trace,
                           over=SMALL[cell])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) <= set(KEYS) | {"breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = ({"fit_s", "peak_device_gib", "setup_s"} if trace == "0"
            else {"estimator_host_s"})
    assert want <= set(line["metrics"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    err = out.stderr.strip().splitlines()
    assert json.loads(err[-1]) == []            # no JAX, no JAX package
    assert [e.split()[1] for e in err[-4:-1]] == list(line["checks"])


def test_without_a_card_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "large-n.multisurf", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env())
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = REHEARSE.format(repo=str(tmp_path), cell="large-n.multisurf",
                           trace="0", over=SMALL["large-n.multisurf"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=_env())
    assert out.returncode != 0 and out.stdout == ""
