"""The port's examples (``examples/torch/``) keep working on the CPU, as
``tests/test_examples.py`` holds the JAX package's, and import no JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX_MODULES = ("jax", "jaxlib", "fastselect_tpu", "fast_select")


def _run(script, *args):
    """Run ``script`` as ``__main__`` with ``args``, then print the JAX
    modules the process holds as the last line."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{script!r}, *{list(args)!r}]\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"                       if m.split('.')[0] in {JAX_MODULES!r})))\n")
    env = os.environ.copy()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    *lines, loaded = r.stdout.strip().splitlines()
    assert json.loads(loaded) == []
    return "\n".join(lines)


def test_gwas_workflow_example():
    out = _run("examples/torch/gwas_workflow.py", "--n", "260", "--p", "180",
               "--backend", "cpu")
    assert "TuRF elimination: " in out
    assert "planted signals recovered: True" in out


def test_sklearn_pipeline_example():
    out = _run("examples/torch/sklearn_pipeline.py", "--backend", "cpu")
    assert "cv accuracy" in out
