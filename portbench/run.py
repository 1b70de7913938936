#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up makes the cell's inputs from the
seed and warms every shape the window uses; the window fits back to back
for ``--seconds``; then what the window produced is held against the
plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``); the numbers the
check compared, each beside its limit, are the last lines of standard
error.  With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones.

It exits non-zero, and prints no result, without a CUDA device (or with
fewer than the cell asks for), without the program in this checkout, or
if JAX or the JAX package was loaded.  Kernel and compiler caches stay in
``build/`` of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "fastselect_tpu")


def process_age() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))


T_PROCESS = T_START - process_age()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, overrides=None, make=None) -> int:
    """Run the cell; ``device``, ``overrides`` and ``make`` are for
    rehearsals without a card (tests): another device, keys of the
    configuration replaced, and another estimator maker."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / "build" / "portbench" / sub)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    from portbench import checks, harness

    cell = harness.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  "device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        device = "cuda:0"
    import fastselect_tpu_torch
    where = Path(fastselect_tpu_torch.__file__).resolve()
    if REPO not in where.parents:
        print(f"portbench: the program was loaded from {where}, outside "
              f"this checkout ({REPO})", file=sys.stderr)
        return 1

    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_PROCESS, make=make,
                            overrides=overrides)
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 1
    for text in checks.lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
