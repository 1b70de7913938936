#!/usr/bin/env python3
"""Readings that the check's limits are set from: the program's, and the
control's, at a cell's own size.  Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> [--workload <cell> ...] \
        --seeds <n> ... --control-seeds <n> ...

For each seed of ``--seeds`` the program fits each checked variant once
through the cell's own path (the mix's estimator and input form), and
``score_gap`` and ``top_miss`` are read against the reference, as a run
reads them.  For each seed of ``--control-seeds`` the control takes the
program's place: the cell's ``control`` in ``limits/<cell>.json``,
either the reference computed in a lower precision (``kind:
reference``, ``dtype``) or the program with a lower-precision path of
its own switched on (``kind: program``, ``params``).  The workloads
given together must share one configuration: each seed's data and
reference serve them all.  One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from portbench import checks, harness
    from portbench.data import Data, generate

    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 1
        device = "cuda:0"
    device = torch.device(device)
    cells = [harness.load_cell(w) for w in args.workload]
    config = dict(cells[0].config, **(overrides or {}))
    if any(c.config["name"] != config["name"] for c in cells):
        raise SystemExit("control: the workloads must share a configuration")

    def fits(cell, data, variants, extra=None):
        make = harness.estimator_factory(cell.mix, extra)
        out = []
        for v in sorted(variants):
            f = harness.one_fit(make, data, v, device, True)
            if f.error:
                raise RuntimeError(f"{cell.name}: a fit raised")
            out.append((v, f.importances, f.top))
        return out

    def emit(kind, seed, cell, outputs, refs, seconds):
        lim = cell.limits["numbers"]["score_gap"]["limit"]
        got = checks.readings(
            outputs, refs, int(cell.mix["params"]["n_features_to_select"]),
            lim)
        print(json.dumps(dict(kind=kind, seed=seed, workload=cell.name,
                              seconds=seconds, **got)), flush=True)

    warm = set()
    for seed, kind in ([(s, "program") for s in args.seeds]
                       + [(s, "control") for s in args.control_seeds]):
        t0 = time.perf_counter()
        raw = generate(config, seed, device)
        variants = checks.checked_variants(cells[0].limits,
                                           len(raw.variants), seed)
        inputs = {c.name: raw.as_input(c.mix["input"], device)
                  for c in cells}
        del raw
        outs = {}
        for c in cells:
            data = inputs[c.name]
            if kind == "program":
                if c.name not in warm:
                    fits(c, data, variants)
                    warm.add(c.name)
                outs[c.name] = fits(c, data, variants)
            elif c.limits["control"]["kind"] == "program":
                outs[c.name] = fits(c, data, variants,
                                    c.limits["control"]["params"])
        torch.cuda.empty_cache() if device.type == "cuda" else None
        ref_data: Data = inputs[cells[0].name]
        by_mix = {}
        for c in cells:
            key = json.dumps(c.mix["params"], sort_keys=True) + \
                c.mix["estimator"]
            if key not in by_mix:
                by_mix[key] = checks.reference(c.mix, ref_data, variants,
                                               device)
            refs = by_mix[key]
            if kind == "control" and c.limits["control"]["kind"] == \
                    "reference":
                dt = c.limits["control"]["dtype"]
                if key + dt not in by_mix:
                    by_mix[key + dt] = checks.reference(
                        c.mix, ref_data, variants, device,
                        getattr(torch, dt))
                low = by_mix[key + dt]
                outs[c.name] = [(v, s, np.argsort(s)[::-1][:int(
                    c.mix["params"]["n_features_to_select"])])
                    for v, s in sorted(low.items())]
            emit(kind, seed, c, outs[c.name], refs,
                 time.perf_counter() - t0)
        del inputs, outs, by_mix
    return 0


if __name__ == "__main__":
    sys.exit(main())
