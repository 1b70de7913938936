#!/usr/bin/env python3
"""Where the device time of one warm fit goes, by kernel.

    python3 tools/profile_fit.py [mixed-xl|mrmr|mrmr-stream|cfs|cfs-stream|
                                  mdr|mdr-k3|mdr-k4]

Fits chip_smoke.py's data of the named phase once to warm up, then once
under ``torch.profiler`` on one CUDA device: ``MultiSURF(10)`` on
mixed-xl (the default; 150,000 x 100, columns 0-39 cut to 0..2: the fused
engine's MIXED kernels over focal blocks), ``mRMR(10)`` on 2,000 x 5,000
or 2,000 x 50,000 codes, ``CFS()`` on 5,000 x 2,000 continuous data or
2,000 x 20,000 genotypes, ``MDR(k, cv=5)`` on planted genotypes (k = 2
on 2,000 x 200, 3 on 1,000 x 500, 4 on 1,000 x 100).  Prints the device
time of the kernels that took the most, their share of the fit's wall
time, and the device's busy
share (device time of all kernels over the wall time; one stream, so
kernels do not overlap); for mRMR and CFS also the host seconds of their
input validation and encoding alone.  The last line is one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (make_classification, planted_genotypes,  # noqa: E402
                        planted_interaction, quantized)
from fastselect_tpu_torch import CFS, MDR, MultiSURF, mRMR  # noqa: E402
from fastselect_tpu_torch.models import cfs as cfs_mod  # noqa: E402
from fastselect_tpu_torch.models import mrmr as mrmr_mod  # noqa: E402
from fastselect_tpu_torch.utils import sklearn_compat as skc  # noqa: E402

TOP = 15
# chip_smoke.py's MDR phases: (k, seed, n, p)
MDR_PHASES = {"mdr": (2, 18, 2000, 200), "mdr-k3": (3, 19, 1000, 500),
              "mdr-k4": (4, 20, 1000, 100)}


def phase_data(name):
    """(make the estimator, X, y, host encoding alone) of a phase."""
    if name == "mixed-xl":
        X, y = make_classification(n_samples=150000, n_features=100,
                                   n_informative=10, random_state=9)
        X = quantized(X, np.arange(40)).astype(np.float32)
        return lambda: MultiSURF(n_features_to_select=10), X, y, None
    if name.startswith("mrmr"):
        rng = np.random.RandomState(14 if name == "mrmr" else 15)
        X = rng.randint(0, 5, (2000, 5000 if name == "mrmr" else 50000))
        y = rng.randint(0, 2, 2000)

        def encode():
            Xv, yv = skc.validate_data(mRMR(10), X, y, dtype=None,
                                       y_numeric=True)
            return mrmr_mod._encode_union(Xv, yv)
        return lambda: mRMR(n_features_to_select=10), X, y, encode
    if name in MDR_PHASES:
        k, seed, n, p = MDR_PHASES[name]
        X, y, _ = planted_interaction(seed, n, p, k)
        return lambda: MDR(k=k, cv=5), X, y, None
    if name == "cfs":
        X, y = make_classification(n_samples=5000, n_features=2000,
                                   n_informative=10, random_state=11)
        rng = np.random.RandomState(16)
        X[:, 0] = y + rng.normal(0, 0.1, 5000)
        X[:, 1] = X[:, 0] + rng.normal(0, 0.05, 5000)
    elif name == "cfs-stream":
        X, y = planted_genotypes(12, 2000, 20000, 2)
    else:
        raise SystemExit(f"profile_fit: unknown phase {name!r}")

    def encode():
        Xv, _ = skc.check_X_y(X, y, dtype=None, ensure_min_samples=2)
        return cfs_mod._encode(Xv, 10, "uniform")
    return CFS, X, y, encode


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    name = sys.argv[1] if len(sys.argv) > 1 else "mixed-xl"
    make, X, y, encode = phase_data(name)
    make().fit(X, y)                                      # warm-up
    torch.cuda.synchronize()
    encode_s = None
    if encode is not None:
        t0 = time.perf_counter()
        encode()
        encode_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        make().fit(X, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        on_device = (getattr(e, "device_type", None)
                     == torch.autograd.DeviceType.CUDA)
        if dev_us > 0 and on_device:         # kernel rows, not aten's
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    print(smi)
    host = ("" if encode_s is None else
            f"; host validation and encoding alone {encode_s:.4f} s")
    print(f"{name} warm fit: wall {wall_us / 1e6:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s ({100 * busy_us / wall_us:.1f}%){host}")
    for kernel, dev_us, count in rows[:TOP]:
        print(f"{dev_us / 1e3:10.3f} ms {100 * dev_us / wall_us:5.1f}% "
              f"{count:6d}x  {kernel[:100]}")
    print(json.dumps({"device": smi, "phase": name,
                      "wall_s": wall_us / 1e6, "busy_s": busy_us / 1e6,
                      "encode_s": encode_s,
                      "kernels": [dict(name=n, ms=d / 1e3, count=c)
                                  for n, d, c in rows[:TOP]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
