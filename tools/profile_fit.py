#!/usr/bin/env python3
"""Where the device time of one warm mixed-xl fit goes, by kernel.

    python3 tools/profile_fit.py

Fits ``MultiSURF(n_features_to_select=10)`` on chip_smoke.py's mixed-xl
data (150,000 x 100, columns 0-39 cut to 0..2: the fused engine's MIXED
kernels over focal blocks) once to warm up, then once under
``torch.profiler`` on one CUDA device.  Prints the device time of the
kernels that took the most, their share of the fit's wall time, and the
device's busy share (device time of all kernels over the wall time; one
stream, so kernels do not overlap); the last line is one JSON object.
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
from chip_smoke import make_classification, quantized  # noqa: E402
from fastselect_tpu_torch import MultiSURF  # noqa: E402

TOP = 15


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    X, y = make_classification(n_samples=150000, n_features=100,
                               n_informative=10, random_state=9)
    X = quantized(X, np.arange(40)).astype(np.float32)
    MultiSURF(n_features_to_select=10).fit(X, y)          # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        MultiSURF(n_features_to_select=10).fit(X, y)
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
    print(f"mixed-xl warm fit: wall {wall_us / 1e6:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s ({100 * busy_us / wall_us:.1f}%)")
    for name, dev_us, count in rows[:TOP]:
        print(f"{dev_us / 1e3:10.3f} ms {100 * dev_us / wall_us:5.1f}% "
              f"{count:6d}x  {name[:100]}")
    print(json.dumps({"device": smi, "wall_s": wall_us / 1e6,
                      "busy_s": busy_us / 1e6,
                      "kernels": [dict(name=n, ms=d / 1e3, count=c)
                                  for n, d, c in rows[:TOP]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
