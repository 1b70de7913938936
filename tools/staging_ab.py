#!/usr/bin/env python3
"""The staged analysis against the one-shot copy, by chunk width.

    python3 tools/staging_ab.py

On one CUDA device, at chip_smoke.py's mixed-xl (150,000 x 100 float32,
columns 0-39 cut to 0..2), large-n (50,000 x 100) and staging
(100 x 500,000) data:

* the analysis alone, best of five, synchronised: ``analyze_features`` of
  one pageable float32 copy (the one-shot route) and
  ``analyze_features_staged`` at each chunk width of
  ``chip_smoke.CHUNK_SWEEP``;
* warm ``MultiSURF(n_features_to_select=10).fit`` one-shot (the stager's
  gate raised) and staged at 32, 64 and 256 MB chunks, three rounds in
  turns, each fit's seconds kept.

Prints the card's name and power limit; the last line is one JSON object.
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
from chip_smoke import (CHUNK_SWEEP, make_classification,  # noqa: E402
                        quantized, with_threshold)
from fastselect_tpu_torch import MultiSURF  # noqa: E402
from fastselect_tpu_torch.models import _relief_base  # noqa: E402
from fastselect_tpu_torch.utils import staging  # noqa: E402
from fastselect_tpu_torch.utils.preprocessing import (  # noqa: E402
    analyze_features, analyze_features_staged)

FIT_WIDTHS_MB = (32, 64, 256)


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def data():
    X, y = make_classification(n_samples=150000, n_features=100,
                               n_informative=10, random_state=9)
    yield "mixed-xl", quantized(X, np.arange(40)).astype(np.float32), y
    X, y = make_classification(n_samples=50000, n_features=100,
                               n_informative=10, random_state=0)
    yield "large-n", X.astype(np.float32), y
    X, y = make_classification(n_samples=100, n_features=500000,
                               random_state=25)
    yield "staging", X.astype(np.float32), y


def main():
    if not torch.cuda.is_available():
        raise SystemExit("staging_ab: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {}
    for label, X, y in data():
        one_shot = lambda: analyze_features(  # noqa: E731
            torch.tensor(X, dtype=torch.float32, device=dev), 10)
        res = {"analysis": {"one-shot": min(synced_s(one_shot)
                                            for _ in range(5))}}
        for cb in CHUNK_SWEEP:
            res["analysis"][f"{cb >> 20} MB"] = with_threshold(
                staging, "_CHUNK_BYTES", cb, lambda: min(synced_s(
                    lambda: analyze_features_staged(
                        X, 10, transfer_dtype="float32", device=dev))
                    for _ in range(5)))
        fit = lambda: MultiSURF(  # noqa: E731
            n_features_to_select=10).fit(X, y)
        configs = {"one-shot": lambda: with_threshold(
            _relief_base, "_STAGED_MIN_ELEMS", 1 << 62,
            lambda: synced_s(fit))}
        for mb in FIT_WIDTHS_MB:
            configs[f"{mb} MB"] = lambda mb=mb: with_threshold(
                staging, "_CHUNK_BYTES", mb << 20, lambda: synced_s(fit))
        for run in configs.values():   # warm-up
            run()
        res["fits"] = {name: [] for name in configs}
        for _ in range(3):
            for name, run in configs.items():
                res["fits"][name].append(run())
        out[label] = res
        print(f"{label} {X.shape[0]}x{X.shape[1]}: analysis "
              + ", ".join(f"{k} {v:.4f} s"
                          for k, v in res["analysis"].items())
              + "; warm fits "
              + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) + " s"
                          for k, v in res["fits"].items())
              + f" on {smi}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi, "results": out}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
