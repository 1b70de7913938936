#!/usr/bin/env python3
"""Where the device time of one warm fit goes, by kernel.

    python3 tools/profile_fit.py [mixed-xl|mrmr|mrmr-stream|cfs|cfs-stream|
                                  mdr|mdr-k3|mdr-k4]
    python3 tools/profile_fit.py snp-headline|gwas-gather [--tree ROOT]

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

``snp-headline`` and ``gwas-gather`` split the all-discrete engine's
windows instead.  snp-headline fits chip_smoke.py's phase 7 data
(``MultiSURF(10)`` on 16,384 x 65,536 int8 genotypes, v2-sym) from the
host array; gwas-gather runs the v2-gather route (``_run_v2_gather``) on
phase 24's codes packed at 2 bits, 8,192 rows in class order with the
fit's tiles (TI 4,096, FT 1,024), but over 16 windows of features rather
than 5,000,000 (4,883 windows): a window's work does not depend on how
many there are.  The engine's helpers are wrapped in
``record_function`` ranges (pass 1 and pass 2, and inside them the
one-hot build, the int8 GEMMs and the operand cuts), and each device
kernel is charged to the innermost range whose runtime call launched
it.  What a pass launched outside those is its epilogue: the ``acc +=``
of pass 1, and in pass 2 the ``q``/``p_sum`` chain and the focal
reduction (or the fused kernel that replaces them).  Each pass's device
and host (wall) milliseconds a window are printed.  ``--tree ROOT``
imports the package (and ``chip_smoke.py``) from another checkout, such
as a parent commit unpacked with ``git archive``, so that two trees are
split by one script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the package (and chip_smoke.py) of this checkout, or of --tree's; run
# as a script, before they are imported
if __name__ == "__main__" and "--tree" in sys.argv:
    _AT = sys.argv.index("--tree")
    sys.path.insert(0, str(Path(sys.argv[_AT + 1]).resolve()))
    del sys.argv[_AT:_AT + 2]
else:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (balanced_labels,  # noqa: E402
                        make_classification, planted_genotypes,
                        planted_interaction, quantized, trace_device_s)
from fastselect_tpu_torch import CFS, MDR, MultiSURF, mRMR  # noqa: E402
from fastselect_tpu_torch.models import cfs as cfs_mod  # noqa: E402
from fastselect_tpu_torch.models import mrmr as mrmr_mod  # noqa: E402
from fastselect_tpu_torch.ops import relief_discrete as rd  # noqa: E402
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


# the discrete engine's helpers (a method as "Class.method") -> the range
# each runs in (those a tree lacks are skipped): "pass1" and "pass2" hold
# a pass, "<pass>.<part>" a part of one outside the window loop, and the
# rest parts of the pass they run in; "epilogue" takes all it launches
RANGES = {"_match_rows": "pass1", "_build_onehot": "pass1.onehot",
          "_match_matrix_sym": "pass1.sym", "_accumulate_plan": "pass2",
          "_accumulate_discrete": "pass2", "_build_onehot_t": "pass2.onehot",
          "int8_gemm": "gemm", "_onehot_flat": "onehot",
          "_onehot_flat_t": "onehot",
          "_gemm_window": "onehot", "window_onehot": "onehot",
          "_tile_part": "epilogue", "window_partials": "epilogue",
          "WindowPartials.__call__": "epilogue",
          "_plan_operand": "operands", "_segment_operand": "operands",
          "_total_weight": "operands"}
GWAS_WINDOWS = 16


def _ranged(fn, name):
    def wrapped(*a, **k):
        with torch.profiler.record_function(f"fs.{name}"):
            return fn(*a, **k)
    return wrapped


def _union_ms(spans):
    """Milliseconds covered by the (start, end) microsecond spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def split_trace(path):
    """{pass: {part: device ms, "wall_ms": host ms}} from the Chrome trace
    at ``path``: each device event is charged to the pass whose range
    holds its launch and to the part its innermost range names ("gemm",
    "onehot", ...); "epilogue" takes what an "epilogue" range or the pass
    itself launched."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][3:]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("fs.")]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {"pass1": {}, "pass2": {}, "outside": {}}
    for ps in ("pass1", "pass2"):
        out[ps]["wall_ms"] = _union_ms(
            (a, b) for a, b, n in ranges if n.split(".")[0] == ps)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        holding = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        names = [r[2] for r in holding]
        outer = next((n.split(".")[0] for n in names
                      if n.split(".")[0] in ("pass1", "pass2")), "outside")
        inner = min(holding, key=lambda r: r[1] - r[0])[2] if holding else ""
        part = ("epilogue" if "epilogue" in names
                or inner in ("pass1", "pass2", "")
                else inner.split(".")[-1])
        out[outer][part] = out[outer].get(part, 0.0) + e["dur"] / 1e3
    return out


def window_split(name, smi):
    """Profile one warm snp-headline fit, or the gwas-gather route over
    ``GWAS_WINDOWS`` windows, with the engine's helpers in ranges, and
    print each pass's split a window."""
    dev = torch.device("cuda", 0)
    if name == "snp-headline":
        rs = np.random.RandomState(0)
        X = rs.randint(0, 3, (16384, 65536), dtype=np.int8)
        y = rs.randint(0, 2, 16384)
        X[:, 0] = 2 * y
        layout, ti, ft = rd._tiles_and_layout(16384, 65536, 3, y,
                                              "multisurf", None, dev)
        windows, blocks = 65536 // ft, layout[4] // ti

        def run():
            MultiSURF(n_features_to_select=10).fit(X, y)
    else:
        n, ti, ft = 8192, 4096, 1024
        p = GWAS_WINDOWS * ft
        y = balanced_labels(n, 25)
        gen = torch.Generator(device=dev).manual_seed(25)
        codes = torch.randint(0, 3, (n, p), generator=gen, device=dev,
                              dtype=torch.int8)
        codes[:, 0] = torch.as_tensor(2 * y, dtype=torch.int8, device=dev)
        pk = rd.stage_codes_packed(codes, 3, dev)
        del codes
        layout = rd._class_sorted_layout(y, ti)
        windows, blocks = GWAS_WINDOWS, layout[4] // ti

        def run():
            rd._run_v2_gather(pk, y, layout, n, 3, np.zeros(1, np.float32),
                              algo="multisurf", use_star=False, k=0, ti=ti,
                              ft=ft)
    run()                                                 # warm-up
    torch.cuda.synchronize()
    def owner(f):
        *path, attr = f.split(".")
        obj = rd
        for part in path:
            obj = getattr(obj, part, None)
        return obj, attr

    saved = {f: getattr(*owner(f)) for f in RANGES
             if hasattr(*owner(f))}
    for f, r in RANGES.items():
        if f in saved:
            setattr(*owner(f), _ranged(saved[f], r))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        for f, fn in saved.items():
            setattr(*owner(f), fn)
    trace = Path(rd.__file__).resolve().parents[2] / "build" / \
        f"trace-{name}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    split = split_trace(trace)
    busy_s = trace_device_s(trace, "")[1]
    per = blocks * windows
    print(smi)
    print(f"{name} ({Path(rd.__file__).resolve().parents[2]}): wall "
          f"{wall_s:.4f} s, device busy {busy_s:.4f} s "
          f"({100 * busy_s / wall_s:.1f}%); {blocks} focal blocks x "
          f"{windows} windows of {ft}; TI {ti}")
    for ps in ("pass1", "pass2"):
        dev_ms = sum(v for k, v in split[ps].items() if k != "wall_ms")
        parts = ", ".join(f"{k} {v / per:.4f}" for k, v in
                          sorted(split[ps].items()) if k != "wall_ms")
        print(f"{ps} a window: device {dev_ms / per:.4f} ms ({parts}); "
              f"host wall {split[ps]['wall_ms'] / per:.4f} ms; in all "
              f"device {dev_ms:.3f} ms, wall {split[ps]['wall_ms']:.3f} ms")
    print(json.dumps({"device": smi, "phase": name, "wall_s": wall_s,
                      "busy_s": busy_s, "blocks": blocks,
                      "windows": windows, "ti": ti, "ft": ft,
                      "split_ms_per_window": {
                          ps: {k: v / per for k, v in split[ps].items()}
                          for ps in split}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    name = sys.argv[1] if len(sys.argv) > 1 else "mixed-xl"
    if name in ("snp-headline", "gwas-gather"):
        return window_split(name, smi)
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
