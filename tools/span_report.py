#!/usr/bin/env python3
"""The program's span tree on one benchmark cell, read on the card.

    python3 tools/span_report.py --workload snp-paper.multisurf --seed 7 \
        [--pairs 6] [--out chiprun_out/spans-<cell>.json]

Makes the cell's inputs and estimator as ``portbench`` does (its
configuration, mix and generator, from the seed), warms up, then:

* times fits in pairs, one with the ``fastselect_tpu_torch`` logger below
  INFO and one at INFO, each pair on the same variant: the cost of
  tracing on, and every traced fit's span records (seconds and times
  opened by name) and counter deltas;
* times a disabled span (``with span(...)`` below INFO) over many calls;
* times an enabled device span, its flush at the root included;
* profiles two traced fits with ``torch.profiler`` and splits each of
  their longest idle gaps of the card by the innermost program span open
  over each part of it (the shortest ``user_annotation`` range there),
  and likewise by the innermost host op.

Prints a summary and writes the numbers as JSON to ``--out``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from portbench import harness, tracing  # noqa: E402
from portbench.data import generate  # noqa: E402

from fastselect_tpu_torch.utils import logging as fs_logging  # noqa: E402

FIT_STEPS = ("fit.validate", "fit.analysis", "fit.score", "fit.select")
DISCRETE = ("discrete.layout", "discrete.pass1", "weight_rules",
            "discrete.pass2")
GAPS = 3


class Records(logging.Handler):
    """Every record of the package's logger, kept as it comes."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def fit_once(make, data, v, device):
    x, y = data.variants[v % len(data.variants)]
    t0 = time.perf_counter()
    est = make()
    est.fit(x, y)
    np.asarray(est.top_features_)
    harness.synchronize(device)
    return time.perf_counter() - t0


def summarise(records):
    """(seconds by name, times opened by name, counter deltas) of one
    fit's records."""
    sec, opened, counts = defaultdict(float), defaultdict(int), {}
    for r in records:
        m = tracing._RECORD.match(r.getMessage())
        if not m:
            continue
        sec[m.group(1)] += float(m.group(2))
        opened[m.group(1)] += len(getattr(r, "spans", ())) or 1
        counts.update(getattr(r, "counts", {}) or {})
    return dict(sec), dict(opened), counts


def disabled_span_ns(calls=200_000):
    log = logging.getLogger(fs_logging.logger.name)
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with fs_logging.span("weight_rules", device=True):
                pass
        return (time.perf_counter_ns() - t0) / calls
    finally:
        log.setLevel(level)


def enabled_span_us(device, calls=2000):
    """Host microseconds of one span on ``device`` at INFO: its events,
    its profiler range and its share of the root's records."""
    log = logging.getLogger(fs_logging.logger.name)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        harness.synchronize(device)
        t0 = time.perf_counter_ns()
        with fs_logging.span("root"):
            for _ in range(calls):
                with fs_logging.span("weight_rules", device=device):
                    pass
        return (time.perf_counter_ns() - t0) / calls / 1e3
    finally:
        log.setLevel(level)


def innermost(g0, g1, ranges):
    """Microseconds of [g0, g1) by the innermost (shortest) of ``ranges``
    open over each part of it, the largest first; 'none' where none is."""
    inside = [(a, b, n) for a, b, n in ranges if a < g1 and b > g0]
    cuts = sorted({g0, g1} | {t for a, b, _ in inside for t in (a, b)
                              if g0 < t < g1})
    out = defaultdict(float)
    for t0, t1 in zip(cuts, cuts[1:]):
        open_ = [(b - a, n) for a, b, n in inside if a <= t0 and b >= t1]
        out[min(open_)[1] if open_ else "none"] += t1 - t0
    return sorted(out.items(), key=lambda kv: -kv[1])


def gap_owners(path, n_gaps=GAPS):
    """The longest idle gaps of the card inside the ``portbench.fit``
    ranges of the Chrome trace at ``path``, each split by the innermost
    program span and the innermost host op over it."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    fits, dev, spans, ops = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        cat, name = e.get("cat"), e.get("name", "?")
        if cat == "user_annotation":
            (fits if name == tracing.FIT_RANGE else spans).append(
                (ts, ts + dur, name))
        elif cat in tracing.DEVICE_CATS:
            dev.append((ts, ts + dur))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append((ts, ts + dur, name))
    gaps = []
    fits.sort()
    ds = np.array([d[0] for d in dev])
    de = np.array([d[1] for d in dev])
    for k, (f0, f1, _) in enumerate(fits):
        sel = (de > f0) & (ds < f1)
        merged = tracing._union(np.clip(ds[sel], f0, f1),
                                np.clip(de[sel], f0, f1))
        t = f0
        for a, b in merged + [[f1, f1]]:
            if a > t:
                gaps.append((t, a, k))
            t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    return [{"fit": k, "ms": (g1 - g0) / 1e3,
             "at_ms": (g0 - fits[k][0]) / 1e3,
             "spans_ms": [(n, us / 1e3) for n, us in
                          innermost(g0, g1, spans)[:3]],
             "ops_ms": [(n, us / 1e3) for n, us in
                        innermost(g0, g1, ops)[:3]]}
            for g0, g1, k in gaps[:n_gaps]]


def profile(make, data, device, fits=2):
    with harness._profiler(device) as p:
        for v in range(fits):
            with torch.profiler.record_function(tracing.FIT_RANGE):
                fit_once(make, data, v, device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        return gap_owners(path)
    finally:
        os.unlink(path)


def main(argv=None, *, device=None, overrides=None):
    """``device`` and ``overrides`` (keys of the configuration replaced)
    rehearse a run without a card at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    make = harness.estimator_factory(cell.mix)
    config = dict(cell.config, **(overrides or {}))
    data = generate(config, args.seed, device).as_input(
        cell.mix["input"], device)
    t0, v = time.perf_counter(), 0
    while v < len(data.variants) or time.perf_counter() - t0 < 2.0:
        fit_once(make, data, v, device)
        v += 1

    log = logging.getLogger(fs_logging.logger.name)
    handler = Records()
    log.addHandler(handler)
    off, on, fits = [], [], []
    try:
        for i in range(args.pairs):
            log.setLevel(logging.WARNING)
            off.append(fit_once(make, data, i, device))
            log.setLevel(logging.INFO)
            handler.records = []
            on.append(fit_once(make, data, i, device))
            fits.append(summarise(handler.records))
        gaps = profile(make, data, device)
    finally:
        log.setLevel(logging.WARNING)
        log.removeHandler(handler)

    names = sorted({n for sec, _, _ in fits for n in sec})
    mean = {n: statistics.fmean(sec.get(n, 0.0) for sec, _, _ in fits)
            for n in names}
    opened = {n: statistics.fmean(op.get(n, 0) for _, op, _ in fits)
              for n in names}
    counts = {k: statistics.fmean(c.get(k, 0) for _, _, c in fits)
              for k in sorted({k for _, _, c in fits for k in c})}
    root = next((n for n in names if n.startswith("fit[")), None)
    engine = [n for n in names if n.startswith(("relief_discrete.engine",
                                                "relief_cuda.engine"))]
    spans_per_fit = sum(opened.values())
    # a tree without the recorder (phases only) reads its cost alone
    traced = hasattr(fs_logging, "span")
    ns = disabled_span_ns() if traced else None
    us = enabled_span_us(device) if traced else None
    out = {
        "workload": args.workload, "seed": args.seed,
        "card": f"{harness.device_kind(device)}, {harness.power_limit()}",
        "fit_s_off": off, "fit_s_on": on,
        "on_over_off": statistics.median(on) / statistics.median(off) - 1,
        "span_s": mean, "opened": opened, "counts": counts,
        "fit_steps_share": sum(mean.get(n, 0) for n in FIT_STEPS)
        / mean[root] if root else None,
        "discrete_over_engine": (sum(mean.get(n, 0) for n in DISCRETE)
                                 / mean[engine[0]]
                                 if engine and "discrete" in engine[0]
                                 else None),
        "disabled_span_ns": ns, "spans_per_fit": spans_per_fit,
        "disabled_cost_s": ns * spans_per_fit / 1e9 if traced else None,
        "enabled_span_us": us,
        "gaps": gaps,
    }
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
