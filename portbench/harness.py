"""One run of one cell: set-up, the measured window, and the check.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``: ``configs/<config>.json`` (its ``generator`` names a
module of ``generators/``), ``mixes/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json`` (what the check
compares, its limits and its control).

The window is a closed loop of one caller: fits run back to back, each
on a new estimator, ``fit(X, y)``, ``top_features_`` read on the host,
the card synchronised, the variants in turn.  Every fit started inside
``seconds`` runs to its end and counts, and each variant has at least
one.  The program's outputs are kept and, once the window has
closed and the program's state is freed, held against the plain
reference of ``reference/``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import checks, tracing
from .data import Data, generate

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
GIB = float(1 << 30)
# set-up warms up with fits of the cell's own inputs until at least this
# long has passed (at least one fit)
WARMUP_S = 2.0
# a traced run profiles fits until at least this many and this long
PROFILE_FITS = 2
PROFILE_S = 2.0


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files, and the
    metrics it reports."""
    bench = bench or load_json(REPO / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, load_json(REPO / cfg["file"]),
                load_json(ROOT / "mixes" / f"{w['traffic']}.json"),
                load_json(ROOT / "limits" / f"{name}.json"),
                int(w["chips"]), e2e, per_layer)


def load_metric(name: str):
    """The reader module of per-layer metric ``name``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def estimator_factory(mix: dict, extra: dict | None = None):
    """A zero-argument maker of the mix's estimator, from the program."""
    import fastselect_tpu_torch as program
    cls = getattr(program, mix["estimator"])
    params = dict(mix.get("params", {}), **(extra or {}))
    return lambda: cls(**params)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Fit:
    variant: int
    seconds: float
    importances: np.ndarray | None = None
    top: np.ndarray | None = None
    error: str | None = None


def one_fit(make, data: Data, v: int, device, keep: bool) -> Fit:
    x, y = data.variants[v]
    t0 = time.perf_counter()
    try:
        est = make()
        est.fit(x, y)
        top = np.asarray(est.top_features_).copy()
        synchronize(device)
    except Exception:   # a failed fit counts against the attempted ones
        traceback.print_exc(file=sys.stderr)
        return Fit(v, time.perf_counter() - t0, error="raised")
    sec = time.perf_counter() - t0
    imp = np.asarray(est.feature_importances_).copy() if keep else None
    return Fit(v, sec, imp, top)


@dataclass
class Window:
    fits: list = field(default_factory=list)
    seconds: float = 0.0
    phases: list = field(default_factory=list)       # per fit (traced)
    profiled: int = 0                                 # leading fits traced
    device_fits: list = field(default_factory=list)


def run_window(make, data: Data, seconds: float, device, checked,
               trace: bool) -> Window:
    """Fits back to back for ``seconds``; with ``trace``, the program's
    phase records of every fit and a profile of the first fits."""
    win = Window()
    n_var = len(data.variants)
    capture = tracing.PhaseCapture() if trace else None
    prof = None
    trace_path = None
    if trace:
        capture.__enter__()
        prof = _profiler(device)
        prof.__enter__()
    t_start = time.perf_counter()
    try:
        # every variant gets at least one fit, whatever the length
        while len(win.fits) < n_var or \
                time.perf_counter() - t_start < seconds:
            v = len(win.fits) % n_var
            if prof is not None:
                with torch.profiler.record_function(tracing.FIT_RANGE):
                    fit = one_fit(make, data, v, device, v in checked)
            else:
                fit = one_fit(make, data, v, device, v in checked)
            win.fits.append(fit)
            if capture is not None:
                capture.next_fit()
            if prof is not None and len(win.fits) >= PROFILE_FITS and \
                    time.perf_counter() - t_start >= PROFILE_S:
                prof.__exit__(None, None, None)
                win.profiled = len(win.fits)
                trace_path = _export(prof)
                prof = None
    finally:
        win.seconds = time.perf_counter() - t_start
        if prof is not None:
            prof.__exit__(None, None, None)
            win.profiled = len(win.fits)
            trace_path = _export(prof)
        if capture is not None:
            capture.__exit__(None, None, None)
            win.phases = capture.fits
    if trace_path is not None:
        try:
            win.device_fits = tracing.read_trace(trace_path)
        finally:
            os.unlink(trace_path)
    return win


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _export(prof) -> str:
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def warm_profiler(device) -> None:
    """Start the profiler once in set-up, so that its own start-up cost
    falls outside the window."""
    with _profiler(device):
        torch.ones(8, device=device).sum().item()


def _p90(values):
    return statistics.quantiles(values, n=10)[8] if len(values) >= 2 \
        else values[0]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, *, make=None, overrides=None) -> dict:
    """One run of ``cell``: its result line, the numbers its check
    compared last (``checks``).  ``t_process`` is the process's start on the
    ``time.perf_counter`` clock; ``make`` replaces the estimator maker and
    ``overrides`` keys of the configuration (tests at small sizes)."""
    device = torch.device(device)
    config = dict(cell.config, **(overrides or {}))
    make = make or estimator_factory(cell.mix)
    data = generate(config, seed, device).as_input(cell.mix["input"], device)
    checked = checks.checked_variants(cell.limits, len(data.variants), seed)

    # set-up: warm every shape the window uses, then the profiler
    t0 = time.perf_counter()
    v = 0
    while v == 0 or time.perf_counter() - t0 < WARMUP_S:
        fit = one_fit(make, data, v % len(data.variants), device, False)
        if fit.error:
            raise RuntimeError("a warm-up fit raised")
        v += 1
    if trace:
        warm_profiler(device)
    gc.collect()
    synchronize(device)
    peak_setup = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process

    win = run_window(make, data, seconds, device, checked, trace)
    peak_window = _peak(device)

    ok = [f for f in win.fits if f.error is None]
    outputs = [f for f in ok if f.variant in checked]
    del make
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = checks.compare(cell, data, outputs, checked, device)
    print(f"portbench: window {win.seconds:.2f} s, {len(win.fits)} fits; "
          f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    failed = len(win.fits) - len(ok)
    correct = failed == 0 and checks.passes(numbers)

    if trace:
        metrics = _per_layer(cell, config, win, device)
    else:
        metrics = _end_to_end(cell, win, setup_s, peak_window)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": 1,
           "memory_peak_bytes": int(max(peak_setup, peak_window))}
    line = {"correct": bool(correct), "attempted": len(win.fits),
            "failed": failed, "metrics": metrics, "device": dev}
    if trace and sum(f.busy_s for f in win.device_fits) > 0:
        dev["busy_s"] = sum(f.busy_s for f in win.device_fits)
        dev["window_s"] = sum(f.wall_s for f in win.device_fits)
        line["breakdown"] = tracing.breakdown(win.device_fits)
    dev["power_limit"] = power_limit()
    line["checks"] = numbers
    return line


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def device_kind(device) -> str:
    return torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or 'not read'."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else "not read"


def _end_to_end(cell: Cell, win: Window, setup_s: float, peak: int) -> dict:
    secs = [f.seconds for f in win.fits]
    values = {
        "fit_s": win.seconds / max(1, len(win.fits)),
        "fit_p90_s": _p90(secs),
        "peak_device_gib": peak / GIB,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


@dataclass
class TraceContext:
    """What a per-layer metric's ``read(ctx)`` gets."""
    cell: Cell
    config: dict
    unprofiled: list      # (wall s, phase records) of the traced fits
    #                       that ran without the profiler (all, if none)
    device_fits: list     # tracing.DeviceFit of the profiled fits
    peaks: dict | None    # the card's published peaks (peaks.json)


def _per_layer(cell: Cell, config: dict, win: Window, device) -> dict:
    fits = [(f.seconds, ph) for f, ph in zip(win.fits, win.phases)]
    # a trace with no device event (no card) gives no device metric
    device_fits = (win.device_fits
                   if sum(f.busy_s for f in win.device_fits) > 0 else [])
    ctx = TraceContext(cell, config, fits[win.profiled:] or fits,
                       device_fits,
                       load_json(ROOT / "peaks.json").get(
                           device_kind(device)))
    out = {}
    for m in cell.per_layer:
        value = load_metric(m["name"]).read(ctx)
        if value is None:
            continue
        v, extra = (value if isinstance(value, tuple) else (value, {}))
        out[m["name"]] = dict({"value": v, "unit": m["unit"]}, **extra)
    return out
