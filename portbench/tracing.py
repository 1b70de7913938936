"""What a traced run reads: the program's phase records and a profiler
trace of a slice of the window's fits.

Phase records: with the ``fastselect_tpu_torch`` logger at INFO every
``phase`` of the program synchronises the card at both ends and logs its
seconds (``utils/logging.py``); :class:`PhaseCapture` keeps them, a list
a fit.  Device events: ``torch.profiler`` over whole fits, each inside a
``portbench.fit`` range of the harness; :func:`read_trace` reduces the
Chrome trace to each fit's kernels and copies, its busy time (the union
of device intervals) and its idle gaps, each labelled with the host op
that was open during it.
"""

from __future__ import annotations

import json
import logging
import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

LOGGER = "fastselect_tpu_torch"
FIT_RANGE = "portbench.fit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_RECORD = re.compile(r"^(\S+): ([0-9.eE+-]+)s")


class PhaseCapture(logging.Handler):
    """The program's phase records at INFO, a list of (name, seconds) per
    fit: :meth:`next_fit` closes the current fit's list."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.fits: list[list[tuple[str, float]]] = []
        self._current: list[tuple[str, float]] = []

    def emit(self, record):
        m = _RECORD.match(record.getMessage())
        if m:
            self._current.append((m.group(1), float(m.group(2))))

    def next_fit(self):
        self.fits.append(self._current)
        self._current = []

    def __enter__(self):
        log = logging.getLogger(LOGGER)
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger(LOGGER)
        log.removeHandler(self)
        log.setLevel(self._level)


@dataclass
class DeviceFit:
    """One profiled fit: its wall and device-busy seconds, its device
    events by name (seconds summed, with a kind: kernel or copy), and its
    idle seconds by the host op open during each gap."""
    wall_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)      # name -> (kind, seconds)
    idle: dict = field(default_factory=dict)     # host label -> seconds

    def kernels(self):
        return {k: s for k, (kind, s) in self.ops.items() if kind == "kernel"}


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of [starts, ends), sorted."""
    order = np.argsort(starts, kind="stable")
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host, limit=400):
    """Idle seconds by label: the host op or range with the largest
    overlap of each of the ``limit`` longest gaps (the innermost on a
    tie); shorter gaps, and gaps with no op open, go under 'host'."""
    out = defaultdict(float)
    if not gaps:
        return out
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    by_len = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)
    for g0, g1 in by_len[:limit]:
        label = "host"
        if len(hs):
            over = np.minimum(he, g1) - np.maximum(hs, g0)
            cand = np.flatnonzero(over > 0)
            if len(cand):
                best = cand[np.lexsort((he[cand] - hs[cand], -over[cand]))[0]]
                label = names[best]
        out[label] += (g1 - g0) / 1e6
    for g0, g1 in by_len[limit:]:
        out["host"] += (g1 - g0) / 1e6
    return out


def read_trace(path: str) -> list[DeviceFit]:
    """Each ``portbench.fit`` range of the Chrome trace at ``path`` as a
    :class:`DeviceFit`: device events clipped to the range."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    fits, dev, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation" and e.get("name") == FIT_RANGE:
            fits.append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?"),
                        "kernel" if cat == "kernel" else "copy"))
        elif cat in HOST_CATS and e.get("name") != FIT_RANGE:
            host.append((ts, ts + dur, e.get("name", "?")))
    del events
    fits.sort()
    ds = np.array([d[0] for d in dev], dtype=np.float64)
    de = np.array([d[1] for d in dev], dtype=np.float64)
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    out = []
    for f0, f1 in fits:
        sel = np.flatnonzero((de > f0) & (ds < f1))
        s, e = np.clip(ds[sel], f0, f1), np.clip(de[sel], f0, f1)
        ops = {}
        for i, a, b in zip(sel, s, e):
            name, kind = dev[i][2], dev[i][3]
            ops[name] = (kind, ops.get(name, (kind, 0.0))[1] + (b - a) / 1e6)
        merged = _union(s, e)
        busy = sum(b - a for a, b in merged)
        gaps, t = [], f0
        for a, b in merged:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if f1 > t:
            gaps.append((t, f1))
        hsel = np.flatnonzero((he > f0) & (hs < f1))
        idle = _label_gaps(gaps, [host[i] for i in hsel])
        out.append(DeviceFit((f1 - f0) / 1e6, busy / 1e6, ops, dict(idle)))
    return out


def breakdown(fits: list[DeviceFit], top: int = 10) -> dict:
    """The device operations that took the most time, and the idle time
    by what the host was doing, summed over the profiled fits."""
    ops, idle = defaultdict(float), defaultdict(float)
    for f in fits:
        for name, (_, sec) in f.ops.items():
            ops[name] += sec
        for name, sec in f.idle.items():
            idle[name] += sec

    def first(d):
        return [[name[:160], sec] for name, sec in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": first(ops), "idle_gaps": first(idle)}


def phase_seconds(records, *prefixes) -> float:
    """Seconds of one fit's phase records whose names start with any of
    ``prefixes``."""
    return sum(sec for name, sec in records if name.startswith(prefixes))


def has_phase(fits, *prefixes) -> bool:
    return any(name.startswith(prefixes) for _, recs in fits
               for name, _ in recs)
