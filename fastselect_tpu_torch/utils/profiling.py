"""Timing and profiling of fits on the card.

Counterpart of ``fastselect_tpu/utils/profiling.py``:

* ``timed_fit``  — wall time of an estimator's fit after a warm-up fit
  (the kernels built, the allocator's blocks cached), with samples^2 *
  features / s, peak host RSS sampled during the fit and peak device
  memory (``torch.cuda.max_memory_allocated`` over the visible devices,
  reset before the timed fit);
* ``trace``      — a ``torch.profiler`` trace of a region (CPU, and CUDA
  where there is a card), written as a Chrome trace;
* ``device_kind`` / ``peaks`` — the card's published peaks, so that a
  rate can be stated as a share of its roofline.  An unknown card gives
  None.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


class Peaks(NamedTuple):
    bf16_tflops: float   # dense bf16 tensor-core TFLOP/s
    int8_tops: float     # dense int8 tensor-core TOP/s
    fp32_tflops: float   # float32 outside the tensor cores, TFLOP/s
    hbm_gbps: float      # device memory GB/s


# Published peaks by torch.cuda.get_device_name, at the card's full power
# limit: "NVIDIA H100 80GB HBM3" is the H100 SXM5 (NVIDIA's data sheet,
# 700 W, dense rates without sparsity).
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(989.0, 1979.0, 67.0, 3350.0),
}


def device_kind() -> str:
    """The first CUDA device's name, or ``'cpu'`` without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def peaks(kind: str | None = None) -> Peaks | None:
    """The published peaks of a card by name (default: the first CUDA
    device), None for a card not in ``PEAKS``."""
    return PEAKS.get(device_kind() if kind is None else kind)


@dataclass
class FitTiming:
    seconds: float
    warmup_seconds: float
    n_samples: int
    n_features: int
    peak_rss_mb: float = 0.0       # max host RSS sampled during the fit
    peak_device_mb: float = 0.0    # max_memory_allocated (0 without a card)
    throughput: float = field(init=False)  # samples^2 * features / s

    def __post_init__(self):
        work = float(self.n_samples) ** 2 * self.n_features
        self.throughput = work / self.seconds if self.seconds > 0 else 0.0


class _RssSampler:
    """Background thread sampling /proc/self/statm resident pages.

    Sampling (rather than VmHWM) gives each fit its own peak instead of
    the process's lifetime high-water mark."""

    def __init__(self, interval: float = 0.005):
        import threading
        self._interval = interval
        self._stop = threading.Event()
        self.peak_bytes = 0
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _read(self) -> int:
        try:
            with open("/proc/self/statm") as fh:
                return int(fh.read().split()[1]) * self._page
        except OSError:  # pragma: no cover - non-Linux
            return 0

    def _loop(self):
        while not self._stop.is_set():
            self.peak_bytes = max(self.peak_bytes, self._read())
            self._stop.wait(self._interval)

    def __enter__(self):
        self.peak_bytes = self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.peak_bytes = max(self.peak_bytes, self._read())


def _cuda_devices() -> range:
    return range(torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)


def _synchronize() -> None:
    for i in _cuda_devices():
        torch.cuda.synchronize(i)


def timed_fit(make_estimator, X, y, *, warmup=True,
              track_memory=True, repeats=1) -> FitTiming:
    """Time ``make_estimator().fit(X, y)``, the first fit excluded.

    ``make_estimator`` is a zero-argument factory: the warm-up fit runs on
    a fresh instance at the same shape, so the timed fit finds the kernels
    built and the allocator's blocks cached.  Each timed fit ends with the
    visible CUDA devices synchronised.  ``track_memory`` samples peak host
    RSS during the timed fits and reads the largest
    ``torch.cuda.max_memory_allocated`` of the visible devices, reset
    before them.  ``repeats`` timed fits report the fastest; peak memory
    is the largest over them.
    """
    t0 = time.perf_counter()
    if warmup:
        make_estimator().fit(X, y)
        _synchronize()
    t_warm = time.perf_counter() - t0

    if track_memory:
        for i in _cuda_devices():
            torch.cuda.reset_peak_memory_stats(i)
    seconds = float("inf")
    rss_mb = 0.0
    for _ in range(max(1, int(repeats))):
        est = make_estimator()
        sampler = (_RssSampler() if track_memory
                   else contextlib.nullcontext())
        _synchronize()
        t0 = time.perf_counter()
        with sampler:
            est.fit(X, y)
            _synchronize()
        seconds = min(seconds, time.perf_counter() - t0)
        if isinstance(sampler, _RssSampler):
            rss_mb = max(rss_mb, sampler.peak_bytes / 2**20)
    dev_mb = (max((torch.cuda.max_memory_allocated(i)
                   for i in _cuda_devices()), default=0) / 2**20
              if track_memory else 0.0)
    return FitTiming(seconds, t_warm, int(np.shape(X)[0]),
                     int(np.shape(X)[1]), peak_rss_mb=rss_mb,
                     peak_device_mb=dev_mb)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the enclosed region, CPU and (with a
    card) CUDA activity, written to ``logdir/trace.json`` as a Chrome
    trace; yields the profiler (``key_averages()`` and so on).  With the
    package's logger at INFO the program's spans (``utils/logging.py``)
    are nested ``user_annotation`` ranges of the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
