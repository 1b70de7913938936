"""Spans, phases and counters of a fit, logged at INFO.

Counterpart of ``fastselect_tpu/utils/logging.py``.  Every layer of the
Relief path reports through one recorder, switched by the standard
``logging`` module under the ``fastselect_tpu_torch`` logger:

    import logging
    logging.basicConfig()
    logging.getLogger("fastselect_tpu_torch").setLevel(logging.INFO)

* :func:`span` opens a named range.  Ranges nest in a tree, a stack a
  thread: each has an id, its parent's id, its start on
  ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux; a Chrome trace of
  ``torch.profiler`` is on Unix time less its ``baseTimeNanoseconds``, a
  constant offset from it within a process) and its host seconds.  A
  span of work on a CUDA device (``device=``) is timed by a pair of CUDA
  events on the device's current stream, read once where the records are
  logged: at the root's close, after one wait on the last event of each
  stream, or at a phase's close, which has synchronised.  Nothing
  synchronises inside the tree.  On any other device the host clock times
  a span.
  Each span is also a ``torch.profiler.record_function`` range, so a
  profiler trace shows the tree as nested ``user_annotation`` ranges.
* A span opened with no open parent is a root (an estimator's ``fit``:
  :func:`fit_span`).  When it closes it logs one record per span name, in
  order of first opening, ``name: <seconds>s n=<times opened>``; its own
  record also carries the counter deltas over it as ``key=value`` pairs.
* :func:`phase` is a span that synchronises every visible CUDA device
  where it starts and where it ends, so that its host seconds are the
  device's, and that logs its own record at its close, after those of the
  spans it holds: ``name: <seconds>s`` (with work per second where a work
  estimate is given).  A phase with no fit open around it is a root.
* :func:`count` adds to a named counter; :func:`counters` registers a
  dict that code increments itself (the kernels' ``launches``), read as
  ``<prefix>.<key>``.

Each record also carries its spans' ``(id, parent id, start ns, host s,
s)`` as the ``spans`` attribute of its ``logging.LogRecord``, and a
root's record the ``counts`` it printed.  With INFO disabled every call
costs one cached level check: no CUDA event, no profiler range, no
synchronisation, no allocation and no record.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import threading
import time

import torch

logger = logging.getLogger("fastselect_tpu_torch")

_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_stack = threading.local()
_counts: dict[str, int] = {}
_sources: list[tuple[str, dict]] = []


def _on() -> bool:
    return logger.isEnabledFor(logging.INFO)


def _synchronize() -> None:
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _cuda_device(device):
    """The CUDA device a span's work runs on, or None: ``True`` is the
    current CUDA device where there is one."""
    if device is True:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else None)
    if device is False or device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _snapshot() -> dict[str, int]:
    snap = dict(_counts)
    for prefix, source in _sources:
        for key, value in source.items():
            snap[f"{prefix}.{key}"] = value
    return snap


class _Span:
    """One opening of a named range (see the module's docstring)."""

    __slots__ = ("name", "device", "sync", "work", "id", "parent", "root",
                 "tree", "ends", "index", "counts", "range", "stream",
                 "events", "start_ns", "host_s", "logged")

    def __init__(self, name, device=None, *, sync=False, work=None):
        self.name = name
        self.device = device    # a CUDA device, timed by events, or None
        self.sync = sync
        self.work = work
        self.events = None
        self.logged = False

    def __enter__(self):
        stack = getattr(_stack, "spans", None)
        if stack is None:
            stack = _stack.spans = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent else 0
        self.root = parent.root if parent else self
        if parent is None:
            self.tree = []
            self.ends = {}      # stream -> the last end event recorded on it
            self.counts = _snapshot()
        self.index = len(self.root.tree)
        self.root.tree.append(self)
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.sync:
            _synchronize()
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            self.events = (start, None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                if self.sync:
                    _synchronize()
                if self.events is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(self.stream)
                    self.events = (self.events[0], end)
                    self.root.ends[self.stream] = end
                self.host_s = (time.perf_counter_ns() - self.start_ns) / 1e9
        finally:
            self.range.__exit__(exc_type, exc, tb)
            _stack.spans.pop()
        if exc_type is not None:
            self.logged = True      # a failed span logs nothing
        else:
            if self.sync:
                _log_pending(self.root.tree[self.index + 1:])
                self._log_phase()
            if self.root is self:
                for end in self.ends.values():  # then every event is done
                    end.synchronize()
                _log_pending(self.tree, self)
        if self.root is self:
            self.tree = self.ends = None

    def seconds(self) -> float:
        """Device seconds by the events (once they are done), else host
        seconds."""
        if self.events is None:
            return self.host_s
        start, end = self.events
        return start.elapsed_time(end) / 1e3

    def _log_phase(self):
        self.logged = True
        spans = [(self.id, self.parent, self.start_ns, self.host_s,
                  self.host_s)]
        if self.work is not None and self.host_s > 0:
            logger.info("%s: %.4fs (%.3e work/s)", self.name, self.host_s,
                        self.work / self.host_s, extra={"spans": spans})
        else:
            logger.info("%s: %.4fs", self.name, self.host_s,
                        extra={"spans": spans})


def _log_pending(tree, root=None) -> None:
    """One record per name of the spans of ``tree`` not logged yet, in
    order of first opening; the record of ``root`` (``tree[0]``, unless a
    phase logged it) carries the counter deltas since it opened."""
    with_counts = root.name if root is not None and not root.logged else None
    by_name: dict[str, list] = {}
    for s in tree:
        if not s.logged:
            s.logged = True
            by_name.setdefault(s.name, []).append(
                (s.id, s.parent, s.start_ns, s.host_s, s.seconds()))
    for name, spans in by_name.items():
        extra, tail = {"spans": spans}, ""
        if name == with_counts:
            with_counts = None
            now = _snapshot()
            extra["counts"] = {k: v - root.counts.get(k, 0)
                               for k, v in now.items()
                               if v != root.counts.get(k, 0)}
            tail = "".join(f" {k}={v}" for k, v in extra["counts"].items())
        logger.info("%s: %.6fs n=%d%s", name, sum(sp[4] for sp in spans),
                    len(spans), tail, extra=extra)


def span(name: str, *, device=False):
    """A context manager timing the enclosed work as span ``name`` (see the
    module's docstring).  ``device``: the device the work runs on (a
    ``torch.device``, or True for the current CUDA device); a CUDA device
    times it by events on its current stream, anything else by the host
    clock.  A shared no-op where INFO is disabled."""
    if not _on():
        return _OFF
    return _Span(name, _cuda_device(device))


def phase(name: str, work: float | None = None):
    """A span that synchronises at both ends and logs its own record at
    its close (nothing if INFO is disabled)."""
    if not _on():
        return _OFF
    return _Span(name, sync=True, work=work)


def fit_span(fit):
    """``fit`` (an estimator's method, or a function that fits) run as the
    span ``fit[<class or function name>]``: the root of a fit's tree."""
    method = "." in fit.__qualname__

    @functools.wraps(fit)
    def traced(*args, **kwargs):
        if not _on():
            return fit(*args, **kwargs)
        owner = type(args[0]).__name__ if method else fit.__name__
        with _Span(f"fit[{owner}]"):
            return fit(*args, **kwargs)
    return traced


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` (nothing if INFO is disabled)."""
    if _on():
        _counts[name] = _counts.get(name, 0) + k


def counters(prefix: str, source: dict) -> None:
    """Report the integer values of ``source`` as counters
    ``<prefix>.<key>``: a dict its owner increments whatever the level."""
    _sources.append((prefix, source))


def log_seconds(name: str, seconds: float, **counts) -> None:
    """Log one record now, outside any tree: ``name: <seconds>s n=1`` and
    ``counts`` as ``key=value`` pairs (nothing if INFO is disabled)."""
    if _on():
        logger.info("%s: %.6fs n=1%s", name, seconds,
                    "".join(f" {k}={v}" for k, v in counts.items()),
                    extra={"counts": counts})
