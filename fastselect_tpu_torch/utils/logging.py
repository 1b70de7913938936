"""Timed engine phases, logged at INFO.

Counterpart of ``fastselect_tpu/utils/logging.py``.  The engines wrap
their phases (the fused engine, the discrete engine's encoding, copy to
the device and block loops) in :func:`phase`, which logs each one's
seconds, and work per second where a work estimate is given, through the
standard ``logging`` module under the ``fastselect_tpu_torch`` logger:

    import logging
    logging.basicConfig()
    logging.getLogger("fastselect_tpu_torch").setLevel(logging.INFO)

PyTorch returns before the card finishes, so with INFO enabled a phase
synchronises every visible CUDA device where it starts and where it ends:
the time is the device's, not the launch time.  With INFO disabled a phase
costs one level check and never synchronises.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

logger = logging.getLogger("fastselect_tpu_torch")


def _synchronize() -> None:
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def phase(name: str, work: float | None = None):
    """Time the enclosed phase and log it at INFO (nothing if disabled)."""
    if not logger.isEnabledFor(logging.INFO):
        yield
        return
    _synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronize()
        log_seconds(name, time.perf_counter() - t0, work)


def log_seconds(name: str, seconds: float, work: float | None = None) -> None:
    """Log one phase record at INFO, as :func:`phase` does: for steps
    timed otherwise (``utils/staging.py`` sums its steps over a loop)."""
    if work is not None and seconds > 0:
        logger.info("%s: %.4fs (%.3e work/s)", name, seconds, work / seconds)
    else:
        logger.info("%s: %.4fs", name, seconds)
