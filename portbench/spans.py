"""Reading the program's span records (``utils/logging.py``): with the
``fastselect_tpu_torch`` logger at INFO a fit logs one record per span
name, ``name: <seconds>s n=<times opened>``, which
:class:`portbench.tracing.PhaseCapture` keeps as (name, seconds)."""

from statistics import fmean


def span_seconds(fits, name: str) -> float | None:
    """Mean seconds a fit of the records of span ``name`` (exactly that
    name, summed where a fit logs it more than once), over ``fits`` as
    ``TraceContext.unprofiled`` holds them; None where no fit has one."""
    per_fit = [sum(sec for n, sec in recs if n == name) for _, recs in fits]
    if not any(n == name for _, recs in fits for n, _ in recs):
        return None
    return fmean(per_fit)
