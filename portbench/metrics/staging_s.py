"""Seconds of the staging steps of a fit of host X: the host casts into
the pinned buffers (``staging.cast``), the copies on the side stream
(``staging.h2d``, CUDA events) and the column analysis on the card
(``staging.analysis``), summed as ``utils/staging.py`` logs them (the
steps overlap in its pipeline, so the sum may pass their wall time).
The sweep's own span, ``staging.analyze``, holds them and is left out.
Averaged over the unprofiled fits of the traced window."""

from statistics import fmean

from portbench.tracing import has_phase, phase_seconds

LAYER = "Staging and analysis"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "large-n.relieff", "large-n.multisurf"]
STEPS = ("staging.cast", "staging.h2d", "staging.analysis")


def read(ctx):
    if not has_phase(ctx.unprofiled, *STEPS):
        return None
    return fmean(phase_seconds(recs, *STEPS) for _, recs in ctx.unprofiled)
