"""Host-side seconds of a fit outside the Relief engine: validation,
the column analysis, staging, routing, the layout copies, the argsort of
the scores.  The traced fit's wall time minus its engine phase
(``relief_discrete.engine*``, ``relief_cuda.engine*``; with INFO on each
phase synchronises the card), averaged over the fits of the traced
window that ran without the profiler."""

from statistics import fmean

from portbench.tracing import has_phase, phase_seconds

LAYER = "Estimator"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "large-n.relieff", "large-n.multisurf",
             "snp-paper.multisurf-resident"]
ENGINES = ("relief_discrete.engine", "relief_cuda.engine")


def read(ctx):
    if not has_phase(ctx.unprofiled, *ENGINES):
        return None
    return fmean(wall - phase_seconds(recs, *ENGINES)
                 for wall, recs in ctx.unprofiled)
