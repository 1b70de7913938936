"""Seconds of the discrete engine a fit: its phase
``relief_discrete.engine_v2[<algo>]`` (or ``relief_discrete.engine[...]``
on tier v1), which synchronises the card at both ends with INFO on.
Averaged over the unprofiled fits of the traced window."""

from statistics import fmean

from portbench.tracing import has_phase, phase_seconds

LAYER = "Discrete engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "snp-paper.multisurf-resident"]
PHASES = ("relief_discrete.engine",)


def read(ctx):
    if not has_phase(ctx.unprofiled, *PHASES):
        return None
    return fmean(phase_seconds(recs, *PHASES) for _, recs in ctx.unprofiled)
