"""Seconds of the fused engine a fit: its phase
``relief_cuda.engine[<algo>]`` (both kernel passes and the weight rules
between them), which synchronises the card at both ends with INFO on.
Averaged over the unprofiled fits of the traced window."""

from statistics import fmean

from portbench.tracing import has_phase, phase_seconds

LAYER = "Fused engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["large-n.relieff", "large-n.multisurf"]
PHASES = ("relief_cuda.engine",)


def read(ctx):
    if not has_phase(ctx.unprofiled, *PHASES):
        return None
    return fmean(phase_seconds(recs, *PHASES) for _, recs in ctx.unprofiled)
