"""Seconds a fit spends validating its input: the program's span
``fit.validate`` (``validate_data`` or the tensor checks, and the
parameters), by the host clock.  Averaged over the unprofiled fits of the
traced window; nothing to read where the program has no such span."""

from portbench.spans import span_seconds

LAYER = "Estimator"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "large-n.relieff", "large-n.multisurf"]
SPAN = "fit.validate"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
