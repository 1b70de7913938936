"""Seconds the fused engine spends planning a fit: the program's span
``fused.plan`` (the focal block's size from the device's free memory, and
the padded, kind-ordered copy of X), by the host clock.  Averaged over the
unprofiled fits of the traced window; nothing to read where the program
has no such span."""

from portbench.spans import span_seconds

LAYER = "Fused engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["large-n.relieff", "large-n.multisurf"]
SPAN = "fused.plan"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
