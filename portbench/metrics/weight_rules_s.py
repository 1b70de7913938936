"""Device seconds of the weight rules a fit: the program's span
``weight_rules`` around each focal block's rules (MultiSURF's thresholds,
ReliefF's one stable sort a focal row), timed by CUDA events on the
card, summed over the blocks.  Averaged over the unprofiled fits of the
traced window; nothing to read where the program has no such span."""

from portbench.spans import span_seconds

LAYER = "Weight rules"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "large-n.relieff", "large-n.multisurf",
             "snp-paper.multisurf-resident"]
SPAN = "weight_rules"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
