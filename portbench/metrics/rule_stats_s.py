"""Device seconds of MultiSURF's and SURF's row statistics a fit: the
program's span ``weight_rules.stats`` inside ``weight_rules``, around each
focal block's shifted row means, variances and thresholds, timed by CUDA
events on the card, summed over the blocks.  Averaged over the unprofiled
fits of the traced window; nothing to read where the program has no such
span."""

from portbench.spans import span_seconds

LAYER = "Weight rules"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["large-p.multisurf", "large-n.multisurf", "snp-paper.multisurf",
             "snp-paper.multisurf-resident"]
SPAN = "weight_rules.stats"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
