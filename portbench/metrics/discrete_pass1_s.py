"""Device seconds of the discrete engine's pass 1 a fit: the program's
span ``discrete.pass1`` around each focal block's match counts (the int8
one-hot GEMMs of ``_match_rows``), timed by CUDA events on the card,
summed over the blocks.  Averaged over the unprofiled fits of the traced
window; nothing to read where the program has no such span."""

from portbench.spans import span_seconds

LAYER = "Discrete engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "snp-paper.multisurf-resident"]
SPAN = "discrete.pass1"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
