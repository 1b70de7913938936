"""Device seconds of the discrete engine's pass 2 a fit: the program's
span ``discrete.pass2`` around each focal block's segment-restricted
window GEMMs and their epilogue (``_accumulate_plan``), timed by CUDA
events on the card, summed over the blocks.  Averaged over the
unprofiled fits of the traced window; nothing to read where the program
has no such span."""

from portbench.spans import span_seconds

LAYER = "Discrete engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "snp-paper.multisurf-resident"]
SPAN = "discrete.pass2"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
