"""Device seconds a fit of the discrete engine's pass 2 over the focal
blocks that straddle a class boundary: the program's span
``discrete.straddle``, inside ``discrete.pass2`` around such a block's
products, which contract each rule over the full sample span (both
masks), timed by CUDA events on the card, summed over the blocks.
Averaged over the unprofiled fits of the traced window; nothing to read
where the program has no such span."""

from portbench.spans import span_seconds

LAYER = "Discrete engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"
WORKLOADS = ["wtccc1.multisurf-resident"]
SPAN = "discrete.straddle"


def read(ctx):
    return span_seconds(ctx.unprofiled, SPAN)
