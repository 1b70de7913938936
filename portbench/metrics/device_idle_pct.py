"""The share of the profiled fits' wall time in which no kernel, copy or
fill ran on the card: one minus the union of the trace's device events
over the fits' ``portbench.fit`` ranges."""

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "large-n.relieff", "large-n.multisurf",
             "snp-paper.multisurf-resident"]


def read(ctx):
    if not ctx.device_fits:
        return None
    wall = sum(f.wall_s for f in ctx.device_fits)
    busy = sum(f.busy_s for f in ctx.device_fits)
    return 100.0 * (1.0 - busy / wall)
