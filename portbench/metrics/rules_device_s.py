"""Device seconds a fit of every kernel but the fused engine's pass-1
and pass-2 kernels (``csrc/relief_pass1.cu`` ``dist_kernel``,
``csrc/relief_pass2.cu`` ``accum_kernel_*``), copies and fills left
out: the weight rules between the passes (MultiSURF's thresholds,
ReliefF's one stable sort a focal row), and also the few milliseconds of
the column analysis and the layout copies.  From the profiler's trace,
averaged over the profiled fits."""

from statistics import fmean

LAYER = "Weight rules"
UNIT = "s"
SOURCE = "device_trace"
MOVES = "fit_s"
WORKLOADS = ["large-n.relieff", "large-n.multisurf"]
PASS_KERNELS = ("dist_kernel", "accum_kernel")


def read(ctx):
    if not ctx.device_fits:
        return None
    return fmean(sum(sec for name, sec in f.kernels().items()
                     if not any(k in name for k in PASS_KERNELS))
                 for f in ctx.device_fits)
