"""The share of the card's roofline that a fit on continuous data
reaches: the least time its work needs over the fit's device-busy
seconds (the union of every kernel, copy and fill of the fit).

The work is a function of (n, p) alone: a range-scaled L1 diff of one
(i, j, f) folded into a sum costs 3 float32 operations (a subtract and a
fused multiply-add; |.| is an operand modifier), in pass 1 as in pass 2.
Pass 1 needs each unordered pair once (D is symmetric), pass 2 each
ordered pair: ops = 3 p (n^2 / 2 + n^2) = 4.5 p n^2, at the float32 peak
outside the tensor cores.  Bytes: X read once (4 n p) and the scores
written once (4 p), at the HBM peak.  The larger bound is the least
time; ``bound`` says which.  The same for MultiSURF and ReliefF, whose
rules are not counted."""

from statistics import fmean

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_s"
WORKLOADS = ["large-n.relieff", "large-n.multisurf"]


def least_seconds(n: int, p: int, peaks: dict):
    compute = 4.5 * p * n * n / (peaks["fp32_tflops"] * 1e12)
    memory = (4.0 * n * p + 4.0 * p) / (peaks["hbm_gbps"] * 1e9)
    return max(compute, memory), "compute" if compute >= memory else "memory"


def read(ctx):
    if not ctx.device_fits or not ctx.peaks:
        return None
    c = ctx.config
    least, bound = least_seconds(int(c["n_samples"]), int(c["n_features"]),
                                 ctx.peaks)
    busy = fmean(f.busy_s for f in ctx.device_fits)
    return 100.0 * least / busy, {"bound": bound}
