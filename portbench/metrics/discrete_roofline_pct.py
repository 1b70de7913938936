"""The share of the card's roofline that a fit on all-discrete data
reaches: the least time its work needs over the fit's device-busy
seconds (the union of every kernel, copy and fill of the fit).

The work is a function of (n, p, S) alone, counted as the int8 tensor
cores do it with one-hot operands: a Hamming diff of one (i, j, f)
costs S multiply-adds.  Pass 1 needs each unordered pair once (D is
symmetric), pass 2 each ordered pair (W is not):
ops = 2 S p (n^2 / 2 + n^2) = 3 S p n^2, at the int8 peak.  Bytes: X
read once (n p int8) and the scores written once (4 p), at the HBM
peak.  The larger bound is the least time; ``bound`` says which.  The
same for MultiSURF and ReliefF, whose rules are not counted."""

from statistics import fmean

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_s"
WORKLOADS = ["snp-paper.multisurf", "snp-paper.multisurf-resident"]


def least_seconds(n: int, p: int, s: int, peaks: dict):
    compute = 3.0 * s * p * n * n / (peaks["int8_tops"] * 1e12)
    memory = (n * p + 4.0 * p) / (peaks["hbm_gbps"] * 1e9)
    return max(compute, memory), "compute" if compute >= memory else "memory"


def read(ctx):
    if not ctx.device_fits or not ctx.peaks:
        return None
    c = ctx.config
    least, bound = least_seconds(int(c["n_samples"]), int(c["n_features"]),
                                 int(c["n_states"]), ctx.peaks)
    busy = fmean(f.busy_s for f in ctx.device_fits)
    return 100.0 * least / busy, {"bound": bound}
