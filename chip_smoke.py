#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

Phases, one or two lines each on stdout:

1. environment: torch, CUDA, the card and its power limit, nvcc, triton;
2. build: ``nvcc`` compiles ``fastselect_tpu_torch/csrc/*.cu`` for sm_90a,
   and ptxas's registers and spills of every kernel;
3. each kernel against its plain PyTorch version on the card: square and
   rectangular focal blocks, a shape ragged in nb, n and p, and large-p's
   128 x 128 x 100,000, whose pass 1 splits its features; for the
   ``MIXED`` kernels (60, 14, 30% of the columns discrete, leading) also
   every third column discrete and all columns discrete.  Pass 1 of
   either kind bit for bit, pass 2 within ``SCORE_RTOL`` and the same
   over two launches.  Then each kernel timed with CUDA events at the
   shapes the main path gives it and with features padded to 32 as the
   engines once padded them (p = 128 and 224), for comparison, the
   continuous ones also at mixed-square's continuous half, the ``MIXED``
   ones also all-discrete at 4,096 x 4,096 x 16,384, beside its bound,
   its plain version (whose output the kernel's is held against there as
   above: mixed-xl's focal block included) and, for pass 1,
   ``torch.cdist`` (p=1 continuous, p=0 all-discrete);
4. ``MultiSURF().fit`` at the upstream reference's large-n point,
   50,000 samples x 100 continuous features, first and warm;
5. the same at its large-p point, 100 samples x 100,000 features;
6. a small mixed fit (2,000 x 200 with 40 integer-valued columns) on the
   hybrid engine, a mixed fit with a 150-state discrete column on the
   fused engine's ``MIXED`` kernels, mixed-xl (150,000 x 100 with 40
   columns cut to 0..2: past the hybrid engine's 131,072 samples, so the
   ``MIXED`` kernels over 293 focal blocks of 512 rows), first and warm,
   against the hybrid engine called directly on the same rows, and
   MultiSURF and MultiSURF* on a 37 x 19 mixed input against the numpy
   oracle of the reference's semantics in ``tests/oracles.py``;
7. the SNP headline: ``MultiSURF().fit`` on 16,384 x 65,536 int8
   genotypes, through the integer fast path and the symmetric tier of the
   all-discrete engine (int8 GEMMs), timed first and warm, with the
   engine's int8 rate and peak memory; then the same genotypes fitted as
   an int8 tensor already on the card;
8. the engine's other tiers: v1 (ReliefF, 3,000 x 5,000, 3 classes), the
   v2 block loop (MultiSURF*, 30,000 x 2,048) and v2-sym again (SURF,
   8,192 x 16,384 float input, encoded on the card);
9. SURF and ReliefF on continuous data (10,000 x 100), ReliefF at
   50,000 x 100, and SURF, SURF* and ReliefF against ``tests/oracles.py``
   on the small mixed inputs of ``tests/test_surf.py`` and
   ``tests/test_relieff.py``;
10. the hybrid engine at size: mixed-square (16,384 x 4,096, half
    genotypes, one square class-sorted block) and mixed-large-n
    (50,000 x 100 with 40 columns cut to 0..2, focal blocks);
11. device-fit: the large-n data fitted as a float32 tensor on the card,
    against the host-array fit;
12. TuRF's fast scorer (4,096 x 16,384 genotypes, 10,000 x 1,000
    continuous, the same with 100 columns cut to 0..2) against a TuRF that
    re-fits its base estimator each round;
13. ``chi2`` on a float32 tensor of 2,000 x 200,000 counts on the card
    against the float64 host path.

Phases 4-6 are the main path of the four kernels: every kernel launch
count is set to 0 before them and read after them, less the launches of
the small mixed fit's ``MIXED``-kernel reference and of mixed-xl's
hybrid referee, and each kernel must have been launched there by a fit
(the ``MIXED`` kernels by the 150-state and mixed-xl fits).
Each fused-engine fit there and in phase 9 is held against the same
engine run on the card with the plain PyTorch passes.  Phases 7 and 8 are
the all-discrete path: the GEMM operation count is set to 0 before each
fit and read after it, no fused kernel may launch in it, and each fit is
held against the fused engine with the ``MIXED`` kernels on the same data
as float32, the route all-discrete data took before.  Each hybrid fit
must launch the continuous kernels and the int8 GEMMs and no ``MIXED``
kernel, and is held against the fused engine with the ``MIXED`` kernels
on the same rows in the hybrid's order.  Any failed check raises, so the
script exits non-zero; it also fails when no CUDA device is present.  The
line before the last is a JSON summary of the kernels (launches, errors,
times, bounds and registers, per timed shape); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fastselect_tpu_torch import MultiSURF, ReliefF, SURF, TuRF, _build, chi2
from fastselect_tpu_torch.models import _relief_base
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.ops import relief_hybrid as rh
from fastselect_tpu_torch.ops.chi2_op import chi2_stats_exact
from fastselect_tpu_torch.ops.relief import relief_engine
from fastselect_tpu_torch.utils.preprocessing import analyze_features

# Kernel name -> (source, Pallas kernel it replaces)
KERNELS = {
    "relief_pass1_cont": ("fastselect_tpu_torch/csrc/relief_pass1.cu",
                          "fastselect_tpu/ops/relief_pallas.py:82"),
    "relief_pass1_mixed": ("fastselect_tpu_torch/csrc/relief_pass1.cu",
                           "fastselect_tpu/ops/relief_pallas.py:63"),
    "relief_pass2_cont": ("fastselect_tpu_torch/csrc/relief_pass2.cu",
                          "fastselect_tpu/ops/relief_pallas.py:126"),
    "relief_pass2_mixed": ("fastselect_tpu_torch/csrc/relief_pass2.cu",
                           "fastselect_tpu/ops/relief_pallas.py:103"),
}
# __global__ functions of each kernel, as ptxas names them (mangled: pass
# 1's kind template has the instances ILb0 and ILb1)
KERNEL_FUNCTIONS = {"relief_pass1_cont": ("dist_kernelILb0",
                                          "split_sum_kernel"),
                    "relief_pass1_mixed": ("dist_kernelILb1",
                                           "split_sum_kernel"),
                    "relief_pass2_cont": ("accum_kernel_cont",),
                    "relief_pass2_mixed": ("accum_kernel_mixed",)}
# pass 1 of either kind must equal its plain version bit for bit
SCORE_RTOL = 1e-3    # pass 2 against its plain version, relative to max|s|
FIT_ATOL = 1e-4      # fitted scores against the plain-pass engine
ORACLE_ATOL = 2e-6   # against tests/oracles.py, as tests/test_multisurf.py
ORACLE_ATOL_SR = 5e-6  # as tests/test_surf.py and tests/test_relieff.py
DEVICE_FIT_ATOL = 1e-6  # a tensor fit against the host-array fit (expected: 0)
TURF_ATOL = 1e-5     # TuRF's fast scorers against its re-fitting loop
CHI2_RTOL = 1e-4     # chi2 on the card against the float64 host path
INT8_PEAK_TOPS = 1979.0  # H100 SXM dense int8, NVIDIA's data sheet
FP32_PEAK_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (700 W)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ALGO = {"MultiSURF": "multisurf", "SURF": "surf", "ReliefF": "relieff"}


# ---------------------------------------------------------------------------
# Data: sklearn.datasets.make_classification, reproduced draw for draw
# ---------------------------------------------------------------------------

def _sample_without_replacement(n_population, n_samples, rng):
    """sklearn.utils.random.sample_without_replacement, method 'auto'."""
    ratio = n_samples / n_population if n_population else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, np.int64)
    if ratio < 0.2:   # tracking selection
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
        return out
    out[:] = np.arange(n_samples)   # reservoir sampling
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def _hypercube(samples, dimensions, rng):
    if dimensions > 30:
        return np.hstack([rng.randint(2, size=(samples, dimensions - 30)),
                          _hypercube(samples, 30, rng)])
    out = _sample_without_replacement(2 ** dimensions, samples, rng)
    out = out.astype(">u4", copy=False)
    return np.unpackbits(out.view(">u1")).reshape((-1, 32))[:, -dimensions:]


def make_classification(n_samples=100, n_features=20, *, n_informative=2,
                        n_redundant=2, n_classes=2, n_clusters_per_class=2,
                        flip_y=0.01, class_sep=1.0, random_state=0):
    """The data of ``sklearn.datasets.make_classification`` with the same
    arguments (no repeated features, hypercube, no shift or scale,
    shuffled): the same ``RandomState`` draws in the same order.  The
    script must also run where scikit-learn is not installed."""
    rng = np.random.RandomState(random_state)
    n_random = n_features - n_informative - n_redundant
    n_clusters = n_classes * n_clusters_per_class
    per_cluster = [int(n_samples * (1.0 / n_classes) / n_clusters_per_class)
                   for _ in range(n_clusters)]
    for i in range(n_samples - sum(per_cluster)):
        per_cluster[i % n_clusters] += 1
    X = np.zeros((n_samples, n_features))
    y = np.zeros(n_samples, dtype=int)
    centroids = _hypercube(n_clusters, n_informative, rng).astype(float)
    centroids *= 2 * class_sep
    centroids -= class_sep
    X[:, :n_informative] = rng.standard_normal(size=(n_samples, n_informative))
    stop = 0
    for k, centroid in enumerate(centroids):
        start, stop = stop, stop + per_cluster[k]
        y[start:stop] = k % n_classes
        X_k = X[start:stop, :n_informative]
        A = 2 * rng.uniform(size=(n_informative, n_informative)) - 1
        X_k[...] = np.dot(X_k, A)
        X_k += centroid
    if n_redundant > 0:
        B = 2 * rng.uniform(size=(n_informative, n_redundant)) - 1
        X[:, n_informative:n_informative + n_redundant] = np.dot(
            X[:, :n_informative], B)
    if n_random > 0:
        X[:, -n_random:] = rng.standard_normal(size=(n_samples, n_random))
    flip = rng.uniform(size=n_samples) < flip_y
    y[flip] = rng.randint(n_classes, size=flip.sum())
    order = np.arange(n_samples)
    rng.shuffle(order)
    X, y = X[order], y[order]
    cols = np.arange(n_features)
    rng.shuffle(cols)
    X[:, :] = X[:, cols]
    return X, y


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_inputs(dev, n, p, n_disc, seed, stride=1):
    """Padded-engine-like inputs: X (n, p) with n_disc integer-valued
    columns flagged discrete (every ``stride``-th from column 0: by
    default the leading ones, the engine's layout), and recip from the
    column ranges."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, p).astype(np.float32)
    cols = np.arange(n_disc) * stride
    x[:, cols] = rng.randint(0, 3, (n, n_disc))
    disc = np.zeros(p, np.float32)
    disc[cols] = 1.0
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-6)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(x), t(recip), t(disc)


def fit_tol(ref):
    """FIT_ATOL, relative to the largest score where that exceeds 1: SURF's
    unit weights make its scores grow with n."""
    return FIT_ATOL * max(1.0, float(np.abs(ref).max()))


def engine_args(est, y_enc):
    """The engine arguments the estimator's fit passes for labels y_enc."""
    kw = dict(algo=ALGO[type(est).__name__],
              use_star=getattr(est, "use_star", False))
    if kw["algo"] == "relieff":
        kw.update(n_neighbors=est.n_neighbors,
                  class_probs=(np.bincount(y_enc) / len(y_enc)).astype(
                      np.float32))
    return kw


def timed_fit(dev, est, X, y):
    """(fitted est, seconds, peak device GB) of one fit on the card."""
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(X, y)
    torch.cuda.synchronize()
    return (est, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(dev) / 1e9)


def fit_phase(dev, label, X, y, must_launch, n_select=10, make=MultiSURF,
              warm=0, **params):
    """Fit through the estimator (then ``warm`` more, timed), check that it
    launched the kernels named in must_launch, then hold it against the
    plain-pass engine on the card.  Returns the fitted estimator and the
    first fit's seconds."""
    est = make(n_features_to_select=n_select, **params)
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    plan = rc.block_plan(X.shape[0], X.shape[1], dev, kw["algo"])
    before = dict(rc.launches)
    est, fit_s, peak_gb = timed_fit(dev, est, X, y)
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    warm_s = [timed_fit(dev, make(n_features_to_select=n_select, **params),
                        X, y)[1] for _ in range(warm)]
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    for name in must_launch:
        check(moved[name] > 0, f"{label}: the fit launched {name}")
    check(s.shape == (X.shape[1],) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({X.shape[1]},)")
    x_dev = torch.tensor(X, dtype=torch.float32, device=dev)
    fa = analyze_features(x_dev, est.discrete_limit)
    t0 = time.perf_counter()
    ref = rc.relief_fused_scores(
        x_dev, y_enc, fa.recip, fa.is_discrete, device=dev,
        _pass1=rc.dist_matrix_ref, _pass2=rc.accumulate_ref, **kw)
    ref_s = time.perf_counter() - t0
    ref_top = np.argsort(ref)[::-1][:n_select]
    err = float(np.abs(s - ref).max())
    check(err <= fit_tol(ref), f"{label}: max |scores - plain engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    print(f"{label}: {type(est).__name__} X {X.shape[0]}x{X.shape[1]} fit "
          f"{fit_s:.4f} s{''.join(f', warm {t:.4f} s' for t in warm_s)} "
          f"(plain-pass engine {ref_s:.4f} s); n_pad "
          f"{plan.n_pad} p_pad {plan.p_pad} nb {plan.nb} "
          f"({plan.n_pad // plan.nb} blocks); peak {peak_gb:.2f} GB; "
          f"launches {moved}; max |scores - plain| {err:.3e}; top_features_ "
          f"{est.top_features_.tolist()} equal", flush=True)
    return est, fit_s


def load_oracles():
    spec = importlib.util.spec_from_file_location(
        "oracles", Path(__file__).resolve().parent / "tests" / "oracles.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def oracle_phase():
    """The estimator on the card against the numpy oracle of the
    reference's CPU semantics (tests/oracles.py), on the small mixed input
    of tests/test_multisurf.py::test_oracle_parity."""
    oracle = load_oracles()
    rng = np.random.RandomState(0)
    X = rng.rand(37, 19).astype(np.float32)
    X[:, 3] = rng.randint(0, 3, 37)
    X[:, 7] = rng.randint(0, 5, 37)
    y = rng.randint(0, 2, 37)
    for use_star in (False, True):
        est = MultiSURF(n_features_to_select=5, use_star=use_star).fit(X, y)
        want = oracle.multisurf_scores(X, y, use_star=use_star)
        err = float(np.abs(est.feature_importances_ - want).max())
        check(est.effective_backend_ == "cuda", "oracle: on the card")
        check(err <= ORACLE_ATOL, f"oracle use_star={use_star}: err {err}")
        check(np.array_equal(np.argsort(est.feature_importances_),
                             np.argsort(want)),
              f"oracle use_star={use_star}: ranking")
        print(f"oracle: MultiSURF(use_star={use_star}) 37x19 mixed on the "
              f"card vs tests/oracles.py: max |scores - oracle| {err:.3e}, "
              f"ranking equal", flush=True)


def oracle_phase_surf_relieff():
    """SURF, SURF* and ReliefF on the card against tests/oracles.py, on
    the inputs of tests/test_surf.py::test_oracle_parity and
    tests/test_relieff.py::test_oracle_parity_{binary,multiclass}."""
    oracle = load_oracles()
    cases = []
    for use_star in (False, True):
        rng = np.random.RandomState(0)
        X = rng.rand(41, 23).astype(np.float32)
        X[:, 5] = rng.randint(0, 4, 41)
        y = rng.randint(0, 2, 41)
        cases.append((SURF(n_features_to_select=5, use_star=use_star), X, y,
                      oracle.surf_scores(X, y, use_star=use_star)))
    for k in (1, 3, 7):
        rng = np.random.RandomState(0)
        X = rng.rand(35, 13).astype(np.float32)
        X[:, 2] = rng.randint(0, 3, 35)
        y = rng.randint(0, 2, 35)
        cases.append((ReliefF(n_features_to_select=5, n_neighbors=k), X, y,
                      oracle.relieff_scores(X, y, k=k)))
    rng = np.random.RandomState(0)
    X = rng.rand(42, 9).astype(np.float32)
    y = rng.randint(0, 4, 42)
    cases.append((ReliefF(n_features_to_select=3, n_neighbors=3), X, y,
                  oracle.relieff_scores(X, y, k=3)))
    for est, X, y, want in cases:
        est.fit(X, y)
        err = float(np.abs(est.feature_importances_ - want).max())
        name = (f"{type(est).__name__}(use_star={est.use_star})"
                if isinstance(est, SURF)
                else f"ReliefF(n_neighbors={est.n_neighbors})")
        check(est.effective_backend_ == "cuda", "oracle: on the card")
        check(err <= ORACLE_ATOL_SR, f"oracle {name}: err {err}")
        print(f"oracle: {name} {X.shape[0]}x{X.shape[1]} on the card vs "
              f"tests/oracles.py: max |scores - oracle| {err:.3e}",
              flush=True)


# ---------------------------------------------------------------------------
# The all-discrete engine
# ---------------------------------------------------------------------------

def planted_genotypes(seed, n, p, n_classes, strengths=(0.6, 0.45, 0.3)):
    """Genotypes 0..2 with labels; column j carries the label in a share
    ``strengths[j]`` of the rows, so that the top features are far apart."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 3, (n, p), dtype=np.int8)
    y = rng.randint(0, n_classes, n)
    for j, share in enumerate(strengths):
        keep = rng.rand(n) < share
        X[keep, j] = (y[keep] % 3).astype(np.int8)
    return X, y


def fused_mixed_scores(dev, X, y_enc, kw, order, recip=None,
                       is_discrete=None):
    """The fused engine with the MIXED kernels on X as float32, rows in
    ``order`` (the discrete or hybrid engine's), with every column
    discrete and recip 1 unless given: (scores, seconds, launches).  Both
    engines then add D in the same row order in the weight rules' float32
    row sums."""
    before = dict(rc.launches)
    xs = torch.from_numpy(np.ascontiguousarray(X[order])).to(dev)
    xs = xs.to(torch.float32)
    p = X.shape[1]
    if recip is None:
        recip = torch.ones(p, device=dev)
        is_discrete = torch.ones(p, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rc.relief_fused_scores(
        xs, y_enc[order], recip, is_discrete, device=dev, **kw)
    sec = time.perf_counter() - t0
    del xs
    torch.cuda.empty_cache()
    return ref, sec, {k: rc.launches[k] - before[k] for k in rc.launches}


def discrete_phase(dev, label, est, X, y, tier, warm=0):
    """An all-discrete fit on the card: the tier it must take, no fused
    launch, GEMM work counted, and its scores held against the fused
    engine with the MIXED kernels.  Returns a dict of what it measured."""
    n, p = X.shape
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    got = rd.discrete_tier(n, p, 3, y_enc, kw["algo"],
                           kw.get("class_probs"), device=dev)
    check(got == tier, f"{label}: tier {got}, expected {tier}")
    before = dict(rc.launches)
    times, peaks = [], []
    for _ in range(1 + warm):
        rd.reset_gemm_ops()
        est, sec, peak = timed_fit(dev, est, X, y)
        times.append(sec)
        peaks.append(peak)
    ops = rd.gemm_ops
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(not any(moved.values()), f"{label}: fused launches {moved}")
    check(ops > 0, f"{label}: no int8 GEMM ran")
    check(est.is_discrete_.all(), f"{label}: every column discrete")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")
    check(est.top_features_[0] == 0, f"{label}: column 0 ranks first")

    order = (np.arange(n) if tier == "v1"
             else np.argsort(y_enc, kind="stable"))
    ref, ref_s, ref_moved = fused_mixed_scores(dev, X, y_enc, kw, order)
    ref_top = np.argsort(ref)[::-1][:len(est.top_features_)]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_mixed"] > 0
          and ref_moved["relief_pass2_mixed"] > 0,
          f"{label}: reference launched the MIXED kernels")
    check(err <= fit_tol(ref), f"{label}: max |scores - MIXED engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    warm_s = f", warm {', '.join(f'{t:.4f}' for t in times[1:])} s" \
        if warm else ""
    print(f"{label}: {type(est).__name__} X {n}x{p} {X.dtype} tier {tier}; "
          f"fit {times[0]:.4f} s{warm_s}; gemm_ops {ops:.4e}; peak "
          f"{max(peaks):.2f} GB; MIXED-kernel fused engine {ref_s:.4f} s; "
          f"max |scores - MIXED| {err:.3e}; top_features_ "
          f"{est.top_features_.tolist()} equal", flush=True)
    return dict(first_s=times[0], warm_s=times[1:], gemm_ops=ops,
                peak_gb=max(peaks), mixed_s=ref_s, err=err, scores=s)


def engine_rate(dev, X, y):
    """The engine alone on device-resident codes: (seconds, int8 ops)."""
    codes = torch.from_numpy(X).to(dev)
    rd.reset_gemm_ops()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd.relief_discrete_scores(None, y, algo="multisurf", codes=codes,
                              n_states=3)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, rd.gemm_ops


# ---------------------------------------------------------------------------
# The hybrid engine, device-tensor fits, TuRF and chi2
# ---------------------------------------------------------------------------

def quantized(X, cols):
    """X with ``cols`` cut into 3 states at -0.5 and 0.5 (0..2), so that
    an informative column stays informative when it turns discrete."""
    X = X.copy()
    X[:, cols] = np.digitize(X[:, cols], [-0.5, 0.5])
    return X


def hybrid_phase(dev, label, X, y, n_select=10, warm=0):
    """A mixed MultiSURF fit on the card (then ``warm`` more, timed): it
    must take the hybrid engine (continuous kernels and int8 GEMMs, no
    MIXED launch), and is held against the fused engine with the MIXED
    kernels on the same rows in the hybrid's order (class-sorted on the
    square v2 path).  Returns the fitted estimator, the first fit's
    seconds and the reference's kernel launches."""
    n, p = X.shape
    est = MultiSURF(n_features_to_select=n_select)
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    fa = analyze_features(torch.tensor(X, dtype=torch.float32, device=dev),
                          est.discrete_limit)
    disc = fa.is_discrete.cpu().numpy()
    n_states = fa.n_states
    route = relief_engine(n, disc, n_states)
    check(route == "hybrid", f"{label}: route {route}")
    plan = rh.hybrid_plan(n, int((~disc).sum()), int(disc.sum()),
                          n_states, dev, kw["algo"])
    square = plan.nb == plan.n_pad
    sorted_rows = square and rd._v2_layout(
        y_enc, n, 8, kw["algo"], kw.get("class_probs")) is not None
    before = dict(rc.launches)
    rd.reset_gemm_ops()
    est, fit_s, peak_gb = timed_fit(dev, est, X, y)
    ops = rd.gemm_ops
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    warm_s = [timed_fit(dev, est, X, y)[1] for _ in range(warm)]
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(moved["relief_pass1_cont"] > 0 and moved["relief_pass2_cont"] > 0,
          f"{label}: continuous kernels launched {moved}")
    check(moved["relief_pass1_mixed"] == 0
          and moved["relief_pass2_mixed"] == 0,
          f"{label}: no MIXED launch {moved}")
    check(ops > 0, f"{label}: no int8 GEMM ran")
    check(np.array_equal(est.is_discrete_, disc), f"{label}: is_discrete_")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")

    order = (np.argsort(y_enc, kind="stable") if sorted_rows
             else np.arange(n))
    ref, ref_s, ref_moved = fused_mixed_scores(
        dev, X, y_enc, kw, order, fa.recip, fa.is_discrete)
    del fa
    ref_top = np.argsort(ref)[::-1][:n_select]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_mixed"] > 0
          and ref_moved["relief_pass2_mixed"] > 0,
          f"{label}: reference launched the MIXED kernels")
    check(err <= fit_tol(ref), f"{label}: max |scores - MIXED engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    path = ("square, class-sorted rows" if sorted_rows else "square"
            if square else f"blocked, {plan.n_pad // plan.nb} focal blocks")
    print(f"{label}: MultiSURF X {n}x{p} ({int(disc.sum())} discrete, "
          f"{n_states} states) hybrid {path}; plan n_pad "
          f"{plan.n_pad} p_c_pad {plan.p_c_pad} p_d_pad {plan.p_d_pad} ftd "
          f"{plan.ftd} nb {plan.nb}; fit {fit_s:.4f} s"
          f"{''.join(f', warm {t:.4f} s' for t in warm_s)}; gemm_ops "
          f"{ops:.4e}; launches {moved}; peak {peak_gb:.2f} GB; "
          f"MIXED-kernel fused engine {ref_s:.4f} s; max |scores - MIXED| "
          f"{err:.3e}; top_features_ {est.top_features_.tolist()} equal",
          flush=True)
    return est, fit_s, ref_moved


def mixed_xl_phase(dev, X, y, warm=1):
    """MultiSURF on mixed data past ``HYBRID_MAX_N`` samples: it must take
    the fused engine (the MIXED kernels, over focal blocks; no continuous
    launch), and is held against the hybrid engine called directly on the
    same rows (its blocked path takes any n: the continuous kernels and
    the int8 GEMMs).  Returns the first fit's seconds, the warm fits'
    seconds and the referee's kernel launches."""
    n, p = X.shape
    label = "mixed-xl"
    y_enc = np.unique(y, return_inverse=True)[1]
    x_dev = torch.from_numpy(X).to(dev)
    fa = analyze_features(x_dev, MultiSURF().discrete_limit)
    disc = fa.is_discrete.cpu().numpy()
    n_states = fa.n_states
    route = relief_engine(n, disc, n_states)
    check(route == "fused", f"{label}: route {route}")
    plan = rc.block_plan(n, p, dev, n_disc=int(disc.sum()))
    before = dict(rc.launches)
    est, fit_s, peak_gb = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                    X, y)
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    warm_s = [timed_fit(dev, MultiSURF(n_features_to_select=10), X, y)[1]
              for _ in range(warm)]
    s = est.feature_importances_
    blocks = plan.n_pad // plan.nb
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(moved["relief_pass1_mixed"] == blocks
          and moved["relief_pass2_mixed"] == blocks
          and moved["relief_pass1_cont"] == moved["relief_pass2_cont"] == 0,
          f"{label}: one MIXED launch of each pass a focal block, no "
          f"continuous launch: {moved}")
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          f"{label}: exactly the 40 cut columns are discrete")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")

    before = dict(rc.launches)
    rd.reset_gemm_ops()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rh.relief_hybrid_scores(x_dev, y_enc, fa.recip, fa.is_discrete,
                                  algo="multisurf", codes=fa.codes,
                                  n_states=n_states)
    ref_s = time.perf_counter() - t0
    ref_moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    ops = rd.gemm_ops
    del x_dev, fa
    torch.cuda.empty_cache()
    ref_top = np.argsort(ref)[::-1][:10]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_cont"] > 0 and ops > 0
          and ref_moved["relief_pass1_mixed"] == 0,
          f"{label}: the hybrid referee ran its continuous kernels and "
          f"GEMMs ({ops} ops, launches {ref_moved})")
    check(err <= fit_tol(ref), f"{label}: max |scores - hybrid engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    print(f"{label}: MultiSURF X {n}x{p} ({int(disc.sum())} discrete, "
          f"{n_states} states) route fused; plan n_pad "
          f"{plan.n_pad} p_pad {plan.p_pad} nb {plan.nb} ({blocks} focal "
          f"blocks); fit {fit_s:.4f} s"
          f"{''.join(f', warm {t:.4f} s' for t in warm_s)}; peak "
          f"{peak_gb:.2f} GB; launches {moved}; hybrid engine (referee) "
          f"{ref_s:.4f} s, launches {ref_moved}; max |scores - hybrid| "
          f"{err:.3e}; top_features_ {est.top_features_.tolist()} equal",
          flush=True)
    return fit_s, warm_s, ref_moved


def device_fit_phase(dev, label, X, y, host_est, host_s):
    """``fit`` on X already on the card as a tensor: the host-array fit's
    model, with no host copy of X.  Returns the fit's seconds."""
    Xt = torch.from_numpy(X).to(dev)
    before = dict(rc.launches)
    est, fit_s, peak_gb = timed_fit(
        dev, MultiSURF(n_features_to_select=len(host_est.top_features_)),
        Xt, y)
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    err = float(np.abs(est.feature_importances_
                       - host_est.feature_importances_).max())
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(err <= DEVICE_FIT_ATOL, f"{label}: max |tensor - array fit| {err}")
    check(np.array_equal(est.top_features_, host_est.top_features_),
          f"{label}: top_features_")
    del Xt
    torch.cuda.empty_cache()
    print(f"{label}: MultiSURF on a tensor ({X.dtype}) {X.shape[0]}x"
          f"{X.shape[1]} on the card: fit {fit_s:.4f} s (host-array fit "
          f"{host_s:.4f} s); peak {peak_gb:.2f} GB; launches {moved}; max "
          f"|tensor fit - array fit| {err:.3e}; top_features_ equal",
          flush=True)
    return fit_s


class RefitTuRF(TuRF):
    """TuRF without its fast scorers: the base estimator re-fits on the
    active columns every round, as the reference's loop does."""

    def _make_fast_scorer(self, base, X, y):
        return None


def turf_phase(dev, label, X, y, kind):
    """TuRF(MultiSURF()) with its device-resident fast scorer against the
    re-fitting loop on the card: one copy of X to the card (counted where
    the fits copy it, over the whole TuRF fit), the same selection.  Each
    runs twice, alternating, so that neither alone pays the process's
    first allocations at this shape."""
    kw = dict(n_features_to_select=10, pct_remove=0.5)
    fast_s, slow_s = [], []
    for _ in range(2):
        _relief_base.reset_upload_count()
        rd.reset_gemm_ops()
        before = dict(rc.launches)
        fast, sec, peak_gb = timed_fit(dev, TuRF(MultiSURF(), **kw), X, y)
        fast_s.append(sec)
        uploads, ops = _relief_base.uploads, rd.gemm_ops
        moved = {k: rc.launches[k] - before[k] for k in rc.launches}
        _relief_base.reset_upload_count()
        slow, sec, _ = timed_fit(dev, RefitTuRF(MultiSURF(), **kw), X, y)
        slow_s.append(sec)
        slow_uploads = _relief_base.uploads
    err = float(np.abs(fast.feature_importances_
                       - slow.feature_importances_).max())
    final = float(np.abs(fast._final_scores_ - slow._final_scores_).max())
    rounds = fast._iteration_ + 1
    check(uploads == 1, f"{label}: X went to the card {uploads} times")
    check(slow_uploads == slow._iteration_ + 1,
          f"{label}: the re-fitting loop copied X {slow_uploads} times")
    mixed_moved = moved["relief_pass1_mixed"] + moved["relief_pass2_mixed"]
    if kind == "discrete":
        check(ops > 0 and not any(moved.values()),
              f"{label}: discrete engine ({ops} ops, launches {moved})")
    elif kind == "continuous":
        check(moved["relief_pass1_cont"] >= rounds
              and moved["relief_pass2_cont"] >= rounds and ops == 0,
              f"{label}: continuous kernels each round {moved}")
    else:
        check(ops > 0 and moved["relief_pass1_cont"] > 0
              and moved["relief_pass2_cont"] > 0 and mixed_moved == 0,
              f"{label}: hybrid engine ({ops} ops, launches {moved})")
    check(rounds == slow._iteration_ + 1, f"{label}: rounds")
    check(err <= TURF_ATOL and final <= TURF_ATOL,
          f"{label}: max |fast - refit| importances {err}, last round "
          f"{final}")
    check(np.array_equal(fast.top_features_, slow.top_features_),
          f"{label}: top_features_ {fast.top_features_} vs "
          f"{slow.top_features_}")
    print(f"{label}: TuRF(MultiSURF(), n_features_to_select=10, "
          f"pct_remove=0.5) X {X.shape[0]}x{X.shape[1]} {X.dtype}: "
          f"{rounds} rounds; fast scorer {fast_s[0]:.4f}, then "
          f"{fast_s[1]:.4f} s (X copied to the card {uploads} time, peak "
          f"{peak_gb:.2f} GB), re-fitting loop {slow_s[0]:.4f}, then "
          f"{slow_s[1]:.4f} s (X copied {slow_uploads} times); max "
          f"|importances fast - refit| {err:.3e}, last round {final:.3e}; "
          f"top_features_ {fast.top_features_.tolist()} equal", flush=True)


def chi2_phase(dev, n=2000, p=200000, c=5):
    """chi2 on a float32 tensor of counts on the card (by default the
    upstream benchmark's 2,000 x 200,000, counts 0..4, 5 classes) against
    the float64 host path."""
    gen = torch.Generator(device=dev).manual_seed(0)
    Xt = torch.randint(0, 5, (n, p), generator=gen, device=dev,
                       dtype=torch.float32)
    y = np.random.RandomState(0).randint(0, c, n)
    stats, pv = chi2(Xt, y)                       # first call
    dev_ms = cuda_ms(lambda: chi2(Xt, y), 3)
    X = Xt.cpu().numpy()
    del Xt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = chi2_stats_exact(X, y, c)
    host_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(stats - want) / np.maximum(np.abs(want),
                                                         1e-300)))
    check(stats.shape == (p,) and np.isfinite(stats).all()
          and np.isfinite(pv).all(), "chi2: finite statistics")
    check(np.allclose(stats, want, rtol=CHI2_RTOL, atol=0),
          f"chi2: max relative difference {rel}")
    print(f"chi2: float32 tensor {n}x{p} counts, {c} classes on the card: "
          f"{dev_ms:.4f} ms a call (host array in float64: "
          f"{host_s * 1e3:.4f} ms); max relative difference to the float64 "
          f"host path {rel:.3e}", flush=True)
    return dev_ms, host_s


# ---------------------------------------------------------------------------
# The kernels alone
# ---------------------------------------------------------------------------

def ptxas_usage():
    """Kernel name -> [(function, registers, spill bytes)] from ptxas."""
    out = {name: [] for name in KERNELS}
    for mangled, regs, spill in _build.ptxas_report():
        for name, fns in KERNEL_FUNCTIONS.items():
            fn = next((f for f in fns if f in mangled), None)
            if fn is not None:
                out[name].append((fn.replace("ILb0", "<false>").replace(
                    "ILb1", "<true>"), regs, spill))
    return out


def held(pass2, out, ref, where):
    """(max |out - ref|, the same over max |ref|) of a kernel's output
    against its plain version's, checked: pass 1 bit for bit, pass 2
    within SCORE_RTOL of max |ref|."""
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if pass2:
        check(rel <= SCORE_RTOL, f"pass2 {where}: relative err {rel}")
    else:
        check(err == 0, f"pass1 {where}: |D| err {err}")
    return err, rel


def kernel_checks(dev):
    """Each kernel against its plain version on the card: max |error| by
    kernel.  Pass 1 of either kind must equal its plain version bit for
    bit (the feature ranges of ``pass1_splits`` included), and every pass
    2 must be within SCORE_RTOL of its plain version and give the same
    bits over two launches.  The MIXED cases lead with their discrete
    columns (the engine's layout; pass 2 then plans per run), but for one
    whose 4-column steps mix kinds (ragged: 14 discrete columns) and one
    with every third column discrete (interleaved)."""
    err = {k: 0.0 for k in KERNELS}
    # (tag, label, n, p, nb, first row, discrete columns, their stride)
    cases = [(tag, label, 1000, 300, nb, off, 60 if tag == "mixed" else 0, 1)
             for tag in ("cont", "mixed")
             for label, nb, off in (("square", 1000, 0),
                                    ("rectangular", 777, 100))]
    cases += [("cont", "ragged", 1004, 44, 333, 7, 0, 1),
              ("cont", "large-p", 128, 100000, 128, 0, 0, 1),
              ("mixed", "ragged", 1004, 44, 333, 7, 14, 1),
              ("mixed", "large-p", 128, 100000, 128, 0, 30000, 1),
              ("mixed", "interleaved", 1000, 300, 777, 100, 100, 3),
              ("mixed", "all-discrete", 1000, 300, 1000, 0, 300, 1)]
    for tag, label, n, p, nb, off, n_disc, stride in cases:
        mixed = tag == "mixed"
        xp, recip, disc = random_inputs(dev, n, p, n_disc, seed=1,
                                        stride=stride)
        run = n_disc if stride == 1 and n_disc % 4 == 0 else 0
        xi = xp if nb == n else xp[off:off + nb].contiguous()
        k1, k2 = f"relief_pass1_{tag}", f"relief_pass2_{tag}"
        before = dict(rc.launches)
        D = rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed)
        D_ref = rc.dist_matrix_ref(xp, recip, disc, xi=xi, mixed=mixed)
        W = torch.rand(nb, n, device=dev) - 0.5
        s = rc.accumulate(xp, W, recip, disc, xi=xi, mixed=mixed, n_disc=run)
        s_again = rc.accumulate(xp, W, recip, disc, xi=xi, mixed=mixed,
                                n_disc=run)
        s_ref = rc.accumulate_ref(xp, W, recip, disc, xi=xi, mixed=mixed)
        where = (f"{tag} {label} xi {nb}x{p} vs xp {n}x{p}"
                 + (f", {n_disc} discrete" if mixed else ""))
        d_err, _ = held(False, D, D_ref, where)
        s_err, s_rel = held(True, s, s_ref, where)
        err[k1] = max(err[k1], d_err)
        err[k2] = max(err[k2], s_err)
        check(torch.equal(s, s_again), f"pass2 {where}: two launches differ")
        check(rc.launches[k1] == before[k1] + 1, f"{k1} counter")
        check(rc.launches[k2] == before[k2] + 2, f"{k2} counter")
        ranges = len(rc.pass1_splits(nb, n, p))
        print(f"kernels {where} ({ranges} feature ranges): max |D - ref| "
              f"{d_err:.3e}, max |s - ref| {s_err:.3e} (relative "
              f"{s_rel:.3e}), pass 2 equal over two launches", flush=True)
        del xp, xi, D, D_ref, W
        torch.cuda.empty_cache()
    return err


def kernel_bound(pass2, nb, n, p):
    """(ms, "operations" or "bytes"): the least time of one launch on an
    H100 at 700 W.  3 FP32 operations a pair-feature (subtract, scale or
    weight, add); each input read once and each output written once."""
    ops_ms = 3 * nb * n * p / FP32_PEAK_FLOPS * 1e3
    nbytes = 4 * ((nb + n) * p + 2 * p + nb * n + (p if pass2 else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def timed_shapes(dev):
    """The shapes at which the kernels are timed, the main path's first
    (from ``block_plan``): (tag, label, nb, n, p, discrete columns, time
    the plain version).  ``tools/kernel_ab.py`` times the same."""
    ln = rc.block_plan(50000, 100, dev)
    lp = rc.block_plan(100, 100000, dev)
    mx = rc.block_plan(2000, 200, dev, n_disc=40)
    xl = rc.block_plan(150000, 100, dev, n_disc=40)
    return [
        ("cont", "large-n", ln.nb, ln.n_pad, ln.p_pad, 0, True),
        ("cont", "large-n, features padded to 32", ln.nb, ln.n_pad, 128,
         0, False),
        ("cont", "large-p", lp.nb, lp.n_pad, lp.p_pad, 0, True),
        ("cont", "mixed-square continuous half", 16384, 16384, 2048, 0,
         False),
        ("mixed", "mixed-xl focal block", xl.nb, xl.n_pad, xl.p_pad, 40,
         True),
        ("mixed", "mixed-fused", mx.nb, mx.n_pad, mx.p_pad, 40, True),
        ("mixed", "mixed-fused, features padded to 32", mx.nb, mx.n_pad,
         224, 40, True),
        ("mixed", "all-discrete", 4096, 4096, 16384, 16384, False),
    ]


def kernel_timing(dev, err):
    """Kernel name -> one row per timed shape, the main path's first: the
    kernel's time (CUDA events, mean of 10 launches), its bound, its plain
    version's time (where nb * n * p < 1e10 for the MIXED kernels) and,
    for pass 1, that of the one PyTorch call that computes the same D (the
    port never calls it): ``torch.cdist(xi * recip, xp * recip, p=1)``
    on continuous data, ``torch.cdist(xi, xp, p=0)`` at the all-discrete
    shape.  Where the plain version runs, the kernel's output is held
    against it as in ``kernel_checks`` and ``err`` takes its error."""
    timing = {k: [] for k in KERNELS}
    for tag, label, nb, n, p, n_disc, plain in timed_shapes(dev):
        mixed = tag == "mixed"
        xp, recip, disc = random_inputs(dev, n, p, n_disc, seed=2)
        xi = xp[:nb]
        W = torch.rand(nb, n, device=dev) - 0.5
        ref_reps = 2 if nb * n * p >= 10 ** 9 else 5
        runs = {
            "relief_pass1": (
                lambda: rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed),
                lambda: rc.dist_matrix_ref(xp, recip, disc, xi=xi,
                                           mixed=mixed)),
            "relief_pass2": (
                lambda: rc.accumulate(xp, W, recip, disc, xi=xi,
                                      mixed=mixed, n_disc=n_disc),
                lambda: rc.accumulate_ref(xp, W, recip, disc, xi=xi,
                                          mixed=mixed)),
        }
        for kname, (kernel, ref) in runs.items():
            key = f"{kname}_{tag}"
            library_ms = lib_name = None
            if key == "relief_pass1_cont":
                xs, ps = xi * recip, xp * recip
                library_ms = cuda_ms(lambda: torch.cdist(xs, ps, p=1), 3)
                lib_name = "torch.cdist(p=1)"
                del xs, ps
                torch.cuda.empty_cache()
            elif key == "relief_pass1_mixed" and n_disc == p:
                library_ms = cuda_ms(lambda: torch.cdist(xi, xp, p=0), 1)
                lib_name = "torch.cdist(p=0)"
                torch.cuda.empty_cache()
            pass2 = kname == "relief_pass2"
            shape = (f"xi {nb}x{p} vs xp {n}x{p}"
                     + (f", {n_disc} discrete" if mixed else ""))
            ms = cuda_ms(kernel, 10)
            plain_ms = max_err = None
            if plain:
                plain_ms = cuda_ms(ref, ref_reps)
                out, want = kernel(), ref()
                max_err, rel = held(pass2, out, want, f"{key} at {label}")
                err[key] = max(err[key], max_err)
                del out, want
            bound_ms, bound_by = kernel_bound(pass2, nb, n, p)
            timing[key].append(dict(
                shape=f"{label}: {shape}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, library_ms=library_ms,
                max_abs_err=max_err))
            lib = ("" if library_ms is None
                   else f", {lib_name} {library_ms:.4f} ms")
            ref_s = ("" if plain_ms is None else
                     f", plain {plain_ms:.4f} ms (max |err| {max_err:.3e}, "
                     f"relative {rel:.3e})")
            print(f"time {key} at {label} ({shape}): kernel {ms:.4f} ms"
                  f"{ref_s}, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it{lib}", flush=True)
        del xp, xi, W
        torch.cuda.empty_cache()
    return timing

# ---------------------------------------------------------------------------

def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    # plain references on the card run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = _build.find_nvcc()
    nvcc_ver = run([nvcc, "--version"]).splitlines()[-1]
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not importable"
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvcc {nvcc} ({nvcc_ver}); "
          f"triton {triton_ver}; TF32 matmul/cudnn off", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    ptxas = ptxas_usage()
    for name, rows in ptxas.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{fn} {regs} registers, {spill} B spilled"
            for fn, regs, spill in rows), flush=True)

    # 3. kernels against their plain versions, then timed
    err = kernel_checks(dev)
    timing = kernel_timing(dev, err)

    # 4-6. the main path
    rc.reset_launch_counts()
    cont = ("relief_pass1_cont", "relief_pass2_cont")
    X_n, y_n = make_classification(n_samples=50000, n_features=100,
                                   n_informative=10, random_state=0)
    X_n = X_n.astype(np.float32)
    large_n, fit_n = fit_phase(dev, "large-n", X_n, y_n, cont, warm=2)
    X, y = make_classification(n_samples=100, n_features=100000,
                               random_state=0)
    _, fit_p = fit_phase(dev, "large-p", X.astype(np.float32), y, cont,
                         warm=3)
    X, y = make_classification(n_samples=2000, n_features=200,
                               n_informative=10, random_state=1)
    X = X.astype(np.float32)
    X[:, :40] = np.random.RandomState(3).randint(0, 3, (2000, 40))
    X[:, 0] = 2 * y              # a strongly relevant discrete column
    est, fit_m, ref_mixed = hybrid_phase(dev, "mixed", X, y)
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          "mixed: exactly the 40 integer columns are discrete")
    check(est.top_features_[0] == 0, "mixed: the planted column ranks first")
    X[:, 1] = np.arange(2000) % 150   # 150 states: past int8 state codes
    est, fit_mf = fit_phase(dev, "mixed-fused", X, y,
                            ("relief_pass1_mixed", "relief_pass2_mixed"),
                            discrete_limit=200)
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          "mixed-fused: the 40 integer columns are discrete")
    X, y = make_classification(n_samples=150000, n_features=100,
                               n_informative=10, random_state=9)
    X = quantized(X, np.arange(40)).astype(np.float32)
    fit_xl, warm_xl, ref_xl = mixed_xl_phase(dev, X, y)
    del X
    oracle_phase()
    # the mixed phase's reference ran the MIXED kernels and mixed-xl's the
    # continuous ones: not the main path
    main_launches = {k: rc.launches[k] - ref_mixed[k] - ref_xl[k]
                     for k in rc.launches}
    for name in KERNELS:
        check(main_launches[name] > 0, f"{name} launched on the main path")

    # 7. the SNP headline on the all-discrete engine
    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    X = rs.randint(0, 3, (16384, 65536), dtype=np.int8)
    y = rs.randint(0, 2, 16384)
    X[:, 0] = 2 * y
    print(f"headline data: {time.perf_counter() - t0:.2f} s", flush=True)
    head = discrete_phase(dev, "snp-headline",
                          MultiSURF(n_features_to_select=10), X, y,
                          "v2-sym", warm=2)
    eng_s, eng_ops = engine_rate(dev, X, y)
    rate = eng_ops / eng_s / 1e12
    print(f"snp-headline engine alone (codes on the card): {eng_s:.4f} s, "
          f"{eng_ops:.4e} int8 ops, {rate:.1f} TOP/s = "
          f"{100 * rate / INT8_PEAK_TOPS:.2f}% of {INT8_PEAK_TOPS:.0f} "
          f"TOP/s; end to end (first fit) "
          f"{head['gemm_ops'] / head['first_s'] / 1e12:.1f} TOP/s", flush=True)
    head_est = MultiSURF(n_features_to_select=10)
    head_est.feature_importances_ = head["scores"]
    head_est.top_features_ = np.argsort(head["scores"])[::-1][:10]
    dev_int8_s = device_fit_phase(dev, "device-fit int8", X, y, head_est,
                                  min(head["warm_s"]))
    del X

    # 8. the other tiers
    X, y = planted_genotypes(1, 3000, 5000, 3)
    discrete_phase(dev, "tier-v1",
                   ReliefF(n_features_to_select=3, n_neighbors=5),
                   X, y, "v1")
    X, y = planted_genotypes(2, 30000, 2048, 2)
    discrete_phase(dev, "tier-v2",
                   MultiSURF(n_features_to_select=3, use_star=True),
                   X, y, "v2")
    X, y = planted_genotypes(3, 8192, 16384, 2)
    discrete_phase(dev, "tier-v2-sym", SURF(n_features_to_select=3),
                   X.astype(np.float64), y, "v2-sym")
    del X

    # 9. SURF and ReliefF on continuous data
    rc.reset_launch_counts()
    X, y = make_classification(n_samples=10000, n_features=100,
                               n_informative=10, random_state=4)
    for make, params in ((SURF, {}), (SURF, {"use_star": True}),
                         (ReliefF, {"n_neighbors": 10})):
        fit_phase(dev, "continuous", X.astype(np.float32), y, cont,
                  make=make, **params)
    X, y = make_classification(n_samples=50000, n_features=100,
                               n_informative=10, random_state=0)
    fit_phase(dev, "large-n", X.astype(np.float32), y, cont, make=ReliefF,
              n_neighbors=10)
    oracle_phase_surf_relieff()
    for name in cont:
        check(rc.launches[name] > 0, f"{name} launched by SURF/ReliefF")

    # 10. the hybrid engine at size
    X, y = make_classification(n_samples=16384, n_features=2048,
                               n_informative=16, random_state=5)
    X = np.hstack([np.random.RandomState(6).randint(0, 3, (16384, 2048)),
                   X]).astype(np.float32)
    X[:, 0] = 2 * y
    _, fit_sq, _ = hybrid_phase(dev, "mixed-square", X, y, warm=1)
    del X
    _, fit_ln, _ = hybrid_phase(dev, "mixed-large-n",
                                quantized(X_n, np.arange(40)), y_n)

    # 11. a float32 tensor fit against the host-array fit, both warm
    large_n, host_n = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                X_n, y_n)[:2]
    dev_n_s = device_fit_phase(dev, "device-fit float32", X_n, y_n,
                               large_n, host_n)

    # 12. TuRF's fast scorers
    X, y = planted_genotypes(7, 4096, 16384, 2)
    turf_phase(dev, "turf-discrete", X, y, "discrete")
    X, y = make_classification(n_samples=10000, n_features=1000,
                               n_informative=10, random_state=8)
    turf_phase(dev, "turf-continuous", X.astype(np.float32), y,
               "continuous")
    turf_phase(dev, "turf-mixed", quantized(X, np.arange(100)).astype(
        np.float32), y, "mixed")
    del X

    # 13. chi2
    chi2_ms, chi2_host_s = chi2_phase(dev)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name], "max_abs_err": err[name],
         **{k: timing[name][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shape": timing[name][0]["shape"], "shapes": timing[name],
         "registers": [regs for _, regs, _ in ptxas[name]],
         "spill_bytes": [spill for _, _, spill in ptxas[name]]}
        for name, (src, rep) in KERNELS.items()]}
    print(f"fits: large-n {fit_n:.4f} s, large-p {fit_p:.4f} s, mixed "
          f"{fit_m:.4f} s, mixed-fused {fit_mf:.4f} s, mixed-xl "
          f"{fit_xl:.4f} s (warm {', '.join(f'{t:.4f}' for t in warm_xl)} "
          f"s), mixed-square "
          f"{fit_sq:.4f} s, mixed-large-n {fit_ln:.4f} s; snp-headline first "
          f"{head['first_s']:.4f} s, warm "
          f"{', '.join(f'{t:.4f}' for t in head['warm_s'])} s (MIXED route "
          f"{head['mixed_s']:.4f} s); tensor fits int8 {dev_int8_s:.4f} s, "
          f"float32 {dev_n_s:.4f} s (host array {host_n:.4f} s); chi2 "
          f"{chi2_ms:.4f} ms (host {chi2_host_s * 1e3:.4f} ms) on {smi}; "
          f"chip_smoke {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
