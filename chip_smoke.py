#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

Phases, one or two lines each on stdout:

1. environment: torch, CUDA, the card and its power limit, nvcc, triton;
2. build: ``nvcc`` compiles ``fastselect_tpu_torch/csrc/*.cu`` for sm_90a;
3. each kernel against its plain PyTorch version on the card, at ragged
   shapes (square and rectangular focal blocks), then both timed with CUDA
   events at the shapes the main path gives them;
4. ``MultiSURF().fit`` at the upstream reference's large-n point,
   50,000 samples x 100 continuous features;
5. the same at its large-p point, 100 samples x 100,000 features;
6. a small mixed fit (2,000 x 200 with 40 integer-valued columns), and
   MultiSURF and MultiSURF* on a 37 x 19 mixed input against the numpy
   oracle of the reference's semantics in ``tests/oracles.py``.

Phases 4-6 are the main path: every kernel launch count is set to 0 before
them and read after them, and each kernel must have been launched there.
Each fit is held against the same engine run on the card with the plain
PyTorch passes.  Any failed check raises, so the script exits non-zero; it
also fails when no CUDA device is present.  The line before the last is a
JSON summary of the kernels; the last line is
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

from fastselect_tpu_torch import MultiSURF, _build
from fastselect_tpu_torch.ops import relief_cuda as rc
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
D_ATOL = 1e-4        # pass 1 against its plain version (expected: 0)
SCORE_RTOL = 1e-3    # pass 2 against its plain version, relative to max|s|
FIT_ATOL = 1e-4      # fitted scores against the plain-pass engine
ORACLE_ATOL = 2e-6   # against tests/oracles.py, as tests/test_multisurf.py


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


def random_inputs(dev, n, p, n_disc, seed):
    """Padded-engine-like inputs: X (n, p) with n_disc integer-valued
    columns flagged discrete, and recip from the column ranges."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, p).astype(np.float32)
    x[:, :n_disc] = rng.randint(0, 3, (n, n_disc))
    disc = np.zeros(p, np.float32)
    disc[:n_disc] = 1.0
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-6)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(x), t(recip), t(disc)


def fit_phase(dev, label, X, y, must_launch, n_select=10):
    """Fit through the estimator, check that it launched the kernels named
    in must_launch, then hold it against the plain-pass engine on the
    card.  Returns the fitted estimator and the fit's seconds."""
    plan = rc.block_plan(X.shape[0], X.shape[1], dev)
    before = dict(rc.launches)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = MultiSURF(n_features_to_select=n_select).fit(X, y)
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    moved = {k: rc.launches[k] - before[k] for k in rc.launches}
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    for name in must_launch:
        check(moved[name] > 0, f"{label}: the fit launched {name}")
    check(s.shape == (X.shape[1],) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({X.shape[1]},)")

    x_dev = torch.tensor(X, dtype=torch.float32, device=dev)
    fa = analyze_features(x_dev, est.discrete_limit)
    y_enc = np.unique(y, return_inverse=True)[1]
    t0 = time.perf_counter()
    ref = rc.relief_fused_scores(
        x_dev, y_enc, fa.recip, fa.is_discrete, algo="multisurf",
        device=dev, _pass1=rc.dist_matrix_ref, _pass2=rc.accumulate_ref)
    ref_s = time.perf_counter() - t0
    ref_top = np.argsort(ref)[::-1][:n_select]
    err = float(np.abs(s - ref).max())
    check(err <= FIT_ATOL, f"{label}: max |scores - plain engine| = {err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    print(f"{label}: X {X.shape[0]}x{X.shape[1]} fit {fit_s:.4f} s "
          f"(plain-pass engine {ref_s:.4f} s); n_pad {plan.n_pad} p_pad "
          f"{plan.p_pad} nb {plan.nb} ({plan.n_pad // plan.nb} blocks); "
          f"peak {peak_gb:.2f} GB; launches {moved}; max |scores - plain| "
          f"{err:.3e}; top_features_ {est.top_features_.tolist()} equal",
          flush=True)
    return est, fit_s


def oracle_phase():
    """The estimator on the card against the numpy oracle of the
    reference's CPU semantics (tests/oracles.py), on the small mixed input
    of tests/test_multisurf.py::test_oracle_parity."""
    spec = importlib.util.spec_from_file_location(
        "oracles", Path(__file__).resolve().parent / "tests" / "oracles.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
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


# ---------------------------------------------------------------------------

def main():
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

    # 3. kernels against their plain versions
    err = {k: 0.0 for k in KERNELS}
    for mixed in (False, True):
        tag = "mixed" if mixed else "cont"
        xp, recip, disc = random_inputs(dev, 1000, 300,
                                        60 if mixed else 0, seed=1)
        for nb in (1000, 777):        # square, then a rectangular block
            xi = xp if nb == 1000 else xp[100:100 + nb].contiguous()
            before = dict(rc.launches)
            D = rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed)
            D_ref = rc.dist_matrix_ref(xp, recip, disc, xi=xi, mixed=mixed)
            W = torch.rand(nb, 1000, device=dev) - 0.5
            s = rc.accumulate(xp, W, recip, disc, xi=xi, mixed=mixed)
            s_ref = rc.accumulate_ref(xp, W, recip, disc, xi=xi, mixed=mixed)
            torch.cuda.synchronize()
            d_err = (D - D_ref).abs().max().item()
            s_err = (s - s_ref).abs().max().item()
            s_rel = s_err / s_ref.abs().max().item()
            err[f"relief_pass1_{tag}"] = max(err[f"relief_pass1_{tag}"],
                                             d_err)
            err[f"relief_pass2_{tag}"] = max(err[f"relief_pass2_{tag}"],
                                             s_err)
            check(d_err <= D_ATOL, f"pass1 {tag} nb={nb}: |D| err {d_err}")
            check(s_rel <= SCORE_RTOL,
                  f"pass2 {tag} nb={nb}: relative err {s_rel}")
            for k in (f"relief_pass1_{tag}", f"relief_pass2_{tag}"):
                check(rc.launches[k] == before[k] + 1, f"{k} counter")
            print(f"kernels {tag} xi {nb}x300 vs xp 1000x300: max |D - ref| "
                  f"{d_err:.3e}, max |s - ref| {s_err:.3e} "
                  f"(relative {s_rel:.3e})", flush=True)

    # timing at the shapes the main path gives each kernel
    timing = {}
    shapes = {"cont": [(50000, 100, 0), (100, 100000, 0)],
              "mixed": [(2000, 200, 40)]}
    for tag, cases in shapes.items():
        mixed = tag == "mixed"
        for n, p, n_disc in cases:
            plan = rc.block_plan(n, p, dev)
            xp, recip, disc = random_inputs(dev, plan.n_pad,
                                            plan.p_pad, n_disc, seed=2)
            xi = xp[:plan.nb]
            W = torch.rand(plan.nb, plan.n_pad, device=dev) - 0.5
            ref_reps = 2 if n * p >= 10 ** 6 else 5
            row = {
                "relief_pass1": (
                    cuda_ms(lambda: rc.dist_matrix(
                        xp, recip, disc, xi=xi, mixed=mixed), 10),
                    cuda_ms(lambda: rc.dist_matrix_ref(
                        xp, recip, disc, xi=xi, mixed=mixed), ref_reps)),
                "relief_pass2": (
                    cuda_ms(lambda: rc.accumulate(
                        xp, W, recip, disc, xi=xi, mixed=mixed), 10),
                    cuda_ms(lambda: rc.accumulate_ref(
                        xp, W, recip, disc, xi=xi, mixed=mixed), ref_reps)),
            }
            shape = f"xi {plan.nb}x{plan.p_pad} vs xp {plan.n_pad}x{plan.p_pad}"
            for kname, (ms, plain_ms) in row.items():
                key = f"{kname}_{tag}"
                timing.setdefault(key, (ms, plain_ms, shape))
                print(f"time {key} at {shape} (fit {n}x{p}): kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            del xp, xi, W
            torch.cuda.empty_cache()

    # 4-6. the main path
    rc.reset_launch_counts()
    cont = ("relief_pass1_cont", "relief_pass2_cont")
    X, y = make_classification(n_samples=50000, n_features=100,
                               n_informative=10, random_state=0)
    _, fit_n = fit_phase(dev, "large-n", X.astype(np.float32), y, cont)
    X, y = make_classification(n_samples=100, n_features=100000,
                               random_state=0)
    _, fit_p = fit_phase(dev, "large-p", X.astype(np.float32), y, cont)
    X, y = make_classification(n_samples=2000, n_features=200,
                               n_informative=10, random_state=1)
    X = X.astype(np.float32)
    X[:, :40] = np.random.RandomState(3).randint(0, 3, (2000, 40))
    X[:, 0] = 2 * y              # a strongly relevant discrete column
    est, fit_m = fit_phase(dev, "mixed", X, y,
                           ("relief_pass1_mixed", "relief_pass2_mixed"))
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          "mixed: exactly the 40 integer columns are discrete")
    check(est.top_features_[0] == 0, "mixed: the planted column ranks first")
    oracle_phase()
    main_launches = dict(rc.launches)
    for name in KERNELS:
        check(main_launches[name] > 0, f"{name} launched on the main path")

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name], "max_abs_err": err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "shape": timing[name][2]}
        for name, (src, rep) in KERNELS.items()]}
    print(f"fits: large-n {fit_n:.4f} s, large-p {fit_p:.4f} s, mixed "
          f"{fit_m:.4f} s on {smi}", flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
