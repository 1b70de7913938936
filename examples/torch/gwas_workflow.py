#!/usr/bin/env python
"""End-to-end GWAS-style feature-selection workflow on the PyTorch port.

The twin of ``examples/gwas_workflow.py`` through
:mod:`fastselect_tpu_torch`: MultiSURF over a synthetic SNP matrix with
a planted additive pair (columns 7 and 42), in three idioms that keep
the card fed:

* pass genotypes as small non-negative integers (``int8`` 0/1/2): the
  estimator skips the float cast and the encode sweep and stages 4x
  fewer bytes than float32;
* chain TuRF on top for iterative elimination with per-iteration
  checkpointing: a killed run resumes where it stopped;
* finish with mRMR on the surviving features.

Run: ``python examples/torch/gwas_workflow.py [--n 4096] [--p 8192]
[--backend cuda|cpu]``.  The backend defaults to ``cuda``, which raises
``RuntimeError`` on a host without a CUDA device; pass ``--backend cpu``
there.  Needs no scikit-learn.
"""

from __future__ import annotations

import sys
from pathlib import Path

# run from a checkout without installing
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402


def main(n: int, p: int, seed: int = 0, backend: str = "cuda") -> None:
    from fastselect_tpu_torch import MultiSURF, TuRF, mRMR

    rs = np.random.RandomState(seed)
    # synthetic genotypes with a planted additive pair
    X = rs.randint(0, 3, (n, p)).astype(np.int8)
    y = ((X[:, 7].astype(int) + X[:, 42].astype(int)
          + rs.randint(0, 2, n)) > 2).astype(np.int8)

    # checkpoint in a user-owned directory (a world-writable fixed path
    # would let another local user pre-place a pickle that resume would
    # unpickle)
    ckpt = f"{tempfile.mkdtemp(prefix='fastselect_turf_')}/gwas_turf.ckpt"

    t0 = time.perf_counter()
    scorer = MultiSURF(n_features_to_select=100, backend=backend)
    turf = TuRF(scorer, n_features_to_select=256, pct_remove=0.4,
                checkpoint_path=ckpt, verbose=True)
    turf.fit(X, y)
    print(f"TuRF elimination: {time.perf_counter() - t0:.1f}s, "
          f"kept {len(turf.top_features_)} features")

    X_small = X[:, turf.top_features_]
    t0 = time.perf_counter()
    sel = mRMR(n_features_to_select=16, backend=backend).fit(
        X_small.astype(np.int32), y)
    picked = turf.top_features_[sel.top_features_]
    print(f"mRMR refinement: {time.perf_counter() - t0:.1f}s")
    print("selected columns:", np.sort(picked)[:16])
    print("planted signals recovered:",
          {7, 42} <= set(picked.tolist()))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--p", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cpu"))
    a = ap.parse_args()
    main(a.n, a.p, a.seed, a.backend)
