#!/usr/bin/env python
"""Drop-in scikit-learn pipeline on the PyTorch port: the twin of
``examples/sklearn_pipeline.py`` (reference README.md:94-103 shows the
same pattern with fast_select).

Run: ``python examples/torch/sklearn_pipeline.py [--backend cuda|cpu]``.
The backend defaults to ``cuda``, which raises ``RuntimeError`` on a
host without a CUDA device.  Needs scikit-learn for the pipeline, the
classifier and the cross-validation.
"""

from __future__ import annotations

import sys
from pathlib import Path

# run from a checkout without installing
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse  # noqa: E402

import numpy as np  # noqa: E402
from sklearn.datasets import make_classification  # noqa: E402
from sklearn.linear_model import LogisticRegression  # noqa: E402
from sklearn.model_selection import cross_val_score  # noqa: E402
from sklearn.pipeline import Pipeline  # noqa: E402

from fastselect_tpu_torch import MultiSURF  # noqa: E402


def main(backend: str = "cuda") -> None:
    X, y = make_classification(n_samples=600, n_features=300,
                               n_informative=12, random_state=0)
    pipe = Pipeline([
        ("select", MultiSURF(n_features_to_select=24, backend=backend)),
        ("clf", LogisticRegression(max_iter=2000)),
    ])
    scores = cross_val_score(pipe, X, y, cv=3)
    print("cv accuracy:", np.round(scores, 3), "mean",
          round(float(scores.mean()), 3))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cpu"))
    main(ap.parse_args().backend)
