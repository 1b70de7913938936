"""Functional chi2 selector (reference ``Chi2.py:49-92``).

Counterpart of ``fastselect_tpu/models/chi2.py``: scikit-learn-style
chi-squared scores between each non-negative feature and the class labels,
with the reference's deliberate divergences kept: a zero-count feature
scores 0.0 (scikit-learn gives NaN), and a single-class y returns
``(zeros, ones)``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import chi2 as chi2_dist

from ..ops.chi2_op import chi2_stats, chi2_stats_exact
from ..utils.backend import default_device, resolve_backend, tensor_backend
from ..utils.logging import fit_span
from ..utils.sklearn_compat import check_X_y


def _result(stats, n_classes):
    return stats, chi2_dist.sf(stats, n_classes - 1)


def _single_class(n_features):
    return (np.zeros(n_features, dtype=np.float64),
            np.ones(n_features, dtype=np.float64))


def _check_tensor(X, y):
    """Shape, sign and finiteness of a tensor X on its device (two
    scalars come back), and y as a host array."""
    if X.dim() != 2:
        raise ValueError("X must be 2-dimensional.")
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    if y.ndim != 1 or y.shape[0] != X.shape[0]:
        raise ValueError(f"X and y have inconsistent lengths: {X.shape[0]} "
                         f"vs {y.shape[0]}.")
    if X.is_floating_point() and not bool(torch.isfinite(X).all()):
        raise ValueError("Input X contains NaN or infinity.")
    if X.numel() and float(X.min()) < 0:
        raise ValueError("Input matrix X must contain non-negative values.")
    return y


@fit_span
def chi2(X, y, *, backend: str = "auto",
         exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Chi-squared statistics and p-values for each feature.

    Parameters
    ----------
    X : array-like or torch.Tensor of shape (n_samples, n_features)
        Non-negative count-like feature values.  A tensor is checked and
        scored on its own device (float32 product), with no host copy,
        unless ``exact`` is set; a ``backend`` other than ``'auto'`` must
        then name that device.
    y : array-like of shape (n_samples,)
        Class labels.
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Where a host X is scored.  'auto' and 'cpu' use the float64 host
        path: for a host X its copy to the card costs more than the whole
        host computation.  'cuda' ('gpu') uploads X and runs the float32
        product on the card, and raises RuntimeError without one.
    exact : bool, default=False
        Use the float64 host path for any X.

    Returns
    -------
    (chi2_stats, p_values) : tuple of ndarray of shape (n_features,)
    """
    if isinstance(X, torch.Tensor) and not exact:
        tensor_backend(backend, X.device, "chi2")
        y = _check_tensor(X, y)
        labels, y_mapped = np.unique(y, return_inverse=True)
        if len(labels) < 2:
            return _single_class(X.shape[1])
        return _result(chi2_stats(X, y_mapped, len(labels)), len(labels))

    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    X, y = check_X_y(X, y, dtype=[np.float64, np.float32], y_numeric=True)
    if np.any(X < 0):
        raise ValueError("Input matrix X must contain non-negative values.")
    labels, y_mapped = np.unique(y, return_inverse=True)
    if len(labels) < 2:
        return _single_class(X.shape[1])

    effective = "cpu" if exact else resolve_backend(backend, "chi2")
    if effective == "cpu" or backend == "auto":
        # the CPU backend is the float64 oracle: the reference's suite pins
        # chi2 to scikit-learn at rtol 1e-6 and exact 0.0 for constant
        # features (tests/test_chi2.py), which float32 sums cannot promise
        stats = chi2_stats_exact(X, y_mapped, len(labels))
    else:
        x_dev = torch.as_tensor(X).to(default_device(effective),
                                      dtype=torch.float32)
        stats = chi2_stats(x_dev, y_mapped, len(labels))
    return _result(stats, len(labels))
