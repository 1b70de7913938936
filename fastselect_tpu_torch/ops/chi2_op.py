"""Chi-squared statistics from one one-hot contingency product.

Counterpart of ``fastselect_tpu/ops/chi2_op.py``.  The reference builds the
class-by-feature "observed" counts with a sample loop (``Chi2.py:7-22``)
and the statistic with a feature loop (``Chi2.py:24-47``); here

    observed = onehot(y).T @ X        # (n_classes, n_features)

is one float32 product (the JAX package leaves it to XLA's
``dot_general``, so it stays a library GEMM), and the statistic a small
reduction over classes, taken in float64 on the device: integer counts sum
exactly in float32 below 2^24, so for them the statistic is the float64
host path's.  (The JAX package takes it in float32, whose rounding of
``expected`` moves a statistic near 0 by far more than 1e-4 of itself.)
As in the reference, a feature whose total count is zero scores 0.0
(scikit-learn gives NaN), and expected counts of at most 1e-12 are
skipped.
"""

from __future__ import annotations

import numpy as np
import torch


def chi2_stats(x: torch.Tensor, y_mapped, n_classes: int) -> np.ndarray:
    """Chi2 statistics (float64 numpy) of ``x`` on its own device; y_mapped
    holds class codes 0..n_classes-1.  The product runs in float32 with
    TF32 off, whatever the process's setting."""
    return chi2_device(x, y_mapped, n_classes).cpu().numpy()


def chi2_device(x: torch.Tensor, y_mapped, n_classes: int) -> torch.Tensor:
    """:func:`chi2_stats` as a float64 tensor on x's device."""
    x = x.to(torch.float32)
    y = torch.as_tensor(np.asarray(y_mapped, np.int64), device=x.device)
    onehot = torch.nn.functional.one_hot(y, n_classes).to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        observed = (onehot.t() @ x).to(torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    class_freqs = onehot.sum(dim=0, dtype=torch.float64)
    feature_counts = observed.sum(dim=0)
    expected = class_freqs[:, None] * (feature_counts[None, :] / x.shape[0])
    resid = observed - expected
    pos = expected > 1e-12
    term = torch.where(pos, resid * resid / torch.where(pos, expected, 1.0),
                       0.0)
    return torch.where(feature_counts == 0, 0.0, term.sum(dim=0))


def chi2_stats_exact(x: np.ndarray, y_mapped: np.ndarray,
                     n_classes: int) -> np.ndarray:
    """Float64 host statistics: the parity oracle and the CPU backend."""
    n_samples = x.shape[0]
    x64 = np.asarray(x, dtype=np.float64)
    # observed = onehot(y).T @ X as one float64 BLAS product
    indicator = np.zeros((n_classes, n_samples), dtype=np.float64)
    indicator[y_mapped, np.arange(n_samples)] = 1.0
    observed = indicator @ x64
    feature_counts = observed.sum(axis=0)
    class_freqs = np.bincount(y_mapped, minlength=n_classes).astype(
        np.float64)
    expected = class_freqs[:, None] * feature_counts[None, :] / n_samples
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(expected > 1e-12,
                        (observed - expected) ** 2 / expected, 0.0)
    stats = term.sum(axis=0)
    stats[feature_counts == 0] = 0.0
    return stats
