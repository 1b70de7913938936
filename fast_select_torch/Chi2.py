"""Reference submodule path ``fast_select.Chi2``.

The two private helpers keep the reference's internal contracts
(``Chi2.py:7-47``), which its test-suite unit-tests directly
(``tests/test_chi2.py:160-236``): an observed class-by-feature count
matrix built by summing feature values per class, and the chi-squared
statistic with the zero-count and tiny-expected guards.  They are
vectorised NumPy in place of Numba loops; the estimator's path is
:mod:`fastselect_tpu_torch.ops.chi2_op`.
"""

import numpy as np

from fastselect_tpu_torch.models.chi2 import chi2

__all__ = ["chi2", "_compute_observed_and_feature_counts", "_chi2_core"]


def _compute_observed_and_feature_counts(X, y_mapped, n_features,
                                         n_classes):
    """Observed class-by-feature sums and per-feature totals."""
    X = np.asarray(X, dtype=np.float64)
    observed = np.zeros((n_classes, n_features), dtype=np.float64)
    np.add.at(observed, np.asarray(y_mapped), X)
    return observed, X.sum(axis=0)


def _chi2_core(observed, class_freqs, feature_counts, n_samples):
    """Chi-squared statistic per feature from the observed matrix.

    Features with zero total count score exactly 0.0 (the reference's
    deliberate divergence from sklearn's NaN); expected counts below
    1e-12 are skipped.
    """
    observed = np.asarray(observed, dtype=np.float64)
    class_freqs = np.asarray(class_freqs, dtype=np.float64)
    feature_counts = np.asarray(feature_counts, dtype=np.float64)
    expected = class_freqs[:, None] * feature_counts[None, :] / n_samples
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(expected > 1e-12,
                        (observed - expected) ** 2 / expected, 0.0)
    stats = term.sum(axis=0)
    stats[feature_counts == 0] = 0.0
    return stats
