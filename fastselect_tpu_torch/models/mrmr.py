"""mRMR selector (reference ``mRMR.py:30-152``).

Counterpart of ``fastselect_tpu/models/mrmr.py``.  Greedy
minimum-redundancy / maximum-relevance selection over discrete data.  X
and y are encoded against the UNION vocabulary of their unique values
(reference ``mRMR.py:90-92``) and staged on the fit's device once; the
relevance vector and the (p, p) redundancy matrix are int8 one-hot GEMMs
there (``ops/contingency.py``), and the matrix stays there while the tiny
greedy loop on the host reads the k columns it picks, with the
reference's tie-break (np.isclose atol=1e-12, then lowest accumulated
redundancy).
"""

from __future__ import annotations

import numpy as np

from ..ops.contingency import (StagedColumnStats, matrix_column,
                               stage_codes, staged_stat_matrix,
                               staged_target_tables, tables_stat)
from ..utils.backend import default_device, resolve_backend
from ..utils.logging import fit_span
from ..utils.sklearn_compat import (BaseEstimator, TransformerMixin,
                                    check_is_fitted, validate_data)

# Above this feature count the (p, p) redundancy matrix is not built; the
# greedy loop streams one redundancy COLUMN per selected feature against
# codes staged once (ops/contingency.StagedColumnStats), O(k * p) work and
# O(p) memory.
FULL_REDUNDANCY_MAX_P = 8192


def _encode_union(X: np.ndarray, y: np.ndarray):
    """Integer-encode X and y against their combined sorted vocabulary
    (reference ``mRMR.py:9-27,90-92``).

    Small-non-negative-integer data (the common genotype/categorical
    case) takes an O(n*p) bincount path: identical codes to the sorted
    vocabulary, without the O(n*p log(n*p)) ``np.unique`` sort that
    dominates at GWAS p."""
    if (np.issubdtype(X.dtype, np.integer)
            and np.issubdtype(np.asarray(y).dtype, np.integer)):
        xmin, xmax = int(X.min()), int(X.max())
        ymin, ymax = int(np.min(y)), int(np.max(y))
        lo, hi = min(xmin, ymin), max(xmax, ymax)
        if lo >= 0 and hi < 1 << 16:
            present = (np.bincount(X.ravel(), minlength=hi + 1) > 0) \
                | (np.bincount(np.asarray(y).ravel(),
                               minlength=hi + 1) > 0)
            unique_vals = np.flatnonzero(present)
            lut = np.cumsum(present).astype(np.int32) - 1
            return lut[X], lut[np.asarray(y)], unique_vals
    unique_vals = np.unique(np.concatenate([np.unique(X), np.unique(y)]))
    X_enc = np.searchsorted(unique_vals, X).astype(np.int32)
    y_enc = np.searchsorted(unique_vals, y).astype(np.int32)
    return X_enc, y_enc, unique_vals


class mRMR(BaseEstimator, TransformerMixin):
    """Minimum-redundancy maximum-relevance feature selection.

    Parameters
    ----------
    n_features_to_select : int
        Number of features to select.
    method : {'MID', 'MIQ'}, default='MID'
        Selection criterion: relevance minus mean redundancy (MID) or
        relevance divided by mean redundancy (MIQ).
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Where the MI matrices are computed: 'auto' takes the GPU when
        there is one ('gpu' is an alias of 'cuda').

    Attributes
    ----------
    relevance_scores_ : ndarray of shape (n_features,)
    redundancy_matrix_ : ndarray of shape (n_features, n_features), or
        None past ``FULL_REDUNDANCY_MAX_P`` features
    top_features_ : ndarray of shape (n_features_to_select,)
    feature_importances_ : ndarray, alias of relevance scores.
    unique_vals_ : ndarray, the union vocabulary of X and y.
    """

    def __init__(self, n_features_to_select: int, method: str = "MID",
                 backend: str = "auto"):
        self.n_features_to_select = n_features_to_select
        self.method = method
        self.backend = backend
        # Validated in __init__ to match the reference contract
        # (mRMR.py:56-64).
        if self.method not in ("MID", "MIQ"):
            raise ValueError("Method must be either 'MID' or 'MIQ'.")
        if self.backend not in ("auto", "cuda", "gpu", "cpu"):
            raise ValueError(
                "Backend must be one of 'auto', 'cuda', 'gpu', or 'cpu'.")
        if self.backend in ("cuda", "gpu"):
            resolve_backend(self.backend, "mRMR")

    @property
    def redundancy_matrix_(self):
        """(p, p) pairwise MI with zero diagonal (None above
        FULL_REDUNDANCY_MAX_P).  A fit keeps it on its device through the
        greedy selection; first access copies it to a host float64
        ndarray and frees the device copy."""
        host = getattr(self, "_redundancy_host", None)
        if host is None and getattr(self, "_redundancy_dev", None) \
                is not None:
            host = self._redundancy_dev.cpu().numpy().astype(np.float64)
            self._redundancy_host = host
            self._redundancy_dev = None
        return host

    @redundancy_matrix_.setter
    def redundancy_matrix_(self, value):
        self._redundancy_host = value
        self._redundancy_dev = None

    def __getstate__(self):
        # pickle the host copy, not the device tensor
        if getattr(self, "_redundancy_dev", None) is not None:
            _ = self.redundancy_matrix_
        return dict(self.__dict__)

    @fit_span
    def fit(self, X: np.ndarray, y: np.ndarray):
        """Select features greedily by the mRMR criterion."""
        X, y = validate_data(self, X, y, dtype=None, y_numeric=True,
                             ensure_2d=True)
        self.n_features_in_ = p = X.shape[1]

        if not (0 < self.n_features_to_select <= self.n_features_in_):
            raise ValueError(
                "n_features_to_select must be a positive integer less "
                "than or equal to the number of features."
            )

        X_enc, y_enc, unique_vals = _encode_union(X, y)
        self.unique_vals_ = unique_vals
        device = default_device(resolve_backend(self.backend, "mRMR"))
        s = int(max(X_enc.max() if X_enc.size else 0, y_enc.max())) + 1
        n = X_enc.shape[0]
        self.redundancy_matrix_ = None  # refit: drop any earlier matrix
        if p > FULL_REDUNDANCY_MAX_P:
            # GWAS scale: relevance vector only; redundancy columns of
            # the (few) selected features stream on demand against the
            # codes staged ONCE for the whole fit
            staged = StagedColumnStats(X_enc, s, device=device)
            relevance = staged.stats_vs(y_enc, s, "mi")

            def redundancy_column(j):
                col = staged.column(j, "mi")
                col[j] = 0.0  # self-entry I(X_j;X_j)=H(X_j): match the
                return col    # full-matrix contract (zero diagonal)
        else:
            # the (p, p) matrix stays on the device (zero diagonal by
            # construction); the greedy loop reads the k columns it picks
            xt = stage_codes(X_enc, s, device)
            relevance = tables_stat(
                staged_target_tables(xt, y_enc, s, s), n,
                "mi").cpu().numpy().astype(np.float64)
            R = staged_stat_matrix(xt, n, s, "mi")
            self._redundancy_dev = R

            def redundancy_column(j):
                return matrix_column(R, j, p)

        self.relevance_scores_ = relevance
        self.top_features_ = self._greedy_select(relevance,
                                                 redundancy_column)
        self.feature_importances_ = self.relevance_scores_
        return self

    def _greedy_select(self, relevance, redundancy_column):
        """Greedy mRMR rounds over masked full-length vectors.

        Selection contract matches the reference bit-for-bit
        (``mRMR.py:102-131``): MID/MIQ criterion, ``np.isclose``
        (atol=1e-12) tie groups resolved by lowest accumulated
        redundancy.  Only redundancy COLUMNS of chosen features are ever
        read, so the caller may stream them (no (p, p) matrix).
        """
        k = self.n_features_to_select
        taken = np.zeros(self.n_features_in_, dtype=bool)
        chosen = np.empty(k, dtype=np.int32)
        chosen[0] = np.argmax(relevance)
        taken[chosen[0]] = True
        red_sum = np.array(redundancy_column(chosen[0]), dtype=np.float64)

        for rnd in range(1, k):
            mean_red = red_sum / rnd
            if self.method == "MID":
                crit = relevance - mean_red
            else:  # MIQ
                crit = relevance / (mean_red + 1e-9)
            open_ = ~taken
            best = np.max(crit[open_])
            ties = np.flatnonzero(open_
                                  & np.isclose(crit, best, atol=1e-12))
            pick = (ties[np.argmin(red_sum[ties])]
                    if ties.size > 1 else ties[0])
            chosen[rnd] = pick
            taken[pick] = True
            red_sum += redundancy_column(pick)

        return chosen

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Reduce X to the selected features."""
        check_is_fitted(self)
        X = validate_data(self, X, reset=False, dtype=None)
        return X[:, self.top_features_]

    def fit_transform(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Fit to data, then transform it."""
        self.fit(X, y)
        return self.transform(X)
