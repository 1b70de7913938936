"""scikit-learn's estimator base where it is installed, a minimal one where not.

The port's estimators are scikit-learn estimators.  scikit-learn is an
optional dependency, so that a fit also runs on a GPU host without it.
There the stand-ins below give the estimator the parts of the contract it
uses: ``get_params``/``set_params``, ``clone``, the not-fitted check,
input validation that rejects NaN and infinity, checks shapes and records
``n_features_in_``, ``SelectorMixin.get_support``, and CFS's
``KBinsDiscretizer`` for the 'uniform' and 'quantile' strategies.
"""

from __future__ import annotations

import copy
import inspect
import warnings

import numpy as np


def _clone(estimator, *, safe=True):
    """``sklearn.base.clone`` for the estimators of this package: a new
    unfitted ``type(estimator)(**estimator.get_params(deep=False))``, each
    parameter cloned in turn (a nested estimator is cloned, any other value
    deep-copied).  An object's own ``__sklearn_clone__`` is honoured."""
    if hasattr(estimator, "__sklearn_clone__") and not inspect.isclass(
            estimator):
        return estimator.__sklearn_clone__()
    if type(estimator) in (list, tuple, set, frozenset):
        return type(estimator)(_clone(e, safe=safe) for e in estimator)
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        if not safe:
            return copy.deepcopy(estimator)
        raise TypeError(f"Cannot clone object {estimator!r}: it does not "
                        "implement a 'get_params' method.")
    params = {name: _clone(value, safe=False)
              for name, value in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


def _check_array(X, dtype, ensure_2d):
    """``dtype="numeric"`` keeps a numeric dtype and casts object input
    to float64; a list of dtypes keeps X's dtype when it is listed,
    else casts to the first."""
    if isinstance(dtype, str) and dtype == "numeric":
        X = np.asarray(X)
        dtype = np.float64 if X.dtype.kind == "O" else X.dtype
    elif isinstance(dtype, (list, tuple)):
        X = np.asarray(X)
        dtype = X.dtype if X.dtype in dtype else dtype[0]
    X = np.asarray(X, dtype=dtype)
    if ensure_2d and X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D array "
                         "instead.")
    if X.dtype.kind in "fc" and not np.isfinite(X).all():
        raise ValueError("Input X contains NaN." if np.isnan(X).any()
                         else "Input X contains infinity.")
    return X


class _KBinsDiscretizer:
    """``sklearn.preprocessing.KBinsDiscretizer(encode="ordinal",
    subsample=None)`` as scikit-learn 1.9 fits and applies it, for the
    'uniform' and 'quantile' strategies (quantiles by numpy's
    'averaged_inverted_cdf', that version's ``quantile_method``).  A
    constant column gets the edges [-inf, inf] and one bin; quantile edges
    closer than 1e-8 are removed.  'kmeans' needs scikit-learn's KMeans."""

    def __init__(self, n_bins=5, *, encode="ordinal", strategy="quantile",
                 subsample=None):
        self.n_bins = n_bins
        self.encode = encode
        self.strategy = strategy
        self.subsample = subsample

    def fit(self, X, y=None):
        if self.encode != "ordinal" or self.subsample is not None:
            raise ValueError("the KBinsDiscretizer stand-in takes "
                             "encode='ordinal' and subsample=None only")
        if self.strategy == "kmeans":
            raise ImportError(
                "KBinsDiscretizer(strategy='kmeans') runs scikit-learn's "
                "KMeans, and scikit-learn is not installed: install it, or "
                "use strategy='uniform' or 'quantile'.")
        if self.strategy not in ("uniform", "quantile"):
            raise ValueError("strategy must be 'uniform', 'quantile' or "
                             f"'kmeans', got {self.strategy!r}")
        if int(self.n_bins) != self.n_bins or self.n_bins < 2:
            raise ValueError("n_bins must be an int of at least 2")
        X = _check_array(X, "numeric", True)
        n_bins = np.full(X.shape[1], int(self.n_bins), dtype=int)
        edges = np.zeros(X.shape[1], dtype=object)
        for jj in range(X.shape[1]):
            column = X[:, jj]
            col_min, col_max = column.min(), column.max()
            if col_min == col_max:
                warnings.warn(f"Feature {jj} is constant and will be "
                              "replaced with 0.")
                n_bins[jj] = 1
                edges[jj] = np.array([-np.inf, np.inf])
                continue
            if self.strategy == "uniform":
                edges[jj] = np.linspace(col_min, col_max, n_bins[jj] + 1)
            else:
                levels = np.linspace(0, 100, n_bins[jj] + 1)
                edges[jj] = np.asarray(np.percentile(
                    column, levels, method="averaged_inverted_cdf"),
                    dtype=np.float64)
                mask = np.ediff1d(edges[jj], to_begin=np.inf) > 1e-8
                edges[jj] = edges[jj][mask]
                if len(edges[jj]) - 1 != n_bins[jj]:
                    warnings.warn(
                        "Bins whose width are too small (i.e., <= 1e-8) in "
                        f"feature {jj} are removed. Consider decreasing the "
                        "number of bins.")
                    n_bins[jj] = len(edges[jj]) - 1
        self.bin_edges_ = edges
        self.n_bins_ = n_bins
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        X = np.asarray(X)
        Xt = np.array(X, dtype=X.dtype if X.dtype in (np.float32, np.float64)
                      else np.float64)
        if Xt.ndim != 2 or Xt.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {Xt.shape[-1]} features, but "
                             "KBinsDiscretizer is expecting "
                             f"{self.n_features_in_} features as input.")
        for jj in range(Xt.shape[1]):
            Xt[:, jj] = np.searchsorted(self.bin_edges_[jj][1:-1],
                                        Xt[:, jj], side="right")
        return Xt

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


try:
    from sklearn.base import BaseEstimator, TransformerMixin, clone
    from sklearn.exceptions import NotFittedError
    from sklearn.feature_selection import SelectorMixin
    from sklearn.preprocessing import KBinsDiscretizer
    from sklearn.utils.validation import (check_is_fitted, check_X_y,
                                          validate_data)
    HAVE_SKLEARN = True
except ImportError:
    clone = _clone
    KBinsDiscretizer = _KBinsDiscretizer
    HAVE_SKLEARN = False

    class NotFittedError(ValueError, AttributeError):
        """Raised when an estimator is used before it is fitted."""

    class BaseEstimator:
        """Parameter handling of ``sklearn.base.BaseEstimator``."""

        @classmethod
        def _get_param_names(cls):
            sig = inspect.signature(cls.__init__)
            return sorted(name for name, prm in sig.parameters.items()
                          if name != "self" and prm.kind == prm.POSITIONAL_OR_KEYWORD)

        def get_params(self, deep=True):
            return {name: getattr(self, name)
                    for name in self._get_param_names()}

        def set_params(self, **params):
            valid = self._get_param_names()
            for name, value in params.items():
                if name not in valid:
                    raise ValueError(f"Invalid parameter {name!r} for "
                                     f"estimator {type(self).__name__}.")
                setattr(self, name, value)
            return self

    class TransformerMixin:
        """Stand-in for ``sklearn.base.TransformerMixin``: the estimators
        define ``fit_transform`` themselves."""

    def check_is_fitted(estimator):
        if not any(k.endswith("_") and not k.startswith("__")
                   for k in vars(estimator)):
            raise NotFittedError(
                f"This {type(estimator).__name__} instance is not fitted "
                "yet. Call 'fit' with appropriate arguments before using "
                "this estimator.")

    def _check_y(X, y, y_numeric):
        y = np.asarray(y)
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError("X and y have inconsistent numbers of samples "
                             f"or y is not 1-D: {X.shape}, {y.shape}")
        if y_numeric and y.dtype.kind == "O":
            y = y.astype(np.float64)
        return y

    class SelectorMixin(TransformerMixin):
        """``sklearn.feature_selection.SelectorMixin``'s ``get_support``
        and ``fit_transform`` over the estimator's
        ``_get_support_mask``."""

        def get_support(self, indices=False):
            mask = self._get_support_mask()
            return np.flatnonzero(mask) if indices else mask

        def fit_transform(self, X, y=None, **fit_params):
            return self.fit(X, y, **fit_params).transform(X)

    def check_X_y(X, y, *, dtype="numeric", ensure_2d=True,
                  y_numeric=False, ensure_min_samples=1):
        """``sklearn``'s ``check_X_y`` for the arguments the port passes."""
        X = _check_array(X, dtype, ensure_2d)
        if X.shape[0] < ensure_min_samples:
            raise ValueError(
                f"Found array with {X.shape[0]} sample(s) (shape={X.shape}) "
                f"while a minimum of {ensure_min_samples} is required.")
        return X, _check_y(X, y, y_numeric)

    def validate_data(estimator, X, y=None, *, reset=True,
                      dtype=np.float64, ensure_2d=True, y_numeric=False):
        """Array conversion and checks of ``sklearn``'s ``validate_data``
        for the arguments the estimators pass."""
        X = _check_array(X, dtype, ensure_2d)
        if reset:
            estimator.n_features_in_ = X.shape[1]
        elif X.shape[1] != estimator.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features, but "
                f"{type(estimator).__name__} is expecting "
                f"{estimator.n_features_in_} features as input.")
        if y is None:
            return X
        return X, _check_y(X, y, y_numeric)


__all__ = ["HAVE_SKLEARN", "BaseEstimator", "KBinsDiscretizer",
           "NotFittedError", "SelectorMixin", "TransformerMixin",
           "check_X_y", "check_is_fitted", "clone", "validate_data"]
