"""scikit-learn's estimator base where it is installed, a minimal one where not.

The port's estimators are scikit-learn estimators.  scikit-learn is an
optional dependency, so that a fit also runs on a GPU host without it.
There the stand-ins below give the estimator the parts of the contract it
uses: ``get_params``/``set_params``, the not-fitted check, and input
validation that rejects NaN and infinity, checks shapes and records
``n_features_in_``.
"""

from __future__ import annotations

import inspect

import numpy as np

try:
    from sklearn.base import BaseEstimator, TransformerMixin
    from sklearn.exceptions import NotFittedError
    from sklearn.utils.validation import check_is_fitted, validate_data
    HAVE_SKLEARN = True
except ImportError:
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

    def validate_data(estimator, X, y=None, *, reset=True,
                      dtype=np.float64, ensure_2d=True, y_numeric=False):
        """Array conversion and checks of ``sklearn``'s ``validate_data``
        for the arguments the estimators pass."""
        if isinstance(dtype, (list, tuple)):
            X = np.asarray(X)
            dtype = X.dtype if X.dtype in dtype else dtype[0]
        X = np.asarray(X, dtype=dtype)
        if ensure_2d and X.ndim != 2:
            raise ValueError(f"Expected 2D array, got {X.ndim}D array "
                             "instead.")
        if not np.isfinite(X).all():
            raise ValueError("Input X contains NaN." if np.isnan(X).any()
                             else "Input X contains infinity.")
        if reset:
            estimator.n_features_in_ = X.shape[1]
        elif X.shape[1] != estimator.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features, but "
                f"{type(estimator).__name__} is expecting "
                f"{estimator.n_features_in_} features as input.")
        if y is None:
            return X
        y = np.asarray(y)
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError("X and y have inconsistent numbers of samples "
                             f"or y is not 1-D: {X.shape}, {y.shape}")
        if y_numeric and y.dtype.kind == "O":
            y = y.astype(np.float64)
        return X, y


__all__ = ["HAVE_SKLEARN", "BaseEstimator", "TransformerMixin",
           "NotFittedError", "check_is_fitted", "validate_data"]
