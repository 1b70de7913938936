"""Shared sklearn-API plumbing for the Relief-family estimators.

Counterpart of ``fastselect_tpu/models/_relief_base.py``: subclasses
define ``_algo_name`` and ``_score``.  A fit validates X on the host,
uploads it to the compute device once as float32, analyses its columns
there, and scores that same tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.backend import default_device, resolve_backend, _VALID_BACKENDS
from ..utils.preprocessing import FeatureAnalysis, analyze_features
from ..utils.sklearn_compat import (BaseEstimator, TransformerMixin,
                                    check_is_fitted, validate_data)
from ..utils.validation import check_min_samples, resolve_n_features_to_select


class BaseReliefSelector(TransformerMixin, BaseEstimator):
    """Common fit/transform skeleton; not part of the public API."""

    _algo_name = "Relief"
    _validate_dtype = np.float64

    def _validate_parameters(self, n_samples, n_features):
        if self.backend not in _VALID_BACKENDS:
            raise ValueError(
                "backend must be one of 'auto', 'cuda', 'gpu', or 'cpu'")
        check_min_samples(n_samples, self._algo_name)
        return resolve_n_features_to_select(
            self.n_features_to_select, n_features)

    def _resolve_backend(self):
        return resolve_backend(self.backend, self._algo_name)

    def _device(self) -> torch.device:
        return default_device(self.effective_backend_)

    def _log_running(self, star_name: str | None = None):
        if getattr(self, "verbose", False):
            name = star_name or self._algo_name
            print(f"Running {name} on the "
                  f"{self.effective_backend_.upper()} now...")

    def fit(self, X, y):
        """Score all features and select the top ones.

        Parameters
        ----------
        X : array-like of shape (n_samples, n_features)
            Training samples. NaN values are rejected.
        y : array-like of shape (n_samples,)
            Numeric class labels.

        Returns
        -------
        self : object
        """
        X, y = validate_data(self, X, y, y_numeric=True,
                             dtype=self._validate_dtype, ensure_2d=True)
        self.n_features_in_ = X.shape[1]
        n_select = self._validate_parameters(X.shape[0], self.n_features_in_)
        self.effective_backend_ = self._resolve_backend()

        analysis = self._analyze(X)
        self.is_discrete_ = analysis.is_discrete.cpu().numpy()
        scores = self._score(analysis.x_dev, y, analysis, n_select)
        self.feature_importances_ = scores
        self.top_features_ = np.argsort(scores)[::-1][:n_select]
        return self

    def _score(self, X, y, analysis, n_select):  # pragma: no cover
        raise NotImplementedError

    def _analyze(self, X) -> FeatureAnalysis:
        """Per-feature discreteness and ranges of X, in float32 on the
        compute device; X is uploaded here, once."""
        x_dev = torch.tensor(X, dtype=torch.float32, device=self._device())
        return analyze_features(x_dev, self.discrete_limit)

    def transform(self, X):
        """Reduce X to the selected top features."""
        check_is_fitted(self)
        X = validate_data(self, X, reset=False,
                          dtype=[np.float64, np.float32])
        return X[:, self.top_features_]

    def fit_transform(self, X, y):
        """Fit to data, then transform it."""
        self.fit(X, y)
        return self.transform(X)
