"""Shared sklearn-API plumbing for the Relief-family estimators.

Counterpart of ``fastselect_tpu/models/_relief_base.py``: subclasses
define ``_algo_name`` and ``_score``.  A fit validates X on the host,
uploads it to the compute device once as float32, analyses its columns
there, and scores that same tensor, or the state codes the analysis made
of it when every column is discrete.  Small non-negative integer X
(genotypes) skips the float copy: it is uploaded once as int8 codes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.backend import default_device, resolve_backend, _VALID_BACKENDS
from ..utils.preprocessing import (MAX_STATES, FeatureAnalysis,
                                   analyze_features)
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
        int_x = (isinstance(X, np.ndarray) and X.ndim == 2 and X.size > 0
                 and np.issubdtype(X.dtype, np.integer))
        X, y = validate_data(
            self, X, y, y_numeric=True,
            # integer input (genotypes) keeps its integer dtype: a float
            # cast would copy it only to be encoded back to int8 (any
            # injective per-column coding gives the same Hamming match
            # counts, so small non-negative values ARE valid codes)
            dtype="numeric" if int_x else self._validate_dtype,
            ensure_2d=True)
        self.n_features_in_ = X.shape[1]
        n_select = self._validate_parameters(X.shape[0], self.n_features_in_)
        self.effective_backend_ = self._resolve_backend()

        analysis = self._int_fast_analysis(X) if int_x else None
        if analysis is None:
            analysis = self._analyze(X)
        self.is_discrete_ = analysis.is_discrete.cpu().numpy()
        scores = self._score(analysis.x_dev, y, analysis, n_select)
        if scores is None:  # the algorithm's early exit set the attributes
            return self
        self.feature_importances_ = scores
        self.top_features_ = np.argsort(scores)[::-1][:n_select]
        return self

    def _score(self, X, y, analysis, n_select):  # pragma: no cover
        raise NotImplementedError

    def _int_fast_analysis(self, X) -> FeatureAnalysis | None:
        """Encode-free analysis of integer X with values in
        0..min(discrete_limit, 127) - 1 (the GWAS genotype case), else
        None.  Every column of such X is discrete by construction
        (cardinality <= max + 1 <= discrete_limit), and the raw values
        serve as state codes: they go to the device once as int8 (1 byte
        a value instead of 4), with n_states = max + 1 and recip all ones.
        One-byte X is copied as it is and range-checked on the device;
        wider X is checked on the host and cast to int8 before the copy.
        """
        dev = self._device()
        if X.dtype.itemsize == 1:
            codes = torch.as_tensor(X).to(dev)
            mn, mx = (int(v) for v in torch.aminmax(codes))
        else:
            codes = None
            mn, mx = int(X.min()), int(X.max())
        if mn < 0 or mx + 1 > min(int(self.discrete_limit), MAX_STATES):
            return None
        if codes is None:
            codes = torch.as_tensor(X.astype(np.int8)).to(dev)
        p = X.shape[1]
        return FeatureAnalysis(
            torch.ones(p, dtype=torch.bool, device=dev),
            torch.ones(p, dtype=torch.float32, device=dev),
            codes=codes.to(torch.int8), n_states=mx + 1)

    def _analyze(self, X) -> FeatureAnalysis:
        """Per-feature discreteness, ranges and (all-discrete X) state
        codes, in float32 on the compute device; X is uploaded here, once."""
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
