"""scikit-learn's estimator base where it is installed, a minimal one where not.

The port's estimators are scikit-learn estimators.  scikit-learn is an
optional dependency, so that a fit also runs on a GPU host without it.
There the stand-ins below give the estimator the parts of the contract it
uses: ``get_params``/``set_params``, ``clone``, the not-fitted check,
input validation that rejects NaN and infinity, checks shapes and records
``n_features_in_``, ``SelectorMixin.get_support``, CFS's
``KBinsDiscretizer`` for the 'uniform' and 'quantile' strategies, and
MDR's ``ClassifierMixin``, ``StratifiedKFold`` (scikit-learn 1.9's folds),
``check_array`` and ``unique_labels``.
"""

from __future__ import annotations

import copy
import inspect
import warnings

import numpy as np
import torch


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


def _total(X):
    """The sum of X's values: on torch's threads for a writeable,
    C-contiguous float32 or float64 array (no copy, no temporary), else
    numpy's."""
    if (X.dtype in (np.float32, np.float64) and X.dtype.isnative
            and X.flags.writeable and X.flags.c_contiguous):
        return torch.from_numpy(X).sum().item()
    return np.sum(X)


def _check_finite(X):
    """Raise on NaN or infinity.  As scikit-learn does, the sum comes
    first: it is finite where every value is and takes one pass with no
    temporary (for a wide X, the elementwise check's allocation cost more
    than the pass, and varied most from process to process); only a sum
    that is not finite, a NaN, an infinity or an overflow, takes the
    elementwise check."""
    if np.isfinite(_total(X)):
        return
    if not np.isfinite(X).all():
        raise ValueError("Input X contains NaN." if np.isnan(X).any()
                         else "Input X contains infinity.")


def _check_array(X, dtype, ensure_2d, ensure_all_finite=True):
    """``dtype="numeric"`` keeps a numeric dtype and casts object input
    to float64; a list of dtypes keeps X's dtype when it is listed,
    else casts to the first.  X becomes an array first and is then cast
    as numpy casts (-1 wraps to 255 and 2.7 truncates to 2 in uint8, as
    scikit-learn 1.9 casts them); NaN and infinity raise before the cast
    unless ``ensure_all_finite`` is False."""
    X = np.asarray(X)
    if isinstance(dtype, str) and dtype == "numeric":
        dtype = np.float64 if X.dtype.kind == "O" else X.dtype
    elif isinstance(dtype, (list, tuple)):
        dtype = X.dtype if X.dtype in dtype else dtype[0]
    if ensure_2d and X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D array "
                         "instead.")
    was_float = X.dtype.kind in "fc"
    if was_float and ensure_all_finite:
        _check_finite(X)
    if dtype is not None:
        X = X.astype(dtype, copy=False)
    if not was_float and X.dtype.kind in "fc" and ensure_all_finite:
        _check_finite(X)
    return X


def _check_array_standin(X, *, dtype="numeric", ensure_2d=True):
    """``sklearn.utils.validation.check_array`` for the arguments the port
    passes: at least one sample and one feature."""
    X = _check_array(X, dtype, ensure_2d)
    for axis, what in ((0, "sample"), (1, "feature")):
        if X.ndim > axis and X.shape[axis] < 1:
            raise ValueError(f"Found array with 0 {what}(s) (shape="
                             f"{X.shape}) while a minimum of 1 is required.")
    return X


def _unique_labels(*ys):
    """``sklearn.utils.multiclass.unique_labels`` for binary and multiclass
    targets: the sorted union of their labels."""
    labels = set()
    for y in ys:
        y = np.asarray(y)
        if y.dtype.kind == "f" and np.any(y != y.astype(np.int64)):
            raise ValueError(f"Unknown label type: {ys!r}")
        labels.update(np.unique(y).tolist() if y.dtype.kind == "O"
                      else np.unique(y))
    if len({isinstance(v, str) for v in labels}) > 1:
        raise ValueError("Mix of label input types (string and number)")
    return np.asarray(sorted(labels))


class _ClassifierMixin:
    """``sklearn.base.ClassifierMixin``: ``score`` is the (weighted)
    accuracy of ``predict``."""

    _estimator_type = "classifier"

    def score(self, X, y, sample_weight=None):
        hit = np.asarray(y).ravel() == np.asarray(self.predict(X)).ravel()
        return float(np.average(hit, weights=sample_weight))


class _StratifiedKFold:
    """``sklearn.model_selection.StratifiedKFold`` as scikit-learn 1.9
    assigns its folds (``_make_test_folds``): labels encoded in the order
    of their first appearance, a class's share of each fold dealt round
    robin over the sorted labels, and each class's fold numbers shuffled
    in class order by one ``RandomState``.  Same errors and warning."""

    def __init__(self, n_splits=5, *, shuffle=False, random_state=None):
        if not isinstance(n_splits, (int, np.integer)):
            raise ValueError("The number of folds must be of Integral type. "
                             f"{n_splits} of type {type(n_splits)} was "
                             "passed.")
        if n_splits <= 1:
            raise ValueError(
                "k-fold cross-validation requires at least one train/test "
                "split by setting n_splits=2 or more, got "
                f"n_splits={n_splits}.")
        if not isinstance(shuffle, bool):
            raise TypeError(f"shuffle must be True or False; got {shuffle}")
        if not shuffle and random_state is not None:
            raise ValueError(
                "Setting a random_state has no effect since shuffle is "
                "False. You should leave random_state to its default "
                "(None), or set shuffle=True.")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def _rng(self):
        if isinstance(self.random_state, np.random.RandomState):
            return self.random_state
        if self.random_state is None:
            return np.random.mtrand._rand
        return np.random.RandomState(self.random_state)

    def _make_test_folds(self, y):
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError("Supported target types are: ('binary', "
                             "'multiclass'). Got a target of more than one "
                             "column instead.")
        if y.dtype.kind == "f" and np.any(y != y.astype(np.int64)):
            raise ValueError("Supported target types are: ('binary', "
                             "'multiclass'). Got 'continuous' instead.")
        rng = self._rng()
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv.reshape(-1)]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater "
                             "than the number of members in each class.")
        if self.n_splits > y_counts.min():
            warnings.warn(
                f"The least populated class in y has only {y_counts.min()} "
                f"members, which is less than n_splits={self.n_splits}.",
                UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray([
            np.bincount(y_order[i::self.n_splits], minlength=n_classes)
            for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(
                allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        n_samples = len(X)
        if len(y) != n_samples:
            raise ValueError("Found input variables with inconsistent "
                             f"numbers of samples: [{n_samples}, {len(y)}]")
        if self.n_splits > n_samples:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                "greater than the number of samples: "
                f"n_samples={n_samples}.")
        test_folds = self._make_test_folds(y)
        indices = np.arange(n_samples)
        for i in range(self.n_splits):
            test = test_folds == i
            yield indices[~test], indices[test]


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
    from sklearn.base import (BaseEstimator, ClassifierMixin,
                              TransformerMixin, clone)
    from sklearn.exceptions import NotFittedError
    from sklearn.feature_selection import SelectorMixin
    from sklearn.model_selection import StratifiedKFold
    from sklearn.preprocessing import KBinsDiscretizer
    from sklearn.utils.multiclass import unique_labels
    from sklearn.utils.validation import (assert_all_finite, check_array,
                                          check_is_fitted, check_X_y,
                                          validate_data)
    HAVE_SKLEARN = True
except ImportError:
    clone = _clone
    KBinsDiscretizer = _KBinsDiscretizer
    ClassifierMixin = _ClassifierMixin
    StratifiedKFold = _StratifiedKFold
    check_array = _check_array_standin
    unique_labels = _unique_labels
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
                      dtype=np.float64, ensure_2d=True, y_numeric=False,
                      ensure_all_finite=True):
        """Array conversion and checks of ``sklearn``'s ``validate_data``
        for the arguments the estimators pass."""
        X = _check_array(X, dtype, ensure_2d, ensure_all_finite)
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


def check_finite(X) -> None:
    """Raise ``ValueError("Input X contains NaN.")`` (or infinity) as
    ``validate_data`` does, for X validated with ``ensure_all_finite``
    False."""
    if HAVE_SKLEARN:
        assert_all_finite(X, input_name="X")
    else:
        _check_finite(X)


__all__ = ["HAVE_SKLEARN", "BaseEstimator", "ClassifierMixin",
           "KBinsDiscretizer", "NotFittedError", "SelectorMixin",
           "StratifiedKFold", "TransformerMixin", "check_X_y",
           "check_array", "check_finite", "check_is_fitted", "clone",
           "unique_labels", "validate_data"]
