"""ReliefF estimator (reference ``ReliefF.py:239-452``).

Counterpart of ``fastselect_tpu/models/relieff.py``: the multi-class,
class-prior-weighted CPU semantics of the reference
(``ReliefF.py:137-220``).  The k nearest hits contribute -diff/h_found and
the k nearest misses of each other class c contribute
+ P(c)/(1 - P(y_i)) * diff / k.
"""

from __future__ import annotations

import warnings

import numpy as np

from ._relief_base import BaseReliefSelector
from ..ops.relief import relief_scores


class ReliefF(BaseReliefSelector):
    """GPU-accelerated feature selection using the ReliefF algorithm.

    Parameters
    ----------
    n_features_to_select : int or float, default=0.2
        Number (int) or fraction (float in (0, 1]) of top features to keep.
    discrete_limit : int, default=10
        Features with at most this many unique values are discrete.
    n_neighbors : int, default=3
        Number of nearest hits/misses used per focal sample.
    backend : {'auto', 'cuda', 'gpu', 'cpu'}, default='auto'
        Compute backend. 'auto' uses a CUDA GPU when present, else the
        CPU; 'gpu' is an alias of 'cuda'. Forcing 'cuda' without a GPU
        raises RuntimeError.
    verbose : bool, default=False
        Print progress messages during fit.
    n_jobs : int, default=-1
        Accepted for API compatibility with the reference.
    transfer_dtype : {None, 'float32', 'float16', 'bfloat16'}, default=None
        Staging dtype of the host-to-device copy of a host X of at least
        2**22 values on CUDA fits (smaller X, tensors and CPU fits take
        one float32 copy).  'float16'/'bfloat16' halve the bytes copied,
        at a ~1e-3 relative cost in score precision.  The default None
        stages exact float32: JAX's auto rule (float16 for float X of at
        least 2**24 values with p >= 4n) did not make such a fit faster
        on an H100, where the host's float16 cast outweighs the halved
        copy.  The dtype actually used is recorded in ``transfer_dtype_``.

    Attributes
    ----------
    n_features_in_ : int
    classes_ : ndarray
    feature_importances_ : ndarray of shape (n_features,)
    top_features_ : ndarray of shape (n_features_to_select,)
    is_discrete_ : ndarray of shape (n_features,)
    effective_backend_ : str
        'cuda' or 'cpu': where the scores were computed.
    transfer_dtype_ : str
        The staging dtype a CUDA fit of a host X of at least 2**22 values
        used (set by such a fit only).
    """

    _algo_name = "ReliefF"
    _validate_dtype = np.float64

    def __init__(
        self,
        n_features_to_select: int | float = 0.2,
        discrete_limit: int = 10,
        n_neighbors: int = 3,
        backend: str = "auto",
        verbose: bool = False,
        n_jobs: int = -1,
        transfer_dtype: str | None = None,
    ):
        self.n_features_to_select = n_features_to_select
        self.discrete_limit = discrete_limit
        self.n_neighbors = n_neighbors
        self.backend = backend
        self.verbose = verbose
        self.n_jobs = n_jobs
        self.transfer_dtype = transfer_dtype

    def _validate_parameters(self, n_samples, n_features):
        n_select = super()._validate_parameters(n_samples, n_features)
        if not (isinstance(self.n_neighbors, (int, np.integer))
                and 0 < self.n_neighbors < n_samples):
            raise ValueError(
                f"n_neighbors ({self.n_neighbors}) must be an integer "
                f"between 1 and n_samples - 1 ({n_samples - 1})."
            )
        return n_select

    def _score(self, X, y, analysis, n_select):
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        if len(self.classes_) < 2:
            # Single-class early-out (reference ReliefF.py:352-356).
            self.feature_importances_ = np.zeros(
                self.n_features_in_, dtype=np.float32)
            self.top_features_ = np.arange(n_select)
            self.effective_backend_ = (
                "cpu" if self.backend in ("auto", "cpu") else "cuda")
            return None

        min_class_size = np.min(np.bincount(y_enc))
        if self.n_neighbors >= min_class_size:
            warnings.warn(
                f"n_neighbors ({self.n_neighbors}) is greater than or equal "
                f"to the smallest class size ({min_class_size}).",
                UserWarning,
            )

        class_probs = (np.bincount(y_enc) / len(y)).astype(np.float32)
        self._log_running()
        return relief_scores(
            X, y_enc, analysis.recip, analysis.is_discrete,
            algo="relieff", n_neighbors=self.n_neighbors,
            class_probs=class_probs, device=self._device(),
            codes=analysis.codes, n_states=analysis.n_states,
            from_host=self._device_ is None)
